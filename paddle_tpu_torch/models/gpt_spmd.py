"""GPT training step on one device — port of ``paddle_tpu/models/gpt_spmd.py``.

The reference is a pure loss over a params pytree, differentiated with
``jax.value_and_grad`` and jitted over a dp x pp x mp mesh. This port is
its one-device case (dp = pp = mp = 1), in eager PyTorch:

- :func:`init_params` keeps the pytree (``tok_emb``, ``pos_emb``,
  ``stages``, ``lnf_g``, ``lnf_b``) with the per-layer leaves stacked on a
  leading ``[L]`` dim — the reference's ``[pp, L/pp]`` with ``pp = 1``
  dropped. Its values come from a ``torch.Generator``; weights carried
  across from the reference go through ``models/convert.py``.
- :func:`loss_fn` is ``_loss_fn_inner``: embedding gather plus positions,
  the microbatch loop (``_pipeline`` at pp = 1), the final LayerNorm and
  the chunked, rematerialized next-token CE over the tied embedding.
- :func:`_block` is the dense, mp = 1 decoder block. Attention takes the
  flash custom op (``ops/flash_attention.py``: the hand-written forward
  and backward kernels on a CUDA tensor) when ``use_flash_attention`` is set on
  CUDA and the kernels take the call (``kernel_takes``: bf16 or fp16 at
  head_dim 32, 64, 80, 96 or 128, fp32 at 64 or 128), or ``force_flash`` on the
  CPU, and plain causal softmax attention otherwise. With ``fused_mlp`` (on
  CUDA; ``force_fused_mlp`` on the CPU, where the plain versions run) LN1 is
  the fused LayerNorm op and the MLP half
  :func:`_block_mlp_fused`: the
  residual add and LN2 in one op, fc1's bias and GELU in another
  (``ops/fused_mlp.py``, the hand-written LN and GELU kernels, forward and
  backward).
- ``config.recompute`` maps onto non-reentrant ``torch.utils.checkpoint``
  per layer with a selective policy that keeps what the reference's
  ``checkpoint_dots_with_no_batch_dims`` keeps (the outputs of the weight
  GEMMs, ``aten.mm``) and, with ``remat_save_attn``, the flash op's
  ``out`` and ``lse`` — so the backward recomputes only LayerNorms,
  biases, GELU and reshapes, and never runs the flash forward again. With
  ``fused_mlp`` and ``remat_save_ln`` it keeps the fused LN ops' outputs
  too (y, s, mean and rstd: what the reference's ``"ln_out"`` names save).
- :func:`build_spmd_train_step` returns ``(step, params, mom, (ids,
  labels))`` like the reference; ``step`` does momentum SGD and updates
  ``params`` and ``mom`` in place (the reference donates them).

Everything the reference shards (dp / pp / mp > 1, ZeRO, quantized
gradient sync), MoE, and ``remat_save_ln`` without ``fused_mlp`` raise
``NotImplementedError`` naming the slice that ports it.
"""
from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..observability import default_registry
from ..ops import fused_mlp as _fm
from ..ops.flash_attention import flash_attention, kernel_takes
from .gpt import GPTConfig

STAGE_KEYS = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_g",
              "ln2_b", "w1", "b1", "w2", "b2")


def param_shapes(config: GPTConfig) -> dict:
    """The params pytree's leaf shapes (stacked ``[L, ...]`` stages)."""
    L, h, f = config.num_layers, config.hidden_size, config.ffn_size
    stages = {"ln1_g": (L, h), "ln1_b": (L, h), "wqkv": (L, h, 3 * h),
              "bqkv": (L, 3 * h), "wo": (L, h, h), "bo": (L, h),
              "ln2_g": (L, h), "ln2_b": (L, h), "w1": (L, h, f),
              "b1": (L, f), "w2": (L, f, h), "b2": (L, h)}
    return {"tok_emb": (config.vocab_size, h),
            "pos_emb": (config.max_seq_len, h), "stages": stages,
            "lnf_g": (h,), "lnf_b": (h,)}


def leaves(tree, prefix=""):
    """``(path, leaf)`` pairs of a params-shaped dict, in a fixed order
    (``stages/wqkv`` for nested keys)."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from leaves(val, path + "/")
        else:
            yield path, val


def unflatten(pairs) -> dict:
    """The params-shaped dict of ``(path, leaf)`` pairs."""
    out: dict = {}
    for path, val in pairs:
        *parents, last = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return out


def _check_train_config(config: GPTConfig, mesh=None, zero_stage=0,
                        comm_quant=None) -> None:
    shape = dict(getattr(mesh, "shape", mesh) or {})
    for axis, n in shape.items():
        if n != 1:
            raise NotImplementedError(
                f"{axis}={n} > 1: sharded training (dp / pp / mp / ep "
                "meshes) is the multi-GPU port slice")
    for flag, value, later in (
            ("zero_stage", zero_stage, "the multi-GPU slice (ZeRO)"),
            ("comm_quant", comm_quant,
             "the multi-GPU slice (quantized gradient sync)"),
            ("moe_experts", config.moe_experts,
             "MoE training, a later slice: the einsum block and ep"),
            # the unfused LN is many aten ops: no op-level policy can name
            # its output, as the reference's "ln_out" tag does
            ("remat_save_ln", config.recompute and config.remat_save_ln
             and not config.fused_mlp,
             "a later slice: without fused_mlp the LayerNorm is no single "
             "op a checkpoint policy can keep")):
        if value:
            raise NotImplementedError(
                f"{flag}={value!r} is not ported yet ({later})")


def init_params(config: GPTConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Fresh params on ``device`` (``None`` = ``cuda:0``): N(0,
    initializer_range) for the embeddings and weight matrices, drawn from
    a ``torch.Generator`` seeded with ``seed`` in the reference's order
    (wqkv, wo, w1, w2, tok_emb, pos_emb); zero biases, unit LN scales."""
    dev = resolve_device(device)
    shapes = param_shapes(config)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    std = config.initializer_range

    def norm(shape):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    st = shapes["stages"]
    drawn = {k: norm(st[k]) for k in ("wqkv", "wo", "w1", "w2")}
    stages = {k: drawn[k] if k in drawn else
              const(st[k], 1.0 if k.endswith("_g") else 0.0)
              for k in STAGE_KEYS}
    tok_emb = norm(shapes["tok_emb"])
    pos_emb = norm(shapes["pos_emb"])
    h = config.hidden_size
    return {"tok_emb": tok_emb, "pos_emb": pos_emb, "stages": stages,
            "lnf_g": const((h,), 1.0), "lnf_b": const((h,), 0.0)}


def sgd_init(params) -> dict:
    """Zero momentum buffers shaped like ``params``."""
    return unflatten((p, torch.zeros_like(t)) for p, t in leaves(params))


# ---------------------------------------------------------------------------
# model math
# ---------------------------------------------------------------------------


def _layer_norm(x, g, b, eps):
    """The reference's gpt_spmd LayerNorm: statistics in x's dtype (the
    eager ``GPTForCausalLM`` takes them in fp32)."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _use_flash(config: GPTConfig, device: torch.device) -> bool:
    """Whether the block may take the flash op: ``use_flash_attention`` on
    CUDA (each call still needs ``kernel_takes``), ``force_flash`` on the
    CPU (where the op runs its plain versions)."""
    if device.type == "cuda":
        return bool(config.use_flash_attention)
    return bool(config.force_flash)


def _fused_mlp_on(config: GPTConfig, device: torch.device) -> bool:
    """Whether the fused LN / GELU ops replace the plain chains in the
    block: ``fused_mlp`` on CUDA, ``force_fused_mlp`` on the CPU (where
    they run their plain versions); never under MoE (the kernels are
    dense-only)."""
    if not config.fused_mlp or config.moe_experts:
        return False
    if device.type == "cuda":
        return True
    return bool(config.force_fused_mlp)


def _block(p, x, config: GPTConfig, flash: bool, fused: bool):
    """One pre-LN decoder block on ``[mb, s, h]``."""
    if "attn" in config.ablate:   # perf attribution: skip the whole branch
        return _block_mlp(p, x, config)
    nh, hd = config.num_heads, config.head_dim
    mb, s, h = x.shape
    if fused:
        y = _fm.fused_layer_norm(x, p["ln1_g"], p["ln1_b"],
                                 eps=config.layer_norm_eps)
    else:
        y = _layer_norm(x, p["ln1_g"], p["ln1_b"], config.layer_norm_eps)
    qkv = y @ p["wqkv"] + p["bqkv"]
    q, k, v = qkv.split(h, dim=-1)
    if flash and (x.device.type == "cpu" or kernel_takes(
            q.view(mb, s, nh, hd), k.view(mb, s, nh, hd))):
        # the kernels take contiguous [b, s, heads, d]; .contiguous()
        # routes the gradients back into the split
        qh, kh, vh = (t.reshape(mb, s, nh, hd).contiguous()
                      for t in (q, k, v))
        o = flash_attention(qh, kh, vh, causal=True).reshape(mb, s, h)
    else:
        qh, kh, vh = (t.reshape(mb, s, nh, hd).transpose(1, 2)
                      for t in (q, k, v))
        scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        # -1e30 in the scores' dtype, as the reference's jnp.where takes
        # it (-inf in fp16; a CUDA where refuses the overflowing scalar)
        scores = torch.where(causal, scores, scores.new_tensor(-1e30))
        attn = torch.softmax(scores, dim=-1)
        o = (attn @ vh).transpose(1, 2).reshape(mb, s, h)
    o = o @ p["wo"] + p["bo"]
    if fused:
        return _block_mlp_fused(p, x, o, config)
    return _block_mlp(p, x + o, config)


def _block_mlp_fused(p, x, branch, config: GPTConfig):
    """The fused MLP half: the attention branch's residual add and LN2 in
    one op (``s = branch + x``, ``y = LN(s)``), fc1's bias and GELU in one
    epilogue op after the GEMM, then ``s + fc2``."""
    if "mlp" in config.ablate:    # perf attribution: skip the whole branch
        return x + branch
    y, s = _fm.fused_ln_residual(branch, x, p["ln2_g"], p["ln2_b"],
                                 eps=config.layer_norm_eps)
    y = _fm.fused_bias_gelu(y @ p["w1"], p["b1"])
    return s + (y @ p["w2"] + p["b2"])


def _block_mlp(p, x, config: GPTConfig):
    if "mlp" in config.ablate:    # perf attribution: skip the whole branch
        return x
    y = _layer_norm(x, p["ln2_g"], p["ln2_b"], config.layer_norm_eps)
    y = torch.nn.functional.gelu(y @ p["w1"] + p["b1"], approximate="tanh")
    return x + (y @ p["w2"] + p["b2"])


def _remat_policy(save_attn: bool, save_ln: bool):
    """Selective checkpoint policy: keep the weight-GEMM outputs (2-D
    ``aten.mm``, what ``checkpoint_dots_with_no_batch_dims`` keeps; the
    plain attention's batched products are recomputed), with
    ``save_attn`` the flash op's ``(out, lse)``, and with ``save_ln`` the
    fused LN ops' ``(y, [s,] mean, rstd)``."""
    keep = {torch.ops.aten.mm.default}
    if save_attn:
        keep.add(torch.ops.paddle_tpu_torch.flash_attention.default)
    if save_ln:
        keep.add(torch.ops.paddle_tpu_torch.fused_layer_norm.default)
        keep.add(torch.ops.paddle_tpu_torch.fused_ln_residual.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _stage_fn(layers, x, config: GPTConfig, flash: bool, fused: bool):
    """Apply the layers (a list of per-layer param dicts) to ``x``; with
    ``config.recompute`` each layer is rematerialized in the backward."""
    def body(x, *vals):
        return _block(dict(zip(STAGE_KEYS, vals)), x, config, flash, fused)

    if not config.recompute:
        for layer in layers:
            x = body(x, *(layer[k] for k in STAGE_KEYS))
        return x
    context = functools.partial(
        create_selective_checkpoint_contexts,
        _remat_policy(config.remat_save_attn,
                      fused and config.remat_save_ln))
    for layer in layers:
        x = checkpoint(body, x, *(layer[k] for k in STAGE_KEYS),
                       use_reentrant=False, context_fn=context)
    return x


def _pipeline(stages, mbs, config: GPTConfig, flash: bool, fused: bool):
    """pp = 1: the layers over each microbatch of ``mbs [M, mb, s, h]``.
    The stacked leaves are unbound once, so their gradients come back as
    one stack per leaf."""
    per_key = [stages[k].unbind(0) for k in STAGE_KEYS]
    layers = [dict(zip(STAGE_KEYS, vals)) for vals in zip(*per_key)]
    return torch.stack([_stage_fn(layers, mb, config, flash, fused)
                        for mb in mbs.unbind(0)])


def _chunk_nll(y_ch, emb, lb_ch, ablate_ce: bool):
    lg = (y_ch @ emb.T).float()                         # [b, chunk, v]
    if ablate_ce:
        # perf attribution: keep the head matmul, drop the softmax-CE math
        return lg.sum(-1) * 1e-9
    lse = torch.logsumexp(lg, dim=-1)
    tgt = lg.gather(-1, lb_ch[..., None])[..., 0]
    return lse - tgt                                    # [b, chunk]


def loss_fn(params, ids, labels, config: GPTConfig, num_micro: int = 1):
    """Mean next-token CE of ``ids`` against ``labels`` shifted left (the
    last position has no target): the reference's ``_loss_fn_inner`` at
    dp = pp = mp = 1."""
    b, s = ids.shape
    if b % num_micro:
        raise ValueError(f"batch {b} does not split into {num_micro} "
                         "microbatches")
    flash = _use_flash(config, ids.device)
    x = params["tok_emb"][ids] + params["pos_emb"][:s]
    mbs = x.reshape(num_micro, b // num_micro, s, x.shape[-1])
    fused = _fused_mlp_on(config, ids.device)
    y = _pipeline(params["stages"], mbs, config, flash, fused).reshape(
        b, s, -1)
    y = _layer_norm(y, params["lnf_g"], params["lnf_b"],
                    config.layer_norm_eps)
    # shifted next-token CE over the tied embedding, chunked over the
    # sequence; each chunk's logits are recomputed in the backward, so the
    # full [b, s, vocab] fp32 logits never exist at once
    emb = params["tok_emb"]
    lb = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
    chunk = s
    while chunk > 128 or s % chunk:
        chunk //= 2
    ablate_ce = "ce" in config.ablate
    nll = torch.cat([checkpoint(_chunk_nll, y[:, i:i + chunk], emb,
                                lb[:, i:i + chunk], ablate_ce,
                                use_reentrant=False)
                     for i in range(0, s, chunk)], dim=1)
    valid = (torch.arange(s, device=ids.device) < s - 1).to(nll.dtype)
    return (nll * valid).sum() / (b * (s - 1))


def value_and_grad(params, ids, labels, config: GPTConfig,
                   num_micro: int = 1):
    """``(loss, grads)``: the loss (detached) and a params-shaped dict of
    its gradients (zeros for leaves the loss does not reach, as
    ``jax.grad`` gives)."""
    pairs = list(leaves(params))
    for _, t in pairs:
        t.requires_grad_(True)
    loss = loss_fn(params, ids, labels, config, num_micro)
    grads = torch.autograd.grad(loss, [t for _, t in pairs],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), unflatten(
        (path, g) for (path, _), g in zip(pairs, grads))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _carry_params(params, config: GPTConfig, dtype, dev) -> dict:
    """Fresh leaf tensors on ``dev`` in ``dtype`` from a params-shaped dict
    of tensors or numpy arrays; raises on a missing, extra or misshapen
    leaf."""
    want = dict(leaves(param_shapes(config)))
    got = dict(leaves(params))
    bad = sorted(set(want) ^ set(got)) + sorted(
        p for p in set(want) & set(got) if tuple(np.shape(got[p])) != want[p])
    if bad:
        raise ValueError(f"params do not fit the config at {bad}")
    return unflatten(
        (p, torch.as_tensor(got[p]).to(device=dev, dtype=dtype, copy=True))
        for p in want)


def build_spmd_train_step(config: GPTConfig, mesh=None, *, batch_size: int,
                          seq_len: int, num_micro: int | None = None,
                          lr: float = 1e-3, momentum: float = 0.9,
                          zero_stage: int = 0, comm_quant=None,
                          device=None, params=None, dtype=torch.float32):
    """Returns ``(step, params, mom, (ids, labels))``.

    ``step(params, mom, ids, labels) -> (params, mom, loss)`` runs the loss
    and its gradients, then momentum SGD (``m = momentum m + g``, ``p -= lr
    m``) in place on ``params`` and ``mom``. ``mesh`` is ``None`` or a
    mapping of axis sizes (or an object with such a ``.shape``), all 1.
    ``device=None`` means ``cuda:0`` and raises without a card. ``params``
    carries weights in (a params-shaped dict of tensors or numpy arrays,
    copied to ``device`` in ``dtype``); else :func:`init_params` with seed 0.
    The example batch is ``np.random.RandomState(0)`` ids and labels, as in
    the reference. Counters ``train_steps`` and ``train_dispatch_seconds``
    (host seconds per call, from the second call on: the first builds the
    kernels) go to ``observability.default_registry``.
    """
    _check_train_config(config, mesh, zero_stage, comm_quant)
    dev = resolve_device(device)
    num_micro = num_micro or 2      # the reference's max(1, 2 * pp)
    if batch_size % num_micro:
        raise ValueError(f"batch_size {batch_size} does not split into "
                         f"{num_micro} microbatches")
    params = (init_params(config, dtype=dtype, device=dev) if params is None
              else _carry_params(params, config, dtype, dev))
    mom = sgd_init(params)
    m_steps = default_registry.counter("train_steps",
                                       "spmd train-step invocations")
    m_host_s = default_registry.counter(
        "train_dispatch_seconds", "host seconds dispatching train steps")
    built = [False]

    def step(params, mom, ids, labels):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(params, ids, labels, config, num_micro)
        ps = [t for _, t in leaves(params)]
        ms = [t for _, t in leaves(mom)]
        gs = [t for _, t in leaves(grads)]
        with torch.no_grad():
            torch._foreach_mul_(ms, momentum)
            torch._foreach_add_(ms, gs)
            torch._foreach_add_(ps, ms, alpha=-lr)
        m_steps.inc()
        if built[0]:
            m_host_s.inc(time.perf_counter() - t0)
        built[0] = True
        return params, mom, loss

    rng = np.random.RandomState(0)
    ids = rng.randint(0, config.vocab_size, (batch_size, seq_len))
    labels = rng.randint(0, config.vocab_size, (batch_size, seq_len))
    example = tuple(torch.from_numpy(a).to(dev, torch.long)
                    for a in (ids, labels))
    return step, params, mom, example
