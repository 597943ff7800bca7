"""GPT model family — port of ``paddle_tpu/models/gpt.py``.

Two halves, as in the reference:

- the full forward (``GPTForCausalLM``): pre-LN decoder blocks, learned
  positions, tanh-GELU MLP, fused QKV projection split ``[3, nh, hd]``,
  tied LM head ``h @ tok_emb.T``. Attention goes through
  ``nn.functional.scaled_dot_product_attention`` (the flash kernel on a
  CUDA tensor). It is the serving path's token-for-token oracle.
- the serving side: :func:`serving_params` stacks the per-layer weights
  on a leading ``[L]`` dim, and :func:`build_unified_step` builds the ONE
  serving step over a packed token budget — per layer LN, QKV, packed
  paged KV write, ragged paged attention (the hand-written kernel on a
  CUDA tensor), output projection, LN, MLP (with ``moe_experts``, the
  routed expert FFN of ``models/moe.py`` through the ragged grouped GEMM)
  — then the greedy / sampling epilogue. Weight stacks quantized by
  ``inference.quantize`` (``{"q", "s"}`` leaves) run through the
  weight-only GEMM kernel (expert stacks through the grouped GEMM), and
  ``kv_quant=True`` keeps the KV pools int8 with fp32 scale planes. With
  ``mega=True`` a layer is two kernels instead (``ops/mega_decode.py``:
  the attention side, the MLP side) and the K / V scatter between them.
- the legacy two-program path, the reference's A/B baseline and the
  oracle of its unified-vs-legacy gate: :func:`build_prefill` (one
  prompt bucket at a time, plain fp32 attention over the causal square,
  then the prompt's K/V scattered into its pages) and
  :func:`build_decode_step` (one token per slot: write its K/V, attend
  through the paged decode kernel, greedy argmax).

Linear weights keep the JAX layout ``[in, out]`` (``y = x @ W + b``), so
weights cross from the reference without a transpose.
"""
from __future__ import annotations

import gc
import math
from dataclasses import dataclass

import torch
from torch import nn

from .._device import resolve_device
from ..incubate.nn import functional as FI
from ..inference.kv_cache import (packed_dest, paged_copy_pages_,
                                  paged_write_packed_,
                                  paged_write_packed_prequant_,
                                  paged_write_packed_quant_,
                                  paged_write_prefill_, paged_write_tokens_)
from ..nn import functional as F
from ..nn.functional.attention import _sdpa_ref
from ..ops.mega_decode import HEAD_DIMS as MEGA_HEAD_DIMS
from ..ops.mega_decode import mega_attn_layer, mega_mlp, validate_mega_config
from ..ops.paged_attention import paged_attention, ragged_paged_attention
from ..ops.quant_matmul import quant_matmul
from .moe import GPTMoE, moe_ffn


@dataclass
class GPTConfig:
    """Same fields and defaults as the reference ``GPTConfig``. Fields for
    paths not ported yet (TP, recompute) raise where they would change
    behaviour; ``spec_decode_k`` / ``spec_draft_layers`` configure
    speculative serving (``inference.serving``); ``fused_mlp`` sends the
    eager decoder block
    through the fused LN / GELU kernels; ``mega_decode`` serves through
    the mega kernels; ``moe_experts`` replaces every block's MLP with a
    top-``moe_top_k`` routed expert FFN (``models/moe.py``);
    ``weight_dtype`` / ``weight_quant_group_size`` / ``kv_cache_dtype``
    configure quantized serving (``inference.serving``)."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int | None = None  # default 4*hidden
    hidden_dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_flash_attention: bool = True
    force_flash: bool = False
    fused_mlp: bool = False
    force_fused_mlp: bool = False
    tensor_parallel: bool = False
    recompute: bool = False
    remat_save_attn: bool = True
    remat_save_ln: bool = False
    ablate: tuple = ()
    weight_dtype: str | None = None
    weight_quant_group_size: int = -1
    kv_cache_dtype: str | None = None
    spec_decode_k: int = 0
    spec_draft_layers: int = 0
    mega_decode: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        f, e = self.ffn_size, self.moe_experts
        if e:
            mlp = h * e + e * (2 * h * f + h + f)
        else:
            mlp = 2 * h * f + h + f
        per_layer = 4 * h * h + 4 * h + mlp + 4 * h
        emb = v * h + self.max_seq_len * h
        return emb + l * per_layer + 2 * h


# GPT-3 paper table 2.1 sizes (the reference's benchmark ladder).
GPT_CONFIGS: dict[str, GPTConfig] = {
    "gpt3-tiny": GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=128),
    "gpt3-125m": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt3-350m": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-760m": GPTConfig(hidden_size=1536, num_layers=24, num_heads=16),
    "gpt3-1.3b": GPTConfig(hidden_size=2048, num_layers=24, num_heads=32, max_seq_len=2048),
    "gpt3-2.7b": GPTConfig(hidden_size=2560, num_layers=32, num_heads=32, max_seq_len=2048),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_layers=32, num_heads=32, max_seq_len=2048),
    "gpt3-13b": GPTConfig(hidden_size=5120, num_layers=40, num_heads=40, max_seq_len=2048),
}


def _plain_sdpa(q, k, v, attn_mask=None, is_causal=False, dropout_p=0.0,
                training=True):
    return _sdpa_ref(q, k, v, mask=attn_mask, causal=is_causal,
                     dropout_p=dropout_p if training else 0.0)


def _check_forward_config(cfg: GPTConfig) -> None:
    for field, later in (("tensor_parallel", "the multi-GPU slice"),
                         ("recompute", "the eager model's recompute; "
                                       "models.gpt_spmd's is ported")):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"GPTConfig.{field} is not ported yet ({later})")


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` stored ``[in, out]`` — the
    reference's layout (``nn.Linear`` would store ``[out, in]``)."""

    def __init__(self, in_f, out_f, bias=True, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_f, out_f, device=device,
                                               dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_f, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    """The reference's LayerNorm: fp32 statistics, normalize, cast back to
    the input dtype, then scale and shift in that dtype."""

    def __init__(self, h, eps, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(h, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(h, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return ((xf - mu) / torch.sqrt(var + self.eps)).to(x.dtype) \
            * self.weight + self.bias


class GPTEmbeddings(nn.Module):
    """Token + learned position embeddings with dropout."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(config.max_seq_len,
                                                config.hidden_size, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))


class GPTAttention(nn.Module):
    """Causal multi-head self-attention (fused qkv projection)."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.qkv_proj = Linear(h, 3 * h, device=device, dtype=dtype)
        self.out_proj = Linear(h, h, device=device, dtype=dtype)
        self.resid_dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, x, attn_mask=None):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        # use_flash_attention=False pins the plain reference attention even
        # where the flash kernel would run (the kernel's own oracle)
        sdpa = (F.scaled_dot_product_attention if cfg.use_flash_attention
                else _plain_sdpa)
        out = sdpa(q, k, v, attn_mask=attn_mask,
                   is_causal=attn_mask is None and s > 1,
                   dropout_p=cfg.attn_dropout, training=self.training)
        out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
        return self.resid_dropout(self.out_proj(out))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, f = config.hidden_size, config.ffn_size
        self.fc1 = Linear(h, f, device=device, dtype=dtype)
        self.fc2 = Linear(f, h, device=device, dtype=dtype)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, x):
        if _fused_mlp_on(self.config):
            # fc1's bias and the GELU in one epilogue kernel after the GEMM
            y = FI.fused_bias_gelu(x @ self.fc1.weight, self.fc1.bias)
            return self.dropout(self.fc2(y))
        return self.dropout(self.fc2(
            torch.nn.functional.gelu(self.fc1(x), approximate="tanh")))


def _fused_mlp_on(config: GPTConfig) -> bool:
    """The fused LN / GELU path: ``fused_mlp`` on one device (the kernel
    on a CUDA tensor, its plain version on a CPU tensor)."""
    return bool(config.fused_mlp) and not config.tensor_parallel


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer decoder block."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.mlp = (GPTMoE(config, **kw) if config.moe_experts
                    else GPTMLP(config, **kw))

    def forward(self, x, attn_mask=None):
        if _fused_mlp_on(self.config):
            return self._forward_fused(x, attn_mask=attn_mask)
        x = x + self.attn(self.ln_1(x), attn_mask=attn_mask)
        return x + self.mlp(self.ln_2(x))

    def _forward_fused(self, x, attn_mask=None):
        """LN1 in one kernel, then the attention branch's residual add and
        LN2 in one residual-in / residual-out kernel."""
        eps = self.config.layer_norm_eps
        y1 = FI.fused_layer_norm(x, self.ln_1.weight, self.ln_1.bias,
                                 epsilon=eps)
        a = self.attn(y1, attn_mask=attn_mask)
        y2, s = FI.fused_ln_residual(a, x, self.ln_2.weight, self.ln_2.bias,
                                     epsilon=eps)
        return s + self.mlp(y2)


class GPTModel(nn.Module):
    """Embeddings + decoder stack + final LN."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        _check_forward_config(config)
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embeddings = GPTEmbeddings(config, **kw)
        self.layers = nn.ModuleList(GPTDecoderLayer(config, **kw)
                                    for _ in range(config.num_layers))
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)

    def forward(self, input_ids, position_ids=None, attn_mask=None):
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            x = layer(x, attn_mask=attn_mask)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPTModel + LM head (weight-tied by default).

    Built on ``device`` (``None`` = ``cuda:0``, raising without a card)
    with N(0, initializer_range) weight matrices, router weights, expert
    stacks and embeddings drawn from a ``torch.Generator`` seeded with
    ``seed``; biases zero, LN scales one.
    """

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.gpt = GPTModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings
                        else Linear(config.hidden_size, config.vocab_size,
                                    bias=False, **kw))
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if ((leaf == "weight" and "ln_" not in name)
                        or (".mlp." in name and leaf in GPTMoE.MATRICES)):
                    p.normal_(0.0, config.initializer_range, generator=gen)

    def _logits(self, hidden):
        if self.lm_head is None:
            return hidden @ self.gpt.embeddings.word_embeddings.weight.T
        return self.lm_head(hidden)

    def forward(self, input_ids, position_ids=None, attn_mask=None):
        hidden = self.gpt(input_ids, position_ids=position_ids,
                          attn_mask=attn_mask)
        return self._logits(hidden)


# ---------------------------------------------------------------------------
# serving path: stacked params + the unified ragged step
# ---------------------------------------------------------------------------

# the ONE per-layer weight table (reference gpt.py _SRV_LAYER_WEIGHTS)
_SRV_LAYER_WEIGHTS = (
    ("ln1_g", lambda l: l.ln_1.weight), ("ln1_b", lambda l: l.ln_1.bias),
    ("wqkv", lambda l: l.attn.qkv_proj.weight),
    ("bqkv", lambda l: l.attn.qkv_proj.bias),
    ("wo", lambda l: l.attn.out_proj.weight),
    ("bo", lambda l: l.attn.out_proj.bias),
    ("ln2_g", lambda l: l.ln_2.weight), ("ln2_b", lambda l: l.ln_2.bias),
    ("w1", lambda l: l.mlp.fc1.weight), ("b1", lambda l: l.mlp.fc1.bias),
    ("w2", lambda l: l.mlp.fc2.weight), ("b2", lambda l: l.mlp.fc2.bias),
)

# MoE blocks swap the dense-MLP rows for the stacked expert tree (the [E,
# ...] stacks gain the leading [L] dim like the dense keys)
_SRV_MOE_WEIGHTS = (
    ("moe_gate", lambda l: l.mlp.gate_weight),
    ("moe_w1", lambda l: l.mlp.w1), ("moe_b1", lambda l: l.mlp.b1),
    ("moe_w2", lambda l: l.mlp.w2), ("moe_b2", lambda l: l.mlp.b2),
)
_DENSE_MLP_KEYS = ("w1", "b1", "w2", "b2")


def _srv_layer_weight_table(config):
    """The per-layer serving weights of ``config``: the dense table, or
    with ``moe_experts`` its attention rows and the expert stacks."""
    if config.moe_experts:
        return tuple(kv for kv in _SRV_LAYER_WEIGHTS
                     if kv[0] not in _DENSE_MLP_KEYS) + _SRV_MOE_WEIGHTS
    return _SRV_LAYER_WEIGHTS


@torch.no_grad()
def serving_params(model) -> dict:
    """The serving params dict of a ``GPTForCausalLM`` / ``GPTModel``:
    embeddings, final LN (and an untied ``lm_head``) as views of the live
    weights, per-layer weights stacked on a leading ``[L]`` dim (copies)."""
    gpt = model.gpt if hasattr(model, "gpt") else model
    params = {"tok_emb": gpt.embeddings.word_embeddings.weight.detach(),
              "pos_emb": gpt.embeddings.position_embeddings.weight.detach(),
              "lnf_g": gpt.ln_f.weight.detach(),
              "lnf_b": gpt.ln_f.bias.detach()}
    if getattr(model, "lm_head", None) is not None:
        params["lm_head"] = model.lm_head.weight.detach()
    params["layers"] = {k: torch.stack([get(l).detach() for l in gpt.layers])
                        for k, get in _srv_layer_weight_table(gpt.config)}
    return params


def _srv_ln(x, g, b, eps):
    """Serving LayerNorm: fp32 statistics and affine, cast back."""
    return torch.nn.functional.layer_norm(
        x.float(), x.shape[-1:], g.float(), b.float(), eps).to(x.dtype)


def _srv_embed(params, tok_ids, tok_pos):
    """Token + position embeddings of packed rows (ids and positions
    clamped into their tables; padding rows carry -1 or 0)."""
    pos_c = tok_pos.long().clamp(0, params["pos_emb"].shape[0] - 1)
    return params["tok_emb"][tok_ids.long().clamp_min(0)] \
        + params["pos_emb"][pos_c]


def _srv_logits(params, h):
    """h [..., hidden] -> logits [..., vocab] (tied head unless lm_head)."""
    if "lm_head" in params:
        return h @ params["lm_head"]
    return h @ params["tok_emb"].T


def _srv_mm(y, w):
    """The serving matmul: fp weights ride ``@``; quantized stacks (``{"q":
    int8 | packed int4, "s": scales}``, see ``inference/quantize.py``) ride
    the weight-only GEMM, staying quantized on the device."""
    if isinstance(w, dict):
        return quant_matmul(y, w["q"], w["s"])
    return y @ w


def _srv_affine(y, w, b):
    """``y @ w + b``: fp weights fuse the bias add in ``addmm``; quantized
    ones add it after the GEMM's cast to y's dtype, as the reference's
    ``_srv_mm(y, w) + b`` does."""
    if isinstance(w, dict):
        return _srv_mm(y, w) + b
    return torch.addmm(b, y, w)


def _srv_attn_out(x, a, p):
    """The residual add of the attention output projection: quantized
    ``wo`` keeps the reference's association ``(x + a @ wo) + bo``; fp
    fuses the bias in ``addmm``."""
    if isinstance(p["wo"], dict):
        return x + _srv_mm(a, p["wo"]) + p["bo"]
    return x + torch.addmm(p["bo"], a, p["wo"])


def _srv_mlp(p, y):
    """[t, h] rows through the tanh-GELU MLP."""
    hidden = torch.nn.functional.gelu(_srv_affine(y, p["w1"], p["b1"]),
                                      approximate="tanh")
    return _srv_affine(hidden, p["w2"], p["b2"])


def _srv_moe(config, p, y, valid=None):
    """The serving MoE FFN: the same :func:`models.moe.moe_ffn` the eager
    model runs, over the packed token rows. ``valid`` (``tok_slot >= 0``
    in the unified step) keeps padding rows out of the capacity race: they
    route nowhere and output zero."""
    out, _aux = moe_ffn(
        y, p["moe_gate"], p["moe_w1"], p["moe_b1"], p["moe_w2"],
        p["moe_b2"], top_k=config.moe_top_k,
        capacity_factor=config.moe_capacity_factor, valid=valid)
    return out


def _srv_ffn(config, p, y, valid=None):
    """The block FFN of the serving step: the dense MLP, or the routed
    experts with ``moe_experts``."""
    if config.moe_experts:
        return _srv_moe(config, p, y, valid=valid)
    return _srv_mlp(p, y)


def _layer_params(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked serving params (quantized leaves keep
    their ``{"q", "s"}`` form)."""
    return {k: ({n: t[i] for n, t in w.items()} if isinstance(w, dict)
                else w[i]) for k, w in layers.items()}


def _split_qkv(qkv, nh, hd):
    """[..., 3*nh*hd] -> (q, k, v) each [..., nh, hd]: the fused
    projection's columns are ordered [3, nh, hd] (the reference's mesh
    layout, head-major, comes with the multi-GPU slice)."""
    lead = qkv.shape[:-1]
    q4 = qkv.reshape(*lead, 3, nh, hd)
    return q4[..., 0, :, :], q4[..., 1, :, :], q4[..., 2, :, :]


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """Low 32 bits of ``x * c`` for int64 tensors ``x`` in [0, 2^32) —
    split in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def lane_uniform(seeds, produced):
    """One uniform in [0, 1) per lane from (request seed, tokens produced)
    — a counter-based hash, identical on the CPU and the card, so a
    request's sampled stream depends on its seed and position only (batch
    order and preemption replays re-draw the same numbers). The JAX
    reference folds a threefry key instead; the bits differ by design."""
    s = seeds.long() & _M32
    h = _fmix32(s ^ _mul32(produced.long() & _M32, 0x9E3779B9))
    h = _fmix32(h ^ ((_mul32(s, 0x85EBCA6B) + 0x27D4EB2F) & _M32))
    return (h >> 8).double() / float(1 << 24)


def _sample_epilogue(logits, u, temperature, top_k, top_p):
    """Temperature / top-k / top-p sampling over ``logits [b, v]`` fp32 by
    inverse CDF with the per-lane uniforms ``u [b]`` (see
    :func:`lane_uniform`). ``top_k <= 0`` disables the k filter, ``top_p``
    outside (0, 1) the p filter; ties at the k-th / p-th value stay in.
    Returns ids [b] int64 — the caller selects argmax where
    temperature == 0. Every lane runs it (one program for greedy and
    sampled lanes): a greedy lane divides by 1, so its values stay finite
    and every index stays in range."""
    v = logits.shape[-1]
    t = torch.where(temperature > 0, temperature.clamp_min(1e-6), 1.0)
    scaled = logits / t.float()[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, v).clamp(1, v).long()
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    keep = scaled >= kth
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_exclusive = probs.cumsum(-1) - probs
    p_active = (top_p > 0.0) & (top_p < 1.0)
    n_keep = (cum_exclusive < top_p[:, None]).sum(-1).clamp(1, v)
    n_keep = torch.where(p_active, n_keep, v).long()
    pth = sorted_desc.gather(1, (n_keep - 1)[:, None])
    keep &= scaled >= pth
    masked = torch.where(keep, scaled, -1e30)
    cdf = torch.softmax(masked, dim=-1).double().cumsum(-1)
    target = u.double()[:, None] * cdf[:, -1:]
    return torch.searchsorted(cdf, target, right=True)[:, 0].clamp(0, v - 1)


def _param_leaves(params, path=()):
    """``(path, tensor)`` for every tensor leaf of a serving params dict,
    in key order (quantized ``{"q", "s"}`` leaves included)."""
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            yield from _param_leaves(v, path + (k,))
        else:
            yield path + (k,), v


class _Captured:
    """One geometry's program captured in a CUDA graph: the tensors of the
    call it was captured from are its inputs (the params by their leaves),
    its outputs are static buffers, and ``delta`` is what the capture added
    to the kernel wrappers' counters (see ``ops.counters``), which every
    replay adds."""

    def __init__(self, fn, args):
        from .. import ops

        self.args = args            # keeps the bound buffers alive
        self.leaves = list(_param_leaves(args[0]))
        before = ops.counters()
        self.graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection while capturing: a dead cycle that
        # holds another CUDA graph (or pinned memory) would be freed in the
        # middle of the capture, which invalidates it
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = fn(*args)
        finally:
            if was_enabled:
                gc.enable()
            after = ops.counters()
            # a capture launches nothing
            ops.set_counters({k: before.get(k, 0) for k in after})
        self.delta = {k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)}

    def replay(self, args):
        from .. import ops

        leaves = list(_param_leaves(args[0]))
        if [p for p, _ in leaves] != [p for p, _ in self.leaves]:
            raise ValueError("the params of the captured step hold other "
                             "leaves than the ones its capture bound")
        for (path, arg), (_, bound) in zip(leaves, self.leaves):
            if arg.data_ptr() != bound.data_ptr() or arg.shape != bound.shape:
                raise ValueError(
                    f"params leaf {'/'.join(path)} of the captured step is "
                    "not the tensor its capture bound: the step serves the "
                    "weights it was captured with (build another step for "
                    "other weights)")
        for i, (bound, arg) in enumerate(zip(self.args[1:], args[1:]), 1):
            if arg.data_ptr() != bound.data_ptr() or arg.shape != bound.shape:
                raise ValueError(f"argument {i} of the captured step is not "
                                 "the tensor its capture bound: a caller "
                                 "fills the same buffers every round")
        self.graph.replay()
        ops.set_counters(self.delta, add=True)
        return self.out


class _CapturedProgram:
    """A program captured once per geometry (see :class:`UnifiedStep`):
    ``_programs`` maps each geometry to its :class:`_Captured` (``None`` on
    the CPU, where every call runs eagerly)."""

    def __init__(self):
        self._programs: dict = {}

    @property
    def trace_count(self) -> int:
        return len(self._programs)

    @property
    def replay_counts(self) -> list:
        """What one replay of each capture adds to the kernel wrappers'
        counters (``ops.counters`` keys), in capture order."""
        return [dict(p.delta) for p in self._programs.values()
                if p is not None]

    def _run(self, key, args, n_out, pools):
        """Run ``self.eager(*args)`` under geometry ``key``: eagerly on the
        CPU; on a CUDA device eagerly on a side stream the first time (it
        builds and loads every kernel and grows every scratch buffer), then
        captured, and replayed on every later call. Returns the first
        ``n_out`` outputs (copied out of the graph's static buffers) and
        ``pools``, updated in place."""
        if args[1].device.type != "cuda":
            self._programs.setdefault(key, None)
            return self.eager(*args)
        prog = self._programs.get(key)
        if prog is None:
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self.eager(*args)
            cur.wait_stream(side)
            for t in out[:n_out]:
                t.record_stream(cur)
            self._programs[key] = _Captured(self.eager, args)
            return out
        out = prog.replay(args)
        return tuple(t.clone() for t in out[:n_out]) + tuple(pools)


def _weight_kind(params):
    w = params["layers"]["wqkv"]
    return ((str(w["q"].dtype), tuple(w["q"].shape), tuple(w["s"].shape))
            if isinstance(w, dict) else "fp")


class UnifiedStep(_CapturedProgram):
    """The serving step :func:`build_unified_step` returns.

    On a CUDA device each step geometry is captured once in a CUDA graph
    and every later call of that geometry replays it. The geometry is the
    key (page size, chunk, token budget, ``max_batch``, ``spec_k``,
    ``kv_quant``, ``mega``, dtype, weight kind, MoE) together with the
    pools the capture binds. The first call of a geometry runs the step
    eagerly on a side stream (it builds and loads every kernel, sets their
    attributes and grows every scratch buffer) and returns that result;
    the capture follows. The tensors of that first call become the graph's
    inputs, the params by their leaves (each leaf's address and shape, not
    the dict): every later call must pass the same tensors, refilled (the
    serving predictor's persistent buffers), in any dict, and one that
    passes another tensor, a params leaf included, raises. Outputs are
    copied out of the graph's static buffers before they are returned. A
    capture that fails raises; nothing falls back to the eager step.

    ``trace_count`` counts captures on a CUDA device and, on the CPU
    (where every call runs eagerly), the distinct geometries that ran —
    the reference's one jitted executable per geometry. :meth:`eager`
    runs one step without capture.
    """

    def __init__(self, config, page_size, chunk, kv_quant=False,
                 mega=False, spec_k=0):
        super().__init__()
        self.config = config
        self.page_size = int(page_size)
        self.chunk = int(chunk)
        self.kv_quant = bool(kv_quant)
        self.mega = bool(mega)
        self.spec_k = int(spec_k)

    @property
    def arg_names(self) -> tuple:
        """The names of the step's arguments before the pools."""
        return (("params", "tok_ids", "tok_slot", "tok_pos", "q_lens",
                 "kv_lens", "last_idx")
                + (("spec_len",) if self.spec_k else ())
                + ("feedback", "prev_toks", "emit_mask", "produced"))

    def _geometry(self, params, tok_ids, q_lens, pools):
        key = (self.page_size, self.chunk, tok_ids.shape[0], q_lens.shape[0],
               self.spec_k, self.kv_quant, self.mega, params["tok_emb"].dtype,
               _weight_kind(params), self.config.moe_experts)
        if tok_ids.device.type != "cuda":
            return key
        return key + (tuple(p.data_ptr() for p in pools),)

    @torch.no_grad()
    def __call__(self, params, *arrays):
        """One step; the arguments and results of :meth:`eager`."""
        args = (params,) + arrays
        pools = self._split(arrays)[1]
        key = self._geometry(params, arrays[0], arrays[3], pools)
        return self._run(key, args, 4 if self.spec_k else 2, pools)

    def _split(self, arrays):
        """The step's arrays after params: (lead, pools, tail)."""
        n_lead = len(self.arg_names) - 1
        n_pool = 4 if self.kv_quant else 2
        if len(arrays) != n_lead + n_pool + 7:
            raise TypeError(
                f"the unified step takes params, {n_lead} packed and lane "
                f"arrays, {n_pool} pools and 7 trailing arrays, got params "
                f"and {len(arrays)} arrays")
        return (arrays[:n_lead], arrays[n_lead:n_lead + n_pool],
                arrays[n_lead + n_pool:])

    @torch.no_grad()
    def eager(self, params, *arrays, all_rows=False):
        """One step over the packed token budget, run op by op (reference
        signature, with ``lane_seeds [b]`` — int32 or int64, read as
        unsigned 32-bit — in place of the threefry ``base_keys``):
        ``params, tok_ids, tok_slot, tok_pos, q_lens, kv_lens, last_idx``,
        with ``spec_k`` then ``spec_len``, then ``feedback, prev_toks,
        emit_mask, produced``; then the pools — ``k_pool, v_pool`` and, with
        ``kv_quant``, ``k_scales, v_scales`` — then ``page_table, cow_src,
        cow_dst, lane_seeds, temperature, top_k, top_p``.

        Pools are ``[L, num_pages + 1, page_size, kv_heads, head_dim]`` (int8
        with ``kv_quant``; scale planes ``[L, num_pages + 1, page_size,
        kv_heads]`` fp32): page ``num_pages`` is the spare page that padding
        and unallocated writes land in (the reference's ``mode="drop"``).
        They are updated in place (the reference donates them) and
        returned. The copy-on-write lanes always run: a lane with no copy
        due carries the ``num_pages`` sentinel in ``cow_src`` and
        ``cow_dst`` (its copy lands in the spare page). The sampling
        epilogue always runs too, and ``temperature > 0`` picks its token
        over the greedy argmax per lane. Returns ``(next_toks [b] int32,
        logits [b, v] fp32, *pools)``; with ``spec_k`` see
        :meth:`_verify` (``all_rows``: the logits of every verify row in
        place of row 0's, for checks).
        """
        lead, pools, tail = self._split(arrays)
        tok_ids, tok_slot, tok_pos, q_lens, kv_lens, last_idx = lead[:6]
        spec_len = lead[6] if self.spec_k else None
        feedback, prev_toks, emit_mask, produced = lead[-4:]
        (page_table, cow_src, cow_dst, lane_seeds, temperature, top_k,
         top_p) = tail
        cfg, chunk, ps = self.config, self.chunk, self.page_size
        t, b = tok_ids.shape[0], q_lens.shape[0]
        num_pages = pools[0].shape[1] - 1
        # scale planes are page-keyed: they ride the same copy lanes
        for pool in pools:
            paged_copy_pages_(pool, cow_src, cow_dst)
        valid = tok_slot >= 0
        slot_c = tok_slot.long().clamp(0, b - 1)
        tok_ids = torch.where((feedback > 0) & valid, prev_toks[slot_c],
                              tok_ids)
        x = _srv_embed(params, tok_ids, tok_pos)
        # packed <-> [b, chunk] block plumbing shared by every layer: each
        # token's row in the flattened [(b + 1) * chunk] query block (block
        # b is the dump block for padding tokens) and its page slot
        off_c = (tok_pos - kv_lens[slot_c]).long().clamp(0, chunk - 1)
        q_rows = torch.where(valid, tok_slot.long(), b) * chunk + off_c
        a_rows = slot_c * chunk + off_c
        dest = packed_dest(page_table, tok_slot, tok_pos, ps, num_pages)
        if self.mega:
            x = self._mega_layers(params, x, pools, page_table, q_lens,
                                  kv_lens, q_rows, a_rows, dest)
        else:
            x = self._per_op_layers(params, x, pools, page_table, q_lens,
                                    kv_lens, q_rows, a_rows, dest, valid)
        x = _srv_ln(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_eps)
        sampling = (lane_seeds, temperature, top_k, top_p)
        if self.spec_k:
            return self._verify(params, x, tok_ids, last_idx, spec_len,
                                prev_toks, emit_mask, produced, sampling,
                                all_rows) + tuple(pools)
        h_last = x[last_idx.long().clamp(0, t - 1)]
        logits = _srv_logits(params, h_last).float()
        sampled = _sample_epilogue(logits, lane_uniform(lane_seeds, produced),
                                   temperature, top_k, top_p)
        next_ids = torch.where(temperature > 0, sampled, logits.argmax(-1))
        next_toks = torch.where(emit_mask > 0, next_ids.to(torch.int32),
                                prev_toks)
        return (next_toks, logits) + tuple(pools)

    def _verify(self, params, x, tok_ids, last_idx, spec_len, prev_toks,
                emit_mask, produced, sampling, all_rows=False):
        """The speculative verify rows and the fused accept epilogue
        (reference ``build_unified_step(spec_k=)``): rows ``last_idx ..
        last_idx + spec_k`` of each lane (its last context token, then its
        drafts) each yield a token, row j sampled with ``produced + j`` so a
        seeded stream equals plain decode's; drafts are accepted while
        ``draft[i] == token[i - 1]`` within ``spec_len``. Returns
        ``(out_ids [b, spec_k + 1] int32, n_emit [b] int32, next_toks [b]
        int32, logits [b, v] fp32 of row 0)``: a lane's first ``n_emit``
        tokens of ``out_ids`` are its emissions (accepted drafts and one
        more), and ``next_toks`` carries its last emission; with
        ``all_rows`` the logits are every row's, ``[b, spec_k + 1, v]``."""
        lane_seeds, temperature, top_k, top_p = sampling
        k, t, b = self.spec_k, x.shape[0], last_idx.shape[0]
        k1 = k + 1
        step = torch.arange(k1, device=x.device)
        rows = (last_idx.long()[:, None] + step).clamp(0, t - 1)  # [b, k1]
        logits = _srv_logits(params, x[rows]).float()          # [b, k1, v]
        v = logits.shape[-1]
        rep = lambda a: a.repeat_interleave(k1)  # noqa: E731
        u = lane_uniform(rep(lane_seeds),
                         (produced.long()[:, None] + step).reshape(-1))
        sampled = _sample_epilogue(logits.reshape(b * k1, v), u,
                                   rep(temperature), rep(top_k), rep(top_p))
        out_ids = torch.where((temperature > 0)[:, None],
                              sampled.view(b, k1), logits.argmax(-1)
                              ).to(torch.int32)
        drafts = tok_ids[rows[:, 1:]]                             # [b, k]
        ok = (drafts == out_ids[:, :k]) & (step[None, :k]
                                           < spec_len.long()[:, None])
        n_emit = (1 + ok.int().cumprod(1).sum(1)).to(torch.int32)
        last_emit = out_ids.gather(1, (n_emit.long() - 1)[:, None])[:, 0]
        next_toks = torch.where(emit_mask > 0, last_emit, prev_toks)
        return out_ids, n_emit, next_toks, logits if all_rows else logits[:, 0]

    def _per_op_layers(self, params, x, pools, page_table, q_lens, kv_lens,
                       q_rows, a_rows, dest, valid=None):
        """The decoder stack on the per-op path: per layer LN, QKV, the
        packed K / V write, the ragged kernel over ``[b, chunk]`` query
        blocks (contexts at ``kv_lens + q_lens``), output projection, LN
        and MLP (or the routed experts, where padding rows ``~valid`` take
        no capacity slot; ``None``: every row is a token) on the packed
        rows. Returns the packed rows."""
        cfg, chunk = self.config, self.chunk
        eps, nh, hd = cfg.layer_norm_eps, cfg.num_heads, cfg.head_dim
        b = q_lens.shape[0]
        k_pool, v_pool = pools[0], pools[1]
        k_scales, v_scales = pools[2:] if self.kv_quant else (None, None)
        num_pages = k_pool.shape[1] - 1
        ctx = (kv_lens + q_lens).to(torch.int32)
        lay = params["layers"]
        for i in range(cfg.num_layers):
            p = _layer_params(lay, i)
            y = _srv_ln(x, p["ln1_g"], p["ln1_b"], eps)
            q, k_t, v_t = _split_qkv(_srv_affine(y, p["wqkv"], p["bqkv"]),
                                     nh, hd)
            scales = {}
            if self.kv_quant:
                paged_write_packed_quant_(k_pool[i], k_scales[i], k_t, dest)
                paged_write_packed_quant_(v_pool[i], v_scales[i], v_t, dest)
                scales = dict(k_scales=k_scales[i, :num_pages],
                              v_scales=v_scales[i, :num_pages])
            else:
                paged_write_packed_(k_pool[i], k_t, dest)
                paged_write_packed_(v_pool[i], v_t, dest)
            qb = q.new_zeros(((b + 1) * chunk, nh, hd))
            qb[q_rows] = q
            ab = ragged_paged_attention(
                qb[:b * chunk].view(b, chunk, nh, hd), k_pool[i, :num_pages],
                v_pool[i, :num_pages], page_table, ctx, q_lens, **scales)
            a = ab.reshape(b * chunk, nh * hd)[a_rows]  # back to packed [t]
            x = _srv_attn_out(x, a, p)
            x = x + _srv_ffn(cfg, p, _srv_ln(x, p["ln2_g"], p["ln2_b"], eps),
                             valid=valid)
        return x

    def _mega_layers(self, params, x, pools, page_table, q_lens, kv_lens,
                     q_rows, a_rows, dest):
        """The decoder stack through the two mega kernels a layer: the
        packed rows ``x [t, h]`` scatter once into ``[b, chunk, h]`` lane
        blocks (padding rows into the dump block), each layer's attention
        kernel reads the pool at ``kv_lens`` (this step's rows it attends
        in-kernel) and emits the new K / V rows, which gather back to the
        packed order and scatter into the pools; the MLP kernel runs on the
        rows each lane feeds (``q_lens``) with the residual and leaves the
        others zero. Returns the packed rows."""
        cfg, chunk = self.config, self.chunk
        nh, hd, h = cfg.num_heads, cfg.head_dim, x.shape[-1]
        b = q_lens.shape[0]
        num_pages = pools[0].shape[1] - 1
        xb = x.new_zeros(((b + 1) * chunk, h))
        xb[q_rows] = x
        xb = xb[:b * chunk].view(b, chunk, h)
        for i in range(cfg.num_layers):
            p = _layer_params(params["layers"], i)
            kv = [pool[i] for pool in pools]
            scales = {}
            if self.kv_quant:
                scales = dict(k_scales=kv[2][:num_pages],
                              v_scales=kv[3][:num_pages])
            y2, s, k_new, v_new, *sc = mega_attn_layer(
                xb, p, kv[0][:num_pages], kv[1][:num_pages], page_table,
                kv_lens, q_lens, eps=cfg.layer_norm_eps, **scales)
            for j, new in enumerate((k_new, v_new)):
                rows = new.reshape(b * chunk, nh, hd)[a_rows]
                if self.kv_quant:
                    paged_write_packed_prequant_(
                        kv[j], kv[j + 2], rows,
                        sc[j].reshape(b * chunk, nh)[a_rows], dest)
                else:
                    paged_write_packed_(kv[j], rows, dest)
            # rows past q_lens come back zero: the next layer's attention
            # skips them and the step gathers only a_rows
            xb = mega_mlp(y2.reshape(b * chunk, h), s.reshape(b * chunk, h),
                          p, chunk=chunk, q_lens=q_lens).view(b, chunk, h)
        return xb.reshape(b * chunk, h)[a_rows]


def build_unified_step(config: GPTConfig, page_size: int, chunk: int,
                       kv_quant: bool = False, mesh=None, spec_k: int = 0,
                       mega: bool = False, device=None) -> UnifiedStep:
    """The unified serving step on one device (``mesh`` raises, naming its
    slice). ``kv_quant=True`` takes int8 pools with fp32 scale planes
    (quantize on write); quantized weight leaves in the params run the
    weight-only GEMM. ``mega=True`` runs each layer through the two mega
    kernels instead (``ops/mega_decode.py``; ``validate_mega_config``
    rejects MoE, int4 weights and misaligned scale groups here, at build
    time). With ``moe_experts`` each layer's FFN is the routed expert FFN
    (``_srv_moe``). ``spec_k > 0`` builds the speculative step: the
    arrays gain ``spec_len [b]`` after ``last_idx``, which becomes each
    lane's first verify row, and the step returns ``(out_ids [b, spec_k +
    1], n_emit [b], next_toks [b], logits [b, v], *pools)``
    (:meth:`UnifiedStep._verify`); one capture serves every k <= spec_k.
    Speculation with MoE raises (a later slice). The step runs the kernels
    when its tensors are on a CUDA device and their plain versions when
    they are on the CPU. ``device``: where those tensors will live, when
    the caller knows; on a CUDA device a mega build also rejects head dims
    the mega kernels are not built for (the plain versions take any)."""
    if mesh is not None:
        raise NotImplementedError("build_unified_step: multi-GPU "
                                  "(tensor-parallel) serving is a later "
                                  "port slice")
    spec_k = int(spec_k)
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k and config.moe_experts:
        raise NotImplementedError(
            "build_unified_step: speculative decoding with moe_experts is a "
            "later port slice")
    if mega:
        _check_mega(config, device)
    return UnifiedStep(config, page_size, chunk, kv_quant=kv_quant,
                       mega=mega, spec_k=spec_k)


def _check_mega(config: GPTConfig, device) -> None:
    """The mega kernels' build-time rejections (see
    :func:`build_unified_step`)."""
    validate_mega_config(config.weight_dtype, config.weight_quant_group_size,
                         config.head_dim, moe_experts=config.moe_experts)
    if (device is not None and torch.device(device).type == "cuda"
            and config.head_dim not in MEGA_HEAD_DIMS):
        raise NotImplementedError(
            f"mega_decode on CUDA: the mega attention kernel is built for "
            f"head_dim in {MEGA_HEAD_DIMS}, got {config.head_dim} — serve "
            "this config with mega_decode=False")


# ---------------------------------------------------------------------------
# the self-draft: a truncated stack of the same serving params
# ---------------------------------------------------------------------------


def draft_config(config: GPTConfig, draft_layers: int) -> GPTConfig:
    """The truncated-stack config of the draft programs (reference
    ``draft_config``): the first ``draft_layers`` layers, no nested
    speculation, the per-op family (:func:`build_draft_chain` takes
    ``mega`` itself). ``draft_layers`` below 1 or at least ``num_layers``
    raises."""
    import dataclasses

    draft_layers = int(draft_layers)
    if draft_layers < 1:
        raise ValueError(
            f"spec_draft_layers must be >= 1, got {draft_layers}")
    if draft_layers >= config.num_layers:
        raise ValueError(
            f"spec_draft_layers {draft_layers} must be < num_layers "
            f"{config.num_layers} (a full-depth draft would run the "
            "target twice per token instead of a cheap proposer)")
    return dataclasses.replace(config, num_layers=draft_layers,
                               spec_decode_k=0, spec_draft_layers=0,
                               mega_decode=False)


def draft_serving_params(params: dict, draft_layers: int) -> dict:
    """``params`` cut to its first ``draft_layers`` layers: the embeddings,
    final LN and LM head are the same tensors, and each layer stack (fp, or
    both halves of a quantized leaf) a view of its first rows. Make it once
    and keep it: a captured draft program binds these views."""
    d = int(draft_layers)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {
        n: ({q: t[:d] for q, t in w.items()} if isinstance(w, dict)
            else w[:d]) for n, w in params["layers"].items()}
    return out


def build_draft_step(config: GPTConfig, draft_layers: int, page_size: int,
                     chunk: int, kv_quant: bool = False, mesh=None,
                     device=None) -> UnifiedStep:
    """The draft pass's catch-up step: the per-op unified step of the
    truncated config (:func:`draft_config`) at ``chunk`` tokens a lane, one
    capture per geometry like the target's. ``mesh`` raises."""
    return build_unified_step(draft_config(config, draft_layers), page_size,
                              chunk, kv_quant=kv_quant, mesh=mesh,
                              device=device)


class DraftChain(_CapturedProgram):
    """What :func:`build_draft_chain` returns: the k chunk-1 steps of the
    truncated stack, each lane's greedy token fed to its next step on the
    device, run as one program — on a CUDA device one CUDA graph per
    geometry (batch, ``k``, the pools it binds), captured as
    :class:`UnifiedStep` captures."""

    def __init__(self, config, page_size, k, kv_quant=False, mega=False):
        super().__init__()
        self.config = config
        self.k = int(k)
        # the layer bodies of the unified step at chunk 1
        self._step = UnifiedStep(config, page_size, 1, kv_quant=kv_quant,
                                 mega=mega)

    @torch.no_grad()
    def __call__(self, params, first_toks, steps, kv_lens, *rest):
        """One chain; the arguments and results of :meth:`eager`."""
        st = self._step
        pools = rest[:-1]
        key = (st.page_size, self.k, first_toks.shape[0], st.kv_quant,
               st.mega, params["tok_emb"].dtype, _weight_kind(params))
        if first_toks.device.type == "cuda":
            key += (tuple(p.data_ptr() for p in pools),)
        return self._run(key, (params, first_toks, steps, kv_lens) + rest,
                         1, pools)

    @torch.no_grad()
    def eager(self, params, first_toks, steps, kv_lens, *rest):
        """``first_toks [b]`` each lane's last context token, ``steps [b]``
        the chain steps it runs (0: idle, it writes nothing), ``kv_lens
        [b]`` the draft pool's watermark, then the pools (as
        :meth:`UnifiedStep.eager`) and ``page_table``, whose pages must
        already hold ``kv_lens + steps`` tokens. Step j writes each active
        lane's K / V at ``kv_lens + j`` and takes its greedy token. Returns
        ``(drafts [b, k] int32, *pools)``, a lane's drafts past its steps
        0."""
        st = self._step
        pools, page_table = rest[:-1], rest[-1]
        eps = self.config.layer_norm_eps
        b = first_toks.shape[0]
        num_pages = pools[0].shape[1] - 1
        lane = torch.arange(b, dtype=torch.int32, device=first_toks.device)
        ids = first_toks.to(torch.int32)
        drafts = []
        for j in range(self.k):
            active = steps > j
            q_lens = active.to(torch.int32)
            tok_slot = torch.where(active, lane, -1)
            pos = kv_lens + j
            slot_c = tok_slot.long().clamp(0, b - 1)
            x = _srv_embed(params, ids, pos)
            q_rows = torch.where(active, tok_slot.long(), b)
            dest = packed_dest(page_table, tok_slot, pos, st.page_size,
                               num_pages)
            if st.mega:
                x = st._mega_layers(params, x, pools, page_table, q_lens,
                                    pos, q_rows, slot_c, dest)
            else:
                x = st._per_op_layers(params, x, pools, page_table, q_lens,
                                      pos, q_rows, slot_c, dest, active)
            x = _srv_ln(x, params["lnf_g"], params["lnf_b"], eps)
            nxt = _srv_logits(params, x).float().argmax(-1).to(torch.int32)
            ids = torch.where(active, nxt, ids)
            drafts.append(torch.where(active, nxt, 0))
        return (torch.stack(drafts, 1),) + tuple(pools)


def build_draft_chain(config: GPTConfig, draft_layers: int, page_size: int,
                      k: int, kv_quant: bool = False, mesh=None,
                      mega: bool = False, device=None) -> DraftChain:
    """The whole k-step draft proposal as ONE program (reference
    ``build_draft_chain``): ``fn(params, first_toks [b], steps [b],
    kv_lens [b], *pools, page_table) -> (drafts [b, k], *pools)``, the
    pools updated in place; see :meth:`DraftChain.eager`. ``mega=True``
    runs each chain step's layers through the mega kernels (validated as
    :func:`build_unified_step` validates them). ``mesh`` raises."""
    cfg = draft_config(config, draft_layers)
    k = int(k)
    if k < 1:
        raise ValueError(f"draft chain length k must be >= 1, got {k}")
    if mesh is not None:
        raise NotImplementedError("build_draft_chain: multi-GPU "
                                  "(tensor-parallel) serving is a later "
                                  "port slice")
    if mega:
        _check_mega(cfg, device)
    return DraftChain(cfg, page_size, k, kv_quant=kv_quant, mega=mega)


# ---------------------------------------------------------------------------
# the legacy two-program path
# ---------------------------------------------------------------------------


def _legacy_refusals(config: GPTConfig, name: str, mesh) -> None:
    if config.moe_experts:
        raise ValueError(
            f"{name} predates the packed unified step and has no MoE FFN "
            "path — serve moe_experts > 0 through build_unified_step / "
            "ServingPredictor")
    if mesh is not None:
        raise NotImplementedError(
            f"{name}: multi-GPU (tensor-parallel) serving is a later port "
            "slice")


class PrefillProgram:
    """What :func:`build_prefill` returns. ``trace_count`` counts the
    distinct prompt-bucket shapes it has run: the reference compiles one
    executable per bucket; PyTorch runs eagerly and compiles none, so the
    count is the port's form of the same number."""

    def __init__(self, config, page_size):
        self.config = config
        self.page_size = int(page_size)
        self._shapes: set[tuple[int, int]] = set()

    @property
    def trace_count(self) -> int:
        return len(self._shapes)

    @torch.no_grad()
    def __call__(self, params, ids, lengths, k_pool, v_pool, pages):
        """``ids [b, s]`` right-padded prompts, ``lengths [b]``, pools
        ``[L, num_pages + 1, page_size, kv_heads, head_dim]`` (spare page
        last), ``pages [b, pps]`` each slot's page-table row. Forwards the
        prompts with fp32 attention over the causal square, scatters each
        slot's K/V into its pages (in place; positions past the length land
        on the spare page) and returns ``(next_ids [b] int32, logits [b, v]
        fp32, k_pool, v_pool)`` at each prompt's last valid position."""
        cfg = self.config
        b, s = ids.shape
        self._shapes.add((b, s))
        eps, nh, hd = cfg.layer_norm_eps, cfg.num_heads, cfg.head_dim
        # rows [b * s, h]: the serving matmuls take 2-D operands
        x = (params["tok_emb"][ids.long()]
             + params["pos_emb"][:s]).reshape(b * s, -1)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=x.device).tril()
        for i in range(cfg.num_layers):
            p = _layer_params(params["layers"], i)
            y = _srv_ln(x, p["ln1_g"], p["ln1_b"], eps)
            q, k, v = (t.reshape(b, s, nh, hd) for t in _split_qkv(
                _srv_affine(y, p["wqkv"], p["bqkv"]), nh, hd))
            sc = torch.einsum("bqnd,bknd->bnqk", q.float(),
                              k.float()) / math.sqrt(hd)
            sc = torch.where(causal, sc, -1e30)
            a = torch.einsum("bnqk,bknd->bqnd", torch.softmax(sc, dim=-1),
                             v.float()).to(x.dtype)
            x = _srv_attn_out(x, a.reshape(b * s, nh * hd), p)
            x = x + _srv_mlp(p, _srv_ln(x, p["ln2_g"], p["ln2_b"], eps))
            for bi in range(b):
                paged_write_prefill_(k_pool[i], k[bi], pages[bi],
                                     lengths[bi], self.page_size)
                paged_write_prefill_(v_pool[i], v[bi], pages[bi],
                                     lengths[bi], self.page_size)
        x = _srv_ln(x, params["lnf_g"], params["lnf_b"], eps)
        last = (lengths.long() - 1).clamp_min(0)
        h_last = x.reshape(b, s, -1)[torch.arange(b, device=x.device), last]
        logits = _srv_logits(params, h_last).float()
        return logits.argmax(-1).to(torch.int32), logits, k_pool, v_pool


def build_prefill(config: GPTConfig, page_size: int,
                  mesh=None) -> PrefillProgram:
    """The legacy path's prefill program (reference signature ``fn(params,
    ids[b, s], lengths[b], k_pool, v_pool, pages[b, pps]) -> (next_ids[b],
    logits[b, v], k_pool, v_pool)``, the pools updated in place). Its
    attention is plain: the reference uses no kernel there. MoE configs
    raise ``ValueError`` as in the reference; ``mesh`` raises (the
    multi-GPU slice)."""
    _legacy_refusals(config, "build_prefill", mesh)
    return PrefillProgram(config, page_size)


class DecodeStep:
    """What :func:`build_decode_step` returns; ``trace_count`` counts
    builds of this step (one: PyTorch runs eagerly)."""

    def __init__(self, config, page_size):
        self.config = config
        self.page_size = int(page_size)
        self.trace_count = 1

    @torch.no_grad()
    def __call__(self, params, ids, lengths, k_pool, v_pool, page_table):
        """``ids [b]`` each slot's incoming token, ``lengths [b]`` tokens
        already cached (0 = empty slot: its lane computes masked values and
        writes only the spare page), pools ``[L, num_pages + 1, ...]``
        (spare page last), ``page_table [b, pps]``. Per layer: LN, QKV, the
        token's K/V written at position ``lengths`` (in place), paged
        attention over ``lengths + 1`` positions (the decode kernel on a
        CUDA tensor: one launch a layer), output projection, LN, MLP. Returns
        ``(next_ids [b] int32, logits [b, v] fp32, k_pool, v_pool)``."""
        cfg = self.config
        eps, nh, hd = cfg.layer_norm_eps, cfg.num_heads, cfg.head_dim
        b = ids.shape[0]
        num_pages = k_pool.shape[1] - 1
        active = lengths > 0
        pos = torch.where(active, lengths, -1)
        pos_emb = params["pos_emb"]
        x = params["tok_emb"][ids.long().clamp_min(0)] \
            + pos_emb[lengths.long().clamp(0, pos_emb.shape[0] - 1)]
        ctx = torch.where(active, lengths + 1, 0).to(torch.int32)
        for i in range(cfg.num_layers):
            p = _layer_params(params["layers"], i)
            y = _srv_ln(x, p["ln1_g"], p["ln1_b"], eps)
            q, k, v = _split_qkv(_srv_affine(y, p["wqkv"], p["bqkv"]),
                                 nh, hd)
            paged_write_tokens_(k_pool[i], k, page_table, pos,
                                self.page_size)
            paged_write_tokens_(v_pool[i], v, page_table, pos,
                                self.page_size)
            a = paged_attention(q.contiguous(), k_pool[i, :num_pages],
                                v_pool[i, :num_pages], page_table, ctx)
            x = _srv_attn_out(x, a.reshape(b, nh * hd), p)
            x = x + _srv_mlp(p, _srv_ln(x, p["ln2_g"], p["ln2_b"], eps))
        x = _srv_ln(x, params["lnf_g"], params["lnf_b"], eps)
        logits = _srv_logits(params, x).float()
        return logits.argmax(-1).to(torch.int32), logits, k_pool, v_pool


def build_decode_step(config: GPTConfig, page_size: int,
                      mesh=None) -> DecodeStep:
    """The legacy path's fixed-shape decode step (reference signature
    ``fn(params, ids[b], lengths[b], k_pool, v_pool, page_table[b, pps])
    -> (next_ids[b], logits[b, v], k_pool, v_pool)``, the pools updated in
    place). Quantized weight leaves run the weight-only GEMM. MoE configs
    raise ``ValueError`` as in the reference; ``mesh`` raises (the
    multi-GPU slice)."""
    _legacy_refusals(config, "build_decode_step", mesh)
    return DecodeStep(config, page_size)
