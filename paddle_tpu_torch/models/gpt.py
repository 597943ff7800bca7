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
  CUDA tensor), output projection, LN, MLP — then the greedy / sampling
  epilogue.

Linear weights keep the JAX layout ``[in, out]`` (``y = x @ W + b``), so
weights cross from the reference without a transpose.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .._device import resolve_device
from ..inference.kv_cache import (packed_dest, paged_copy_pages_,
                                  paged_write_packed_)
from ..nn import functional as F
from ..nn.functional.attention import _sdpa_ref
from ..ops.paged_attention import ragged_paged_attention


@dataclass
class GPTConfig:
    """Same fields and defaults as the reference ``GPTConfig``. Fields for
    paths not ported yet (fused MLP kernels, TP, recompute, quantized
    weights or KV, speculation, mega kernels, MoE) raise where they would
    change behaviour."""
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
    for field, later in (("moe_experts", "the MoE slice"),
                         ("fused_mlp", "the training slice (fused_mlp "
                                       "kernels)"),
                         ("tensor_parallel", "the multi-GPU slice"),
                         ("recompute", "the training slice")):
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
        h, f = config.hidden_size, config.ffn_size
        self.fc1 = Linear(h, f, device=device, dtype=dtype)
        self.fc2 = Linear(f, h, device=device, dtype=dtype)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.fc2(
            torch.nn.functional.gelu(self.fc1(x), approximate="tanh")))


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer decoder block."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x, attn_mask=None):
        x = x + self.attn(self.ln_1(x), attn_mask=attn_mask)
        return x + self.mlp(self.ln_2(x))


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
    with N(0, initializer_range) weight matrices and embeddings drawn from
    a ``torch.Generator`` seeded with ``seed``; biases zero, LN scales one.
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
                if name.endswith(".weight") and ("ln_" not in name):
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
                        for k, get in _SRV_LAYER_WEIGHTS}
    return params


def _srv_ln(x, g, b, eps):
    """Serving LayerNorm: fp32 statistics and affine, cast back."""
    return torch.nn.functional.layer_norm(
        x.float(), x.shape[-1:], g.float(), b.float(), eps).to(x.dtype)


def _srv_logits(params, h):
    """h [..., hidden] -> logits [..., vocab] (tied head unless lm_head)."""
    if "lm_head" in params:
        return h @ params["lm_head"]
    return h @ params["tok_emb"].T


def _srv_mlp(p, y):
    """[t, h] rows through the tanh-GELU MLP (bias adds fused in addmm)."""
    hidden = torch.nn.functional.gelu(torch.addmm(p["b1"], y, p["w1"]),
                                      approximate="tanh")
    return torch.addmm(p["b2"], hidden, p["w2"])


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
    temperature == 0."""
    v = logits.shape[-1]
    t = temperature.clamp_min(1e-6).float()
    scaled = logits / t[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, v).clamp(1, v).long()
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    keep = scaled >= kth
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_exclusive = probs.cumsum(-1) - probs
    p_active = (top_p > 0.0) & (top_p < 1.0)
    n_keep = (cum_exclusive < top_p[:, None]).sum(-1).clamp_min(1)
    n_keep = torch.where(p_active, n_keep, v).long()
    pth = sorted_desc.gather(1, (n_keep - 1)[:, None])
    keep &= scaled >= pth
    masked = torch.where(keep, scaled, -1e30)
    cdf = torch.softmax(masked, dim=-1).double().cumsum(-1)
    target = u.double()[:, None] * cdf[:, -1:]
    return torch.searchsorted(cdf, target, right=True)[:, 0].clamp_max(v - 1)


class UnifiedStep:
    """The serving step :func:`build_unified_step` returns. Calling it runs
    one step; ``trace_count`` counts builds of this step (one: PyTorch runs
    eagerly; CUDA-graph capture per geometry is a later slice)."""

    def __init__(self, config, page_size, chunk):
        self.config = config
        self.page_size = int(page_size)
        self.chunk = int(chunk)
        self.trace_count = 1

    @torch.no_grad()
    def __call__(self, params, tok_ids, tok_slot, tok_pos, q_lens, kv_lens,
                 last_idx, feedback, prev_toks, emit_mask, produced,
                 k_pool, v_pool, page_table, cow_src, cow_dst, lane_seeds,
                 temperature, top_k, top_p, *, sample=None):
        """One step over the packed token budget (reference signature, with
        ``lane_seeds [b]`` in place of the threefry ``base_keys``).

        ``k_pool`` / ``v_pool`` are ``[L, num_pages + 1, page_size, kv_heads,
        head_dim]``: page ``num_pages`` is the spare page that padding and
        unallocated writes land in (the reference's ``mode="drop"``). They
        are updated in place (the reference donates them) and returned.
        ``sample``: whether any lane samples (the host knows; ``None``
        reads ``temperature``). ``cow_src = cow_dst = None`` skips the
        copy-on-write lanes (no copy this step). Returns ``(next_toks [b]
        int32, logits [b, v] fp32, k_pool, v_pool)``.
        """
        cfg, chunk, ps = self.config, self.chunk, self.page_size
        eps, nh, hd = cfg.layer_norm_eps, cfg.num_heads, cfg.head_dim
        t, b = tok_ids.shape[0], q_lens.shape[0]
        num_pages = k_pool.shape[1] - 1
        if cow_dst is not None:
            paged_copy_pages_(k_pool, cow_src, cow_dst)
            paged_copy_pages_(v_pool, cow_src, cow_dst)
        valid = tok_slot >= 0
        slot_c = tok_slot.long().clamp(0, b - 1)
        tok_ids = torch.where((feedback > 0) & valid, prev_toks[slot_c],
                              tok_ids)
        pos_c = tok_pos.long().clamp(0, params["pos_emb"].shape[0] - 1)
        x = params["tok_emb"][tok_ids.long().clamp_min(0)] \
            + params["pos_emb"][pos_c]
        ctx = (kv_lens + q_lens).to(torch.int32)
        # packed <-> [b, chunk] block plumbing shared by every layer: each
        # token's row in the flattened [(b + 1) * chunk] query block (block
        # b is the dump block for padding tokens) and its page slot
        off_c = (tok_pos - kv_lens[slot_c]).long().clamp(0, chunk - 1)
        q_rows = torch.where(valid, tok_slot.long(), b) * chunk + off_c
        a_rows = slot_c * chunk + off_c
        dest = packed_dest(page_table, tok_slot, tok_pos, ps, num_pages)
        lay = params["layers"]
        for i in range(cfg.num_layers):
            p = {k: w[i] for k, w in lay.items()}
            y = _srv_ln(x, p["ln1_g"], p["ln1_b"], eps)
            q, k_t, v_t = _split_qkv(torch.addmm(p["bqkv"], y, p["wqkv"]),
                                     nh, hd)
            paged_write_packed_(k_pool[i], k_t, dest)
            paged_write_packed_(v_pool[i], v_t, dest)
            qb = q.new_zeros(((b + 1) * chunk, nh, hd))
            qb[q_rows] = q
            ab = ragged_paged_attention(
                qb[:b * chunk].view(b, chunk, nh, hd), k_pool[i, :num_pages],
                v_pool[i, :num_pages], page_table, ctx, q_lens)
            a = ab.reshape(b * chunk, nh * hd)[a_rows]  # back to packed [t]
            x = x + torch.addmm(p["bo"], a, p["wo"])
            x = x + _srv_mlp(p, _srv_ln(x, p["ln2_g"], p["ln2_b"], eps))
        x = _srv_ln(x, params["lnf_g"], params["lnf_b"], eps)
        h_last = x[last_idx.long().clamp(0, t - 1)]
        logits = _srv_logits(params, h_last).float()
        next_ids = logits.argmax(-1)
        if sample is None:
            sample = bool((temperature > 0).any())
        if sample:
            u = lane_uniform(lane_seeds, produced)
            sampled = _sample_epilogue(logits, u, temperature, top_k, top_p)
            next_ids = torch.where(temperature > 0, sampled, next_ids)
        next_toks = torch.where(emit_mask > 0, next_ids.to(torch.int32),
                                prev_toks)
        return next_toks, logits, k_pool, v_pool


def build_unified_step(config: GPTConfig, page_size: int, chunk: int,
                       kv_quant: bool = False, mesh=None, spec_k: int = 0,
                       mega: bool = False) -> UnifiedStep:
    """The unified serving step on its per-op path: fp KV, one device,
    no speculation, no mega kernels (each raises, naming its slice). The
    step runs the ragged kernel when its tensors are on a CUDA device and
    the plain version when they are on the CPU."""
    for flag, later in ((kv_quant, "quantized-KV serving"),
                        (mesh is not None, "multi-GPU (tensor-parallel) "
                                           "serving"),
                        (spec_k, "speculative decoding"),
                        (mega, "mega-kernel serving")):
        if flag:
            raise NotImplementedError(
                f"build_unified_step: {later} is a later port slice")
    for field in ("moe_experts", "weight_dtype", "kv_cache_dtype"):
        if getattr(config, field):
            raise NotImplementedError(
                f"build_unified_step: GPTConfig.{field} is not ported yet")
    return UnifiedStep(config, page_size, chunk)
