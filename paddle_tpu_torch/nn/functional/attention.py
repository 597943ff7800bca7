"""Attention functionals.

Port of ``paddle_tpu/nn/functional/attention.py``: inputs are paddle's
``[batch, seq, heads, head_dim]`` layout. ``scaled_dot_product_attention``
routes dropout-free calls that the built kernels take
(``ops.flash_attention.kernel_takes``: CUDA tensors, bf16 or fp16 at
head_dim 32, 64, 80, 96 or 128, fp32 at 64 or 128, ``hq % hkv == 0``) to the
hand-written flash kernels, causal or not, with no mask or with one whose
normalized shape streams into them (``mask_kernel_compatible``: ``[1|b,
1|hq, 1|sq, sk]``), as the reference routes them to its kernel
(differentiable: the backward runs the flash backward kernel). Everything
else — every CPU call, other head dims and dtypes, masks of other shapes,
dropout — runs :func:`_sdpa_ref`, the torch twin of the JAX ``_sdpa_ref``,
as the reference runs it wherever its kernel does not apply; so does every
call inside :func:`plain_attention`. The TPU's routing thresholds
(``_FLASH_MIN_SEQ``, ``s % 128``) are not carried over: the kernel masks
its own ragged tails, and any threshold waits for a measurement on the
card.

``flash_attn_unpadded`` is the varlen entry: packed ``[total, heads,
head_dim]`` tokens with cumulative lengths. Where the kernels take the
call it scatters them into ``[b, max_seqlen, heads, head_dim]``, runs the
flash kernels with per-sequence lengths and gathers the rows back;
elsewhere (the CPU included) it runs :func:`_unpadded_ref`, the reference's
segment-masked fallback. Under ``causal`` the kernel aligns each sequence
bottom-right and the fallback top-left: they agree where a sequence's q
and k lengths are equal, as in self-attention.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from ...ops.flash_attention import (flash_attention, kernel_takes,
                                    lift_mask_shape, mask_kernel_compatible)


def _sdpa_ref(q, k, v, mask=None, causal=False, scale=None, dropout_p=0.0,
              generator=None):
    """Reference attention over ``[B, S, H, D]``: scores in the input
    dtype, softmax in fp32 with causal entries at ``-1e30`` (bottom-right
    aligned), probabilities cast back to the input dtype."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kh.shape[1] != qh.shape[1]:  # GQA: repeat kv heads
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = ((qh @ kh.transpose(-1, -2)) * s).float()
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = torch.where(keep, logits, -1e30)
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0
                            ).to(q.dtype)
    return (probs @ vh).transpose(1, 2)


def _mask_streams(attn_mask, query, key) -> bool:
    """Whether ``attn_mask``, lifted to 4-D as the reference lifts it,
    streams into the kernels."""
    return mask_kernel_compatible(lift_mask_shape(attn_mask.shape),
                                  query.shape[0], query.shape[2],
                                  query.shape[1], key.shape[1])


_PLAIN = contextvars.ContextVar("plain_attention", default=False)


@contextlib.contextmanager
def plain_attention():
    """Within the block, :func:`scaled_dot_product_attention` runs
    :func:`_sdpa_ref` on every call: the oracle a model's kernel route is
    held against, without a model option. A backward runs the route its
    forward took."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, generator=None):
    """Inputs ``[batch, seq, heads, head_dim]``. Dropout draws from
    ``generator`` (a ``torch.Generator`` on the inputs' device)."""
    drop = dropout_p if training else 0.0
    if (drop == 0.0 and not _PLAIN.get() and kernel_takes(query, key)
            and (attn_mask is None or _mask_streams(attn_mask, query, key))):
        return flash_attention(query.contiguous(), key.contiguous(),
                               value.contiguous(), causal=is_causal,
                               scale=scale, mask=attn_mask)
    return _sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal,
                     scale=scale, dropout_p=drop, generator=generator)


def _segments(cu, total):
    """(sequence, position within it) of each of ``total`` packed tokens
    under the cumulative lengths ``cu [b + 1]``."""
    idx = torch.arange(total, device=cu.device)
    seg = torch.searchsorted(cu, idx, right=True) - 1
    return seg, idx - cu[seg]


def _unpadded_ref(q, k, v, cu_q, cu_k, scale=None, causal=False):
    """The reference's segment-masked fallback over packed ``[total, h,
    d]`` tokens: a query attends the keys of its own sequence (under
    ``causal`` those at or before its position), scores in the input
    dtype, softmax in fp32, probabilities cast back."""
    seg_q, pos_q = _segments(cu_q, q.shape[0])
    seg_k, pos_k = _segments(cu_k, k.shape[0])
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = (torch.einsum("qhd,khd->hqk", q, k) * s).float()
    same = seg_q[:, None] == seg_k[None, :]
    if causal:
        same = same & (pos_k[None, :] <= pos_q[:, None])
    logits = torch.where(same[None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


def _unpadded_flash(q, k, v, cu_q, cu_k, max_seqlen_q, max_seqlen_k,
                    scale=None, causal=False):
    """The kernel route of :func:`flash_attn_unpadded`: scatter into
    ``[b, max_seqlen, h, d]`` (zeros past each length), flash attention
    with per-sequence lengths, gather the packed rows back. On CPU tensors
    the flash wrappers run their plain versions."""
    b, d = cu_q.shape[0] - 1, q.shape[-1]
    seg_q, pos_q = _segments(cu_q, q.shape[0])
    seg_k, pos_k = _segments(cu_k, k.shape[0])

    def pad(x, seg, pos, s):
        return x.new_zeros((b, s, x.shape[1], d)).index_put((seg, pos), x)

    qp = pad(q, seg_q, pos_q, int(max_seqlen_q))
    kp = pad(k, seg_k, pos_k, int(max_seqlen_k))
    vp = pad(v, seg_k, pos_k, int(max_seqlen_k))
    out = flash_attention(qp, kp, vp, causal=causal, scale=scale,
                          q_seqlens=cu_q[1:] - cu_q[:-1],
                          kv_seqlens=cu_k[1:] - cu_k[:-1])
    return out[seg_q, pos_q]


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, training=True):
    """Varlen flash attention over packed ``[total_tokens, heads,
    head_dim]`` with cumulative lengths ``cu_seqlens_* [b + 1]`` (on the
    inputs' device); returns ``(out, None)`` as the reference does. The
    flash kernels where they take the call, the segment-masked
    :func:`_unpadded_ref` elsewhere. ``dropout``, ``return_softmax`` and
    ``training`` are taken and unused, as in the reference."""
    if kernel_takes(query[None], key[None]):
        out = _unpadded_flash(query.contiguous(), key.contiguous(),
                              value.contiguous(), cu_seqlens_q, cu_seqlens_k,
                              max_seqlen_q, max_seqlen_k, scale=scale,
                              causal=causal)
    else:
        out = _unpadded_ref(query, key, value, cu_seqlens_q, cu_seqlens_k,
                            scale=scale, causal=causal)
    return out, None
