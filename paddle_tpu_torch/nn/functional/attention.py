"""Attention functionals.

Port of ``paddle_tpu/nn/functional/attention.py``: inputs are paddle's
``[batch, seq, heads, head_dim]`` layout. ``scaled_dot_product_attention``
routes causal, unmasked, dropout-free calls that the built kernels take
(``ops.flash_attention.kernel_takes``: CUDA tensors, head_dim 64 or 128,
fp32 or bf16, ``hq % hkv == 0``) to the hand-written flash kernels
(differentiable: the backward runs the flash backward kernel); everything
else — every CPU call, other head dims and dtypes, masks, dropout,
non-causal — runs :func:`_sdpa_ref`, the torch twin of the JAX
``_sdpa_ref``, as the reference runs it wherever its kernel does not
apply. The TPU's routing thresholds (``_FLASH_MIN_SEQ``, ``s % 128``) are
not carried over: the kernel masks its own ragged tails, and any
threshold waits for a measurement on the card.
"""
from __future__ import annotations

import math

import torch

from ...ops.flash_attention import flash_attention, kernel_takes


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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, generator=None):
    """Inputs ``[batch, seq, heads, head_dim]``. Dropout draws from
    ``generator`` (a ``torch.Generator`` on the inputs' device)."""
    drop = dropout_p if training else 0.0
    if (is_causal and attn_mask is None and drop == 0.0
            and kernel_takes(query, key)):
        return flash_attention(query.contiguous(), key.contiguous(),
                               value.contiguous(), causal=True, scale=scale)
    return _sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal,
                     scale=scale, dropout_p=drop, generator=generator)
