"""``paddle.incubate.nn.functional`` — the fused MLP-block functions and
the serving kernels' entries.

Port of the part of ``paddle_tpu/incubate/nn/functional.py`` that has a
kernel in the port, with the reference's signatures, on plain tensors:

- :func:`fused_layer_norm`, :func:`fused_ln_residual` and
  :func:`fused_bias_gelu` (what the eager ``GPTForCausalLM`` takes with
  ``fused_mlp=True``) route to ``ops/fused_mlp.py``, differentiable;
  ``use_pallas`` keeps the reference's name for ``use_kernel``;
- :func:`paged_attention`, :func:`ragged_paged_attention`,
  :func:`quant_matmul` and :func:`grouped_matmul` route to their ops in
  ``ops/`` (the attention entries are decode-only: no gradient).

``use_kernel`` / ``use_pallas``: None or True = the hand-written kernel
on a CUDA tensor and its plain version on a CPU tensor; False = the plain
version on either.
"""
from __future__ import annotations

import torch

from ...ops import fused_mlp as _fm
from ...ops import grouped_matmul as _gm
from ...ops import paged_attention as _pa
from ...ops import quant_matmul as _qm

__all__ = ["fused_layer_norm", "fused_ln_residual", "fused_bias_gelu",
           "paged_attention", "ragged_paged_attention", "quant_matmul",
           "grouped_matmul"]


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, use_pallas=None, **kw):
    """LayerNorm over the last axis with fp32 statistics. With both the
    weight and the bias, the fused kernel (forward and backward); without
    one of them, the plain composite: normalize in fp32, cast to x's dtype,
    then scale and shift in that dtype."""
    if norm_weight is not None and norm_bias is not None:
        return _fm.fused_layer_norm(x, norm_weight, norm_bias, eps=epsilon,
                                    use_kernel=use_pallas)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if norm_weight is not None:
        y = y * norm_weight
    if norm_bias is not None:
        y = y + norm_bias
    return y


def fused_ln_residual(x, residual, norm_weight, norm_bias, epsilon=1e-5,
                      use_pallas=None):
    """``s = x + residual; y = LN(s)`` in one kernel; returns ``(y, s)``,
    s being the residual stream for the following branch."""
    return _fm.fused_ln_residual(x, residual, norm_weight, norm_bias,
                                 eps=epsilon, use_kernel=use_pallas)


def fused_bias_gelu(x, bias=None, use_pallas=None):
    """``gelu(x + bias)`` with the tanh approximation in one kernel: the
    epilogue of the GEMM that produced ``x``."""
    return _fm.fused_bias_gelu(x, bias, use_kernel=use_pallas)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None,
                    use_kernel=None):
    """Single-token decode attention over the paged KV cache: ``q [b,
    num_q_heads, head_dim]`` attends its slot's ``seq_lens`` cached
    positions read through ``page_table [b, pages_per_slot]`` from the
    pools ``[num_pages, page_size, kv_heads, head_dim]`` (0 = empty slot
    -> zeros). Not differentiable."""
    if use_kernel is False:
        with torch.no_grad():
            return _pa.paged_attention_reference(q, k_pages, v_pages,
                                                 page_table, seq_lens,
                                                 scale=scale)
    return _pa.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                               scale=scale)


def ragged_paged_attention(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                           scale=None, use_kernel=None, k_scales=None,
                           v_scales=None):
    """Ragged prefill + decode attention over the paged KV cache: each slot
    feeds ``q_lens`` (0..chunk) query rows of ``q [b, chunk, num_q_heads,
    head_dim]``, causal within the chunk, over its ``kv_lens`` cached
    positions (chunk included); int8 pools take fp32 ``k_scales`` /
    ``v_scales [num_pages, page_size, kv_heads]``. Not differentiable."""
    with torch.no_grad():
        if use_kernel is False:
            return _pa.ragged_paged_attention_reference(
                q, k_pages, v_pages, page_table, kv_lens, q_lens,
                scale=scale, k_scales=k_scales, v_scales=v_scales)
        return _pa.ragged_paged_attention(
            q, k_pages, v_pages, page_table, kv_lens, q_lens, scale=scale,
            k_scales=k_scales, v_scales=v_scales)


def quant_matmul(x, qweight, scales, bias=None, use_kernel=None):
    """Weight-only quantized GEMM ``y = x @ dequant(qweight) + bias`` with
    ``qweight`` int8 ``[in, out]`` or packed int4 ``[in/2, out]`` and
    per-channel ``[out]`` or per-group ``[groups, out]`` scales."""
    if use_kernel is False:
        return _qm.quant_matmul_reference(x, qweight, scales, bias=bias)
    return _qm.quant_matmul(x, qweight, scales, bias=bias)


def grouped_matmul(x, weights, group_offsets, scales=None, use_kernel=None):
    """Ragged grouped GEMM ``out[i] = x[i] @ dequant(weights)[g(i)]`` over an
    ``[E, K, N]`` expert stack, rows of ``x`` sorted by expert and
    ``group_offsets [E+1]`` marking each expert's rows."""
    return _gm.grouped_matmul(x, weights, group_offsets, scales=scales,
                              use_kernel=False if use_kernel is False
                              else None)
