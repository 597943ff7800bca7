"""``paddle.incubate.nn.functional`` — the fused MLP-block functions.

Port of the part of ``paddle_tpu/incubate/nn/functional.py`` that the
eager ``GPTForCausalLM`` takes with ``fused_mlp=True``:
:func:`fused_layer_norm`, :func:`fused_ln_residual` and
:func:`fused_bias_gelu`, with the reference's signatures, on plain
tensors. Each routes to ``ops/fused_mlp.py``: the hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor, differentiable on both.
``use_pallas`` keeps the reference's name for ``use_kernel`` (None or True
= the kernel path, False = the plain reference).
"""
from __future__ import annotations

import torch

from ...ops import fused_mlp as _fm

__all__ = ["fused_layer_norm", "fused_ln_residual", "fused_bias_gelu"]


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
