"""Weight-only quantization ops — port of ``paddle_tpu/nn/quant``.

Symmetric int8 / int4 quantization of ``[in, out]`` weights with
per-output-channel (``group_size = -1``) or per-group scales along the
in-dim, and the GEMMs that keep the weight quantized on the device
(``ops/quant_matmul.py``, and ``ops/grouped_matmul.py`` for expert stacks:
the hand-written kernels on a CUDA tensor, their plain versions on a CPU
tensor). int4 values are nibble-packed two per byte
in the split-half layout of :func:`~paddle_tpu_torch.ops.quant_matmul
.pack_int4`. Functions take and return plain tensors (no Tensor facade).
"""
from __future__ import annotations

import torch

from ...ops.grouped_matmul import grouped_matmul as _gmm
from ...ops.quant_matmul import pack_int4, unpack_int4
from ...ops.quant_matmul import quant_matmul as _qmm

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "quant_matmul", "grouped_matmul"]


def _qmax(algo: str) -> float:
    return 127.0 if algo in ("weight_only_int8", "llm.int8") else 7.0


def _is_int4(algo: str) -> bool:
    return algo == "weight_only_int4"


def _weight_quantize_fn(w, qmax, int4, group_size):
    """The quantizer body over ``w [..., K, N]`` (leading dims batch, as the
    reference ``jax.vmap``s it over layer stacks): fp32 absmax per output
    column (per group of ``group_size`` in-dim rows), ``scale =
    max(absmax, 1e-8) / qmax``, ``q = clip(round_half_even(w / scale))``
    against the fp32 scale; the scale is returned in ``w``'s dtype."""
    k, n = w.shape[-2], w.shape[-1]
    lead = w.shape[:-2]
    wf = w.to(torch.float32)
    if group_size in (-1, None, 0):
        absmax = wf.abs().amax(dim=-2)                       # [..., N]
        scale = absmax.clamp_min(1e-8) / qmax
        q = torch.round(wf / scale[..., None, :]).clamp(-qmax, qmax)
    else:
        if k % group_size:
            raise ValueError(
                f"in-dim {k} not divisible by group_size {group_size}")
        wf = wf.reshape(*lead, k // group_size, group_size, n)
        absmax = wf.abs().amax(dim=-2)                       # [..., g, N]
        scale = absmax.clamp_min(1e-8) / qmax
        q = torch.round(wf / scale[..., None, :]).clamp(-qmax, qmax)
        q = q.reshape(*lead, k, n)
    q = q.to(torch.int8)
    if int4:
        q = pack_int4(q)
    return q, scale.to(w.dtype)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Symmetric quantization of a ``[in, out]`` weight: ``(int8 [in, out],
    scales)`` for int8, ``(packed int8 [in/2, out], scales)`` for int4;
    scales ``[out]`` (``group_size = -1``) or ``[in / group_size, out]``,
    in ``x``'s dtype."""
    return _weight_quantize_fn(x, _qmax(algo), _is_int4(algo), group_size)


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype=None):
    """The fp weight back from ``(quantized, scales)`` — int4 unpacks
    first; computed in fp32, returned in ``out_dtype`` (default: the
    scales' dtype)."""
    q = unpack_int4(x) if _is_int4(algo) else x
    k = q.shape[0]
    s2 = scale.reshape(1, -1) if scale.dim() == 1 else scale
    out = q.to(torch.float32) * s2.to(torch.float32).repeat_interleave(
        k // s2.shape[0], dim=0)
    return out.to(scale.dtype if out_dtype is None else out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``y = x @ dequant(weight) + bias`` with the weight staying int8
    (``[in, out]``) or packed int4 (``[in/2, out]``) — the packing is read
    off the weight's shape."""
    return _qmm(x, weight, weight_scale, bias=bias)


def quant_matmul(x, qweight, scales, bias=None):
    """The weight-only GEMM as a standalone op; see
    :func:`paddle_tpu_torch.ops.quant_matmul.quant_matmul`."""
    return _qmm(x, qweight, scales, bias=bias)


def grouped_matmul(x, weights, group_offsets, scales=None):
    """The ragged grouped GEMM of the MoE expert path; see
    :func:`paddle_tpu_torch.ops.grouped_matmul.grouped_matmul`."""
    return _gmm(x, weights, group_offsets, scales=scales)
