"""Flash attention forward — the full-forward attention kernel.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` (forward only): the
public layout is paddle's ``[batch, seq, heads, head_dim]``; causal
masking is aligned bottom-right (row ``r`` sees keys ``<= r + sk - sq``);
GQA reads kv head ``h // group``; rows that see no key give zeros and
``lse = LSE_INVALID``. ``lse`` is ``[batch * hq, 1, sq]`` fp32, the shape
``_flash_fwd_impl`` returns.

On a CUDA tensor the wrappers launch the hand-written kernel of
``csrc/flash_attention_fwd.cu`` (or raise); on a CPU tensor they run
:func:`flash_attention_reference`. The additive ``mask`` and the varlen
``q_seqlens`` / ``kv_seqlens`` branches, and the backward, are later
slices and raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
LSE_INVALID = 1e30
_KERNEL = "flash_attention_fwd"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_flash_fwd": [_P] * 5 + [_I] * 6
    + [ctypes.c_float, _I, _I, _I, _P],
    "ptt_flash_smem_bytes": [_I],
}


def smem_bytes(d: int) -> int:
    """Dynamic shared memory one block of the kernel uses at head_dim
    ``d`` (builds the kernel on first use)."""
    return _build.load(_KERNEL, _SIGNATURES).ptt_flash_smem_bytes(d)


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Dense twin of the kernel: fp32 scores masked with ``NEG_INF``,
    softmax, rows that see no key zeroed with ``lse = LSE_INVALID``.
    Returns ``(out [b, sq, hq, d] in q's dtype, lse [b*hq, 1, sq] fp32)``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = hq // hkv
    qh = q.float().transpose(1, 2)                              # [b,hq,sq,d]
    kh = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = (qh @ kh.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device).reshape(-1, 1)
        cols = torch.arange(sk, device=q.device).reshape(1, -1)
        s = torch.where(cols <= rows + (sk - sq), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    invalid = (m <= NEG_INF * 0.5) | (l == 0.0)
    l_safe = torch.where(invalid, 1.0, l)
    out = torch.where(invalid, 0.0, (p @ vh) / l_safe)
    lse = torch.where(invalid, LSE_INVALID, m + torch.log(l_safe))
    return (out.transpose(1, 2).to(q.dtype),
            lse.reshape(b * hq, 1, sq))


def _launch_cuda(q, k, v, causal, scale):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    code = _build.dtype_code(q.dtype, "flash attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k, v must share one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention: q, k, v must be 16-byte aligned "
                         "(the kernel loads 16-byte rows)")
    if d not in (64, 128):
        raise NotImplementedError(
            f"flash attention kernel is built for head_dim 64 or 128, "
            f"got {d}")
    lib = _build.load(_KERNEL, _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((b * hq, 1, sq), dtype=torch.float32, device=q.device)
    err = lib.ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, sq, sk, d, float(scale), int(causal),
        code, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash attention launch")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """``(out, lse)`` for ``[batch, seq, heads, head_dim]`` inputs: the
    kernel on a CUDA tensor (``.launches`` counts it), the reference on a
    CPU tensor."""
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"GQA needs q heads {hq} divisible by kv heads "
                         f"{k.shape[2]}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _launch_cuda(q, k, v, causal, scale)


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal=False, scale=None, mask=None,
                    q_seqlens=None, kv_seqlens=None):
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs;
    returns ``out`` only, like the JAX entry."""
    if mask is not None:
        raise NotImplementedError(
            "flash attention with an additive mask is a later port slice")
    if q_seqlens is not None or kv_seqlens is not None:
        raise NotImplementedError(
            "varlen flash attention (q_seqlens/kv_seqlens) is a later port "
            "slice")
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
