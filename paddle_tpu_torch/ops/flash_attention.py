"""Flash attention, forward and backward — the attention kernels of the
full forward and of the training step.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``: the public layout is
paddle's ``[batch, seq, heads, head_dim]``; causal masking is aligned
bottom-right (row ``r`` sees keys ``<= r + sk - sq``); GQA reads kv head
``h // group``; rows that see no key give zeros and ``lse = LSE_INVALID``.
``lse`` and ``delta`` are ``[batch * hq, 1, sq]`` fp32, the shapes
``_flash_fwd_impl`` / ``flash_bwd_impl`` use.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` (or
raise): bf16 on the tensor cores at head_dim 32, 64, 80, 96 and 128 (the
widths of the reference's ``GPT_CONFIGS``), fp32 on the CUDA cores at 64
and 128 (tensor cores would make it TF32). On a CPU tensor they run
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`.
The bf16 forward kernel rounds ``p`` to bf16 before ``p v`` per key tile, as
the reference's kernel does; the dense twin keeps ``p`` in fp32.
:func:`flash_attention` is differentiable on both: one custom op
(``paddle_tpu_torch::flash_attention``) whose forward runs the forward
wrapper and saves ``(q, k, v, out, lse)``,
and whose backward forms ``delta = rowsum(do * out)`` in fp32 and runs the
backward wrapper. Being one op, selective activation checkpointing can keep
its ``out`` and ``lse`` (``models/gpt_spmd.py``, ``remat_save_attn``). The
additive ``mask`` and the varlen ``q_seqlens`` / ``kv_seqlens`` branches are
later slices and raise. :func:`kernel_takes` says, before any launch,
whether the built kernels take a call; the callers route the rest to plain
attention.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
LSE_INVALID = 1e30
# the built instantiations, by dtype (the C entries' dtype codes)
HEAD_DIMS = {torch.float32: (64, 128),
             torch.bfloat16: (32, 64, 80, 96, 128)}
_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_flash_fwd": [_P] * 5 + [_I] * 6
    + [ctypes.c_float, _I, _I, _I, _P],
    "ptt_flash_smem_bytes": [_I, _I],
}
_BWD_SIGNATURES = {
    "ptt_flash_bwd": [_P] * 9 + [_I] * 6
    + [ctypes.c_float, _I, _I, _I, _P],
    "ptt_flash_bwd_smem_bytes": [_I, _I],
}


def smem_bytes(d: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one block of the forward kernel uses at
    head_dim ``d`` in ``dtype`` (builds the kernel on first use)."""
    return _build.load(_KERNEL, _SIGNATURES).ptt_flash_smem_bytes(
        d, _build.dtype_code(dtype, "flash attention"))


def bwd_smem_bytes(d: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one block of the backward kernel uses at
    head_dim ``d`` in ``dtype`` (builds the kernel on first use)."""
    return _build.load(_BWD_KERNEL, _BWD_SIGNATURES).ptt_flash_bwd_smem_bytes(
        d, _build.dtype_code(dtype, "flash attention"))


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


def kernel_takes(q, k) -> bool:
    """Whether the built kernels run attention of ``q [b, sq, hq, d]``
    over ``k [b, sk, hkv, d]``: CUDA tensors, a dtype of
    :data:`HEAD_DIMS` with head_dim among its widths, ``hq % hkv == 0``.
    Decided from shape, dtype and device alone, before any launch."""
    return (q.device.type == "cuda" and k.device == q.device
            and q.shape[-1] in HEAD_DIMS.get(q.dtype, ())
            and k.dtype == q.dtype and q.shape[2] % k.shape[2] == 0)


def _check_cuda_inputs(q, *rest):
    """The kernels' common demands on q, k, v (and do): one dtype they
    take, one device, contiguous, 16-byte aligned, a head_dim built for
    that dtype (:data:`HEAD_DIMS`). Returns the dtype code."""
    code = _build.dtype_code(q.dtype, "flash attention")
    d = q.shape[3]
    if any(t.dtype != q.dtype for t in rest):
        raise TypeError(f"flash attention: input dtypes differ: "
                        f"{[q.dtype] + [t.dtype for t in rest]}")
    if any(t.device != q.device for t in rest):
        raise ValueError("flash attention: inputs must share one device")
    if not all(t.is_contiguous() for t in (q, *rest)):
        raise ValueError("flash attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, *rest)):
        raise ValueError("flash attention: inputs must be 16-byte aligned "
                         "(the kernels load 16-byte rows)")
    if d not in HEAD_DIMS[q.dtype]:
        raise NotImplementedError(
            f"flash attention kernels are built for head_dim "
            f"{HEAD_DIMS[q.dtype]} in {q.dtype}, got {d}")
    return code


def _launch_cuda(q, k, v, causal, scale):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    code = _check_cuda_inputs(q, k, v)
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


def _check_shapes(q, k, v):
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"GQA needs q heads {hq} divisible by kv heads "
                         f"{k.shape[2]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{q.device}")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """``(out, lse)`` for ``[batch, seq, heads, head_dim]`` inputs: the
    kernel on a CUDA tensor (``.launches`` counts it), the reference on a
    CPU tensor."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    return _launch_cuda(q, k, v, causal, scale)


flash_attention_fwd.launches = 0


def flash_attention_bwd_reference(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """Dense twin of the backward kernel, with the Pallas kernel's casts:
    ``s = scale q k^T`` from the inputs' values in fp32, masked
    bottom-right with ``NEG_INF``; ``p = exp(s - lse)`` (0 on rows whose
    lse is ``LSE_INVALID``); ``dv = p^T do`` with ``p`` rounded to ``do``'s
    dtype; ``dp = do v^T``; ``ds = p (dp - delta)`` rounded to ``q``'s
    dtype; ``dk = scale ds^T q``; ``dq = scale ds k``. GQA sums dk and dv
    over each group in fp32. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes and layouts."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = hq // hkv
    qh = q.float().transpose(1, 2)                              # [b,hq,sq,d]
    kh = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    doh = do.float().transpose(1, 2)
    s = scale * (qh @ kh.transpose(-1, -2))
    if causal:
        rows = torch.arange(sq, device=q.device).reshape(-1, 1)
        cols = torch.arange(sk, device=q.device).reshape(1, -1)
        s = torch.where(cols <= rows + (sk - sq), s, NEG_INF)
    p = torch.exp(s - lse.reshape(b, hq, sq, 1))
    pc = p.to(do.dtype).float()
    dv = pc.transpose(-1, -2) @ doh                             # [b,hq,sk,d]
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - delta.reshape(b, hq, sq, 1))).to(q.dtype).float()
    dk = scale * (ds.transpose(-1, -2) @ qh)
    dq = scale * (ds @ kh)
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _launch_bwd_cuda(q, k, v, do, lse, delta, causal, scale):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    code = _check_cuda_inputs(q, k, v, do)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != (b * hq, 1, sq) or not t.is_contiguous()):
            raise ValueError(
                f"flash attention backward: {name} must be a contiguous fp32 "
                f"[{b * hq}, 1, {sq}] tensor on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load(_BWD_KERNEL, _BWD_SIGNATURES)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.ptt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, hq, hkv, sq, sk, d, float(scale), int(causal),
        code, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash attention backward launch")
    flash_attention_bwd.launches += 1
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, causal=False, scale=None):
    """``(dq, dk, dv)`` from the forward's ``lse`` and ``delta = rowsum(do *
    out)`` (both ``[batch * hq, 1, sq]`` fp32): the kernel on a CUDA tensor
    (``.launches`` counts it; dq is summed with fp32 atomics, so it is not
    bit-deterministic), the reference on a CPU tensor."""
    _check_shapes(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             causal=causal, scale=scale)
    return _launch_bwd_cuda(q, k, v, do, lse, delta, causal, scale)


flash_attention_bwd.launches = 0


@torch.library.custom_op("paddle_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(out, lse)``: :func:`flash_attention_fwd` forward,
    :func:`flash_attention_bwd` backward (``lse`` gets no gradient)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)


def _op_setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _op_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    b, sq, hq, _ = q.shape
    dout = dout.contiguous()
    # delta = rowsum(do * out) in fp32, outside the kernel as in the
    # reference's _flash_bwd
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.reshape(b * hq, 1, sq).contiguous()
    dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, delta,
                                     causal=ctx.causal, scale=ctx.scale)
    return dq, dk, dv, None, None


flash_attention_op.register_autograd(_op_backward,
                                     setup_context=_op_setup_context)


def flash_attention(q, k, v, causal=False, scale=None, mask=None,
                    q_seqlens=None, kv_seqlens=None):
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs;
    returns ``out`` only, like the JAX entry, and is differentiable (the
    backward kernel on a CUDA tensor, its twin on a CPU tensor)."""
    if mask is not None:
        raise NotImplementedError(
            "flash attention with an additive mask is a later port slice")
    if q_seqlens is not None or kv_seqlens is not None:
        raise NotImplementedError(
            "varlen flash attention (q_seqlens/kv_seqlens) is a later port "
            "slice")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return flash_attention_op(q, k, v, bool(causal), float(scale))[0]
