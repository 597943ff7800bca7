"""Flash attention, forward and backward — the attention kernels of the
full forward, of the training steps and of the encoders' masked and
varlen attention.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``: the public layout is
paddle's ``[batch, seq, heads, head_dim]``; causal masking is aligned
bottom-right (row ``r`` sees keys ``<= r + sk - sq``); GQA reads kv head
``h // group``; rows that see no key give zeros and ``lse = LSE_INVALID``.
``lse`` and ``delta`` are ``[batch * hq, 1, sq]`` fp32, the shapes
``_flash_fwd_impl`` / ``flash_bwd_impl`` use.

Two optional branches, as in the reference's kernels:

- ``mask``: an additive bias ``[1|b, 1|hq, 1|sq, sk]`` (:func:`flash_attention`
  turns a bool mask into ``0 / NEG_INF`` and lifts 2-D and 3-D masks to
  4-D; :func:`mask_kernel_compatible` says which shapes stream), added in
  fp32 to the scores after the causal mask. It gets no gradient.
- ``lens``: per-sequence ``(q_len, kv_len)``, an int32 ``[2, batch]``
  tensor (built from ``q_seqlens`` / ``kv_seqlens``): keys at ``kv_len`` and
  beyond are masked, causal attention is aligned bottom-right per sequence
  (row ``r`` sees keys ``<= r + kv_len - q_len``), and rows at ``q_len`` and
  beyond give zeros and ``LSE_INVALID``, so they get no gradient.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` (or
raise): bf16 and fp16 on the tensor cores at head_dim 32, 64, 80, 96 and
128 (the widths of the reference's ``GPT_CONFIGS`` and ``BERT_CONFIGS``),
fp32 on the CUDA cores at 64 and 128 (tensor cores would make it TF32); each
instantiated with and without each branch (template flags ``MASK`` and
``LENS``, so the call with neither runs the kernel of before them): the
mask read in fp32 with a stride of 0 on each broadcast dim, lens once a
block. On a CPU tensor they run
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`.
The bf16 and fp16 forward kernels round ``p`` to the input type before ``p
v`` per key tile, as the reference's kernel does; the dense twin keeps
``p`` in fp32. A bool mask normalized in fp16 holds ``-inf`` where bf16
holds ``-1e30``: the kernels and twins then give such keys ``p = 0``, and a
row with no other key zeros and ``LSE_INVALID``, as the reference does.
:func:`flash_attention` is differentiable on both: one custom op
(``paddle_tpu_torch::flash_attention``) whose forward runs the forward
wrapper and saves ``(q, k, v, out, lse)`` with the mask and lens,
and whose backward forms ``delta = rowsum(do * out)`` in fp32 and runs the
backward wrapper. Being one op, selective activation checkpointing can keep
its ``out`` and ``lse`` (``models/gpt_spmd.py``, ``remat_save_attn``).
:func:`kernel_takes` says, before any launch, whether the built kernels
take a call; the callers route the rest to plain attention.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
LSE_INVALID = 1e30
# the built instantiations, by dtype (the C entries' dtype codes)
HEAD_DIMS = {torch.float32: (64, 128),
             torch.bfloat16: (32, 64, 80, 96, 128),
             torch.float16: (32, 64, 80, 96, 128)}
_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the optional branches: mask pointer, its batch / head / row strides in
# elements (0 on a broadcast dim), lens pointer
_BRANCHES = [_P, _L, _L, _L, _P]
_SIGNATURES = {
    "ptt_flash_fwd": [_P] * 5 + _BRANCHES + [_I] * 6
    + [ctypes.c_float, _I, _I, _I, _P],
    "ptt_flash_smem_bytes": [_I, _I],
}
_BWD_SIGNATURES = {
    "ptt_flash_bwd": [_P] * 9 + _BRANCHES + [_I] * 6
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


def mask_kernel_compatible(mask_shape, b, hq, sq, sk) -> bool:
    """Whether a (normalized, 4-D) additive mask streams into the kernels:
    every dim broadcastable (1 or full), except sk which must be full."""
    if len(mask_shape) != 4:
        return False
    mb, mh, msq, msk = mask_shape
    return mb in (1, b) and mh in (1, hq) and msq in (1, sq) and msk == sk


def lift_mask_shape(shape) -> tuple:
    """A mask shape lifted to 4-D as the reference lifts it: ``[sq, sk]``
    -> ``[1, 1, sq, sk]``, ``[b, sq, sk]`` -> ``[b, 1, sq, sk]``; other
    ranks unchanged."""
    shape = tuple(shape)
    if len(shape) == 2:
        return (1, 1) + shape
    if len(shape) == 3:
        return (shape[0], 1) + shape[1:]
    return shape


def normalize_mask(mask, q, sk):
    """The reference's mask normalization: bool -> ``0 / NEG_INF`` in q's
    dtype, 2-D and 3-D masks lifted by :func:`lift_mask_shape`. Raises
    ``ValueError`` for a shape the kernels cannot stream."""
    b, sq, hq, _ = q.shape
    if mask.dtype == torch.bool:
        mask = torch.where(mask, 0.0, NEG_INF).to(q.dtype)
    mask = mask.reshape(lift_mask_shape(mask.shape))
    if not mask_kernel_compatible(tuple(mask.shape), b, hq, sq, sk):
        raise ValueError(
            f"flash_attention: mask shape {tuple(mask.shape)} not supported "
            f"in-kernel (want broadcastable [{{1|{b}}}, {{1|{hq}}}, "
            f"{{1|{sq}}}, {sk}]); use the reference attention path for "
            "other shapes")
    return mask


def seq_lens(q_seqlens, kv_seqlens, b, sq, sk, device):
    """The ``[2, b]`` int32 ``(q_len; kv_len)`` tensor of the varlen branch
    (a missing side is full length), or None when neither is given."""
    if q_seqlens is None and kv_seqlens is None:
        return None

    def side(lens, full):
        if lens is None:
            return torch.full((b,), full, dtype=torch.int32, device=device)
        lens = torch.as_tensor(lens, device=device)
        if tuple(lens.shape) != (b,):
            raise ValueError(f"flash_attention: varlen lengths must be [{b}]"
                             f", got {tuple(lens.shape)}")
        return lens.to(torch.int32)

    return torch.stack([side(q_seqlens, sq), side(kv_seqlens, sk)])


def _scores_masked(s, b, sq, sk, causal, mask, lens):
    """The fp32 scores ``s [b, hq, sq, sk]`` with the kernels' masking:
    causal (bottom-right, per sequence under lens) and keys past kv_len to
    ``NEG_INF``, then the additive mask; plus the ``[b, 1, sq, 1]`` rows at
    or past q_len (None without lens)."""
    dev = s.device
    rows = torch.arange(sq, device=dev).reshape(1, 1, -1, 1)
    cols = torch.arange(sk, device=dev).reshape(1, 1, 1, -1)
    dead_rows = None
    if lens is not None:
        ql = lens[0].long().reshape(b, 1, 1, 1)
        kl = lens[1].long().reshape(b, 1, 1, 1)
        keep = cols < kl
        if causal:
            keep = keep & (cols <= rows + (kl - ql))
        s = torch.where(keep, s, NEG_INF)
        dead_rows = rows >= ql
    elif causal:
        s = torch.where(cols <= rows + (sk - sq), s, NEG_INF)
    if mask is not None:
        s = s + mask.float()
    return s, dead_rows


def flash_attention_reference(q, k, v, causal=False, scale=None, mask=None,
                              lens=None):
    """Dense twin of the kernel: fp32 scores masked with ``NEG_INF``, the
    additive ``mask`` added, softmax; rows that see no key, and rows at or
    past q_len under ``lens``, zeroed with ``lse = LSE_INVALID``.
    Returns ``(out [b, sq, hq, d] in q's dtype, lse [b*hq, 1, sq] fp32)``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    group = hq // hkv
    qh = q.float().transpose(1, 2)                              # [b,hq,sq,d]
    kh = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s, dead_rows = _scores_masked((qh @ kh.transpose(-1, -2)) * scale, b,
                                  sq, sk, causal, mask, lens)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    invalid = (m <= NEG_INF * 0.5) | (l == 0.0)
    if dead_rows is not None:
        invalid = invalid | dead_rows
    l_safe = torch.where(invalid, 1.0, l)
    out = torch.where(invalid, 0.0, (p @ vh) / l_safe)
    lse = torch.where(invalid, LSE_INVALID, m + torch.log(l_safe))
    return (out.transpose(1, 2).to(q.dtype),
            lse.reshape(b * hq, 1, sq))


def kernel_takes(q, k) -> bool:
    """Whether the built kernels run attention of ``q [b, sq, hq, d]``
    over ``k [b, sk, hkv, d]``: CUDA tensors, a dtype of
    :data:`HEAD_DIMS` with head_dim among its widths, ``hq % hkv == 0``.
    Decided from shape, dtype and device alone, before any launch (a mask
    also needs :func:`mask_kernel_compatible`)."""
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


def _branch_args(q, sk, mask, lens):
    """The C entries' optional-branch arguments (mask pointer and strides,
    lens pointer) and the fp32 mask they point into (kept alive by the
    caller until the launch is queued)."""
    b = q.shape[0]
    m = None
    strides = (0, 0, 0)
    if mask is not None:
        m = normalize_mask(mask, q, sk).to(q.device,
                                           torch.float32).contiguous()
        mb, mh, msq, _ = m.shape
        strides = (0 if mb == 1 else mh * msq * sk,
                   0 if mh == 1 else msq * sk, 0 if msq == 1 else sk)
    if lens is not None:
        if (lens.dtype != torch.int32 or tuple(lens.shape) != (2, b)
                or lens.device != q.device or not lens.is_contiguous()):
            raise ValueError(f"flash attention: lens must be a contiguous "
                             f"int32 [2, {b}] tensor on {q.device}, got "
                             f"{lens.dtype} {tuple(lens.shape)} on "
                             f"{lens.device}")
    return m, [None if m is None else m.data_ptr(), *strides,
               None if lens is None else lens.data_ptr()]


def _launch_cuda(q, k, v, causal, scale, mask, lens):
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    code = _check_cuda_inputs(q, k, v)
    m, branches = _branch_args(q, sk, mask, lens)
    lib = _build.load(_KERNEL, _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((b * hq, 1, sq), dtype=torch.float32, device=q.device)
    err = lib.ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *branches, b, hq, hkv, sq, sk, d, float(scale),
        int(causal), code, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash attention launch")
    flash_attention_fwd.launches += 1
    if m is not None:
        flash_attention_fwd.mask_launches += 1
    if lens is not None:
        flash_attention_fwd.lens_launches += 1
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


def flash_attention_fwd(q, k, v, causal=False, scale=None, mask=None,
                        lens=None):
    """``(out, lse)`` for ``[batch, seq, heads, head_dim]`` inputs, with an
    optional normalized 4-D additive ``mask`` and int32 ``lens [2, b]``:
    the kernel on a CUDA tensor (``.launches`` counts it, and
    ``.mask_launches`` / ``.lens_launches`` the launches with each branch),
    the reference on a CPU tensor."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         mask=mask, lens=lens)
    return _launch_cuda(q, k, v, causal, scale, mask, lens)


flash_attention_fwd.launches = 0
flash_attention_fwd.mask_launches = 0
flash_attention_fwd.lens_launches = 0


def flash_attention_bwd_reference(q, k, v, do, lse, delta, causal=False,
                                  scale=None, mask=None, lens=None):
    """Dense twin of the backward kernel, with the Pallas kernel's casts:
    ``s = scale q k^T`` from the inputs' values in fp32, masked as the
    forward (causal and lens with ``NEG_INF``, then the additive mask);
    ``p = exp(s - lse)`` (0 on rows whose lse is ``LSE_INVALID`` and on
    rows at or past q_len); ``dv = p^T do`` with ``p`` rounded to ``do``'s
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
    s, dead_rows = _scores_masked(scale * (qh @ kh.transpose(-1, -2)), b,
                                  sq, sk, causal, mask, lens)
    p = torch.exp(s - lse.reshape(b, hq, sq, 1))
    if dead_rows is not None:
        p = torch.where(dead_rows, 0.0, p)
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


def _launch_bwd_cuda(q, k, v, do, lse, delta, causal, scale, mask, lens):
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
    m, branches = _branch_args(q, sk, mask, lens)
    lib = _build.load(_BWD_KERNEL, _BWD_SIGNATURES)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.ptt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *branches, b, hq, hkv, sq, sk, d, float(scale),
        int(causal), code, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash attention backward launch")
    flash_attention_bwd.launches += 1
    if m is not None:
        flash_attention_bwd.mask_launches += 1
    if lens is not None:
        flash_attention_bwd.lens_launches += 1
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, causal=False, scale=None,
                        mask=None, lens=None):
    """``(dq, dk, dv)`` from the forward's ``lse`` and ``delta = rowsum(do *
    out)`` (both ``[batch * hq, 1, sq]`` fp32), with the forward's ``mask``
    and ``lens``: the kernel on a CUDA tensor (``.launches`` counts it, and
    ``.mask_launches`` / ``.lens_launches`` the launches with each branch;
    dq is summed with fp32 atomics, so it is not bit-deterministic), the
    reference on a CPU tensor."""
    _check_shapes(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             causal=causal, scale=scale,
                                             mask=mask, lens=lens)
    return _launch_bwd_cuda(q, k, v, do, lse, delta, causal, scale, mask,
                            lens)


flash_attention_bwd.launches = 0
flash_attention_bwd.mask_launches = 0
flash_attention_bwd.lens_launches = 0


@torch.library.custom_op("paddle_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: float,
                       mask: Optional[torch.Tensor] = None,
                       lens: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(out, lse)``: :func:`flash_attention_fwd` forward,
    :func:`flash_attention_bwd` backward (``lse``, ``mask`` and ``lens``
    get no gradient)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               mask=mask, lens=lens)


def _op_setup_context(ctx, inputs, output):
    q, k, v, causal, scale, mask, lens = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, mask, lens)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _op_backward(ctx, dout, _dlse):
    q, k, v, out, lse, mask, lens = ctx.saved_tensors
    b, sq, hq, _ = q.shape
    dout = dout.contiguous()
    # delta = rowsum(do * out) in fp32, outside the kernel as in the
    # reference's _flash_bwd
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.reshape(b * hq, 1, sq).contiguous()
    dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, delta,
                                     causal=ctx.causal, scale=ctx.scale,
                                     mask=mask, lens=lens)
    return dq, dk, dv, None, None, None, None


flash_attention_op.register_autograd(_op_backward,
                                     setup_context=_op_setup_context)


def flash_attention(q, k, v, causal=False, scale=None, mask=None,
                    q_seqlens=None, kv_seqlens=None):
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs;
    returns ``out`` only, like the JAX entry, and is differentiable (the
    backward kernel on a CUDA tensor, its twin on a CPU tensor).

    - ``mask``: an additive (or bool) bias, normalized by
      :func:`normalize_mask` (``ValueError`` for a shape the kernels cannot
      stream).
    - ``q_seqlens`` / ``kv_seqlens``: ``[b]`` per-sequence valid lengths
      (padded varlen); rows past the length give zeros and no gradient.
    """
    b, sq, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if mask is not None:
        mask = normalize_mask(mask, q, k.shape[1])
    lens = seq_lens(q_seqlens, kv_seqlens, b, sq, k.shape[1], q.device)
    return flash_attention_op(q, k, v, bool(causal), float(scale), mask,
                              lens)[0]
