"""Ragged paged attention — the unified serving step's attention.

Port of ``paddle_tpu/ops/pallas/paged_attention.py::ragged_paged_attention``:
each sequence ``b`` feeds ``q_lens[b]`` (0..chunk) query rows this step,
causal within the chunk, attending its whole paged context of
``kv_lens[b]`` tokens (this chunk included — its K/V is already written).
Pools are ``[num_pages, page_size, kv_heads, head_dim]``; ``page_table``
is ``[b, pages_per_seq]`` int32 with ``-1`` for unallocated entries.

On a CUDA tensor :func:`ragged_paged_attention` launches the hand-written
kernel of ``csrc/ragged_paged_attention.cu`` (or raises); on a CPU tensor
it runs :func:`ragged_paged_attention_reference`, the torch twin of the
jnp gather oracle. Rows past ``q_lens`` come back zero on both paths.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
PAGE_SIZE_DEFAULT = 64
CHUNK_DEFAULT = 16
_KERNEL = "ragged_paged_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_ragged_paged_attention": [_P, _P, _P, _P, _P, _P, _P] + [_I] * 8
    + [ctypes.c_float, _I, _I, _P],
    "ptt_ragged_smem_bytes": [_I, _I, _I],
}


def smem_bytes(rows: int, page_size: int, d: int) -> int:
    """Dynamic shared memory one block of the kernel uses for ``rows`` =
    chunk * group query rows (builds the kernel on first use)."""
    return _build.load(_KERNEL, _SIGNATURES).ptt_ragged_smem_bytes(
        rows, page_size, d)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     kv_lens, q_lens, scale=None):
    """Gather-based oracle (torch twin of the jnp
    ``ragged_paged_attention_reference``): gather every page of each
    sequence, mask by the per-row causal limit, softmax in fp32. Returns
    ``[b, chunk, hq, d]`` in q's dtype with rows past ``q_lens`` zero."""
    b, c, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pages[pt].reshape(b, pps * page_size, hkv, d).float()
    v = v_pages[pt].reshape(b, pps * page_size, hkv, d).float()
    qg = q.reshape(b, c, hkv, group, d).float()
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k) * scale
    kv_lens = kv_lens.long().reshape(-1, 1, 1)
    q_lens = q_lens.long().reshape(-1, 1, 1)
    rows = torch.arange(c, device=q.device).reshape(1, -1, 1)
    limit = torch.minimum(kv_lens - q_lens + rows + 1, kv_lens)   # [b,c,1]
    col = torch.arange(pps * page_size, device=q.device).reshape(1, 1, -1)
    valid = (col < limit) & (rows < q_lens)                        # [b,c,s]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (idle lanes, padding past q_lens): zero them
    p = torch.where(valid[:, None, None], p, 0.0)
    out = torch.einsum("bhgcs,bshd->bchgd", p, v)
    return out.reshape(b, c, hq, d).to(q.dtype)


def _launch_cuda(q, k_pages, v_pages, page_table, kv_lens, q_lens, scale):
    b, c, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    code = _build.dtype_code(q.dtype, "ragged_paged_attention")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("page_table", page_table), ("kv_lens", kv_lens),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    tensors = (q, k_pages, v_pages, page_table, kv_lens, q_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("ragged_paged_attention: all inputs must be on "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_paged_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("ragged_paged_attention: q and the pools must be "
                         "16-byte aligned (the kernel loads 16-byte rows)")
    if d not in (64, 128):
        raise NotImplementedError(
            f"ragged_paged_attention kernel is built for head_dim 64 or "
            f"128, got {d}")
    lib = _build.load(_KERNEL, _SIGNATURES)
    out = torch.empty_like(q)
    err = lib.ptt_ragged_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), b, c, hq, hkv, num_pages, page_size,
        page_table.shape[1], d, float(scale), code, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "ragged_paged_attention launch")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                           scale=None, k_scales=None, v_scales=None):
    """Ragged prefill+decode attention over the paged KV cache.

    q: ``[b, chunk, hq, d]`` right-padded query chunks; pools
    ``[num_pages, page_size, hkv, d]``; page_table ``[b, pps]`` int32;
    kv_lens / q_lens ``[b]`` int32. Returns ``[b, chunk, hq, d]`` in q's
    dtype. A CUDA ``q`` launches the kernel (``.launches`` counts them);
    a CPU ``q`` runs the plain reference. int8 pools (``k_scales`` /
    ``v_scales``) belong to the quantized-KV slice and raise.
    """
    b, c, hq, d = q.shape
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs q heads {hq} divisible by kv {hkv}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if page_table.shape[0] != b or tuple(kv_lens.shape) != (b,) \
            or tuple(q_lens.shape) != (b,):
        raise ValueError("page_table / kv_lens / q_lens must lead with the "
                         f"batch {b}")
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 KV pools (k_scales/v_scales) are ported with the "
            "quantized-KV serving slice")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, kv_lens, q_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"got {q.device}")
    return _launch_cuda(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                        scale)


ragged_paged_attention.launches = 0
