"""Paged attention over the serving KV pools — the unified step's ragged
kernel and the legacy decode step's single-token kernel.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``.

:func:`ragged_paged_attention` (the unified step): each sequence ``b`` feeds ``q_lens[b]`` (0..chunk) query rows this step,
causal within the chunk, attending its whole paged context of
``kv_lens[b]`` tokens (this chunk included — its K/V is already written).
Pools are ``[num_pages, page_size, kv_heads, head_dim]``; ``page_table``
is ``[b, pages_per_seq]`` int32 with ``-1`` for unallocated entries.
int8 pools come with fp32 scale planes ``k_scales`` / ``v_scales``
``[num_pages, page_size, kv_heads]``: each page row dequantizes as
``q * scale`` in fp32 (the Pallas kernel rounds it to q's dtype, its jnp
reference keeps fp32; the port keeps fp32 in both versions).

On a CUDA tensor :func:`ragged_paged_attention` launches the hand-written
kernel of ``csrc/ragged_paged_attention.cu`` (or raises); on a CPU tensor
it runs :func:`ragged_paged_attention_reference`, the torch twin of the
jnp gather oracle. Rows past ``q_lens`` come back zero on both paths. The
kernel splits each (sequence, kv head) pair's pages over several blocks
and merges their partials in split order; :func:`walk_plan` sizes the
split from shapes alone.

:func:`paged_attention` (the legacy decode step): one query token per
sequence, ``q [b, hq, d]``, attends positions ``[0, lengths[b])`` of its
pages; ``lengths[b] == 0`` marks an empty slot and gives zeros. A CUDA
``q`` launches the kernel of ``csrc/paged_decode_attention.cu`` (or
raises), the same split walk with the GQA group as its rows, planned by
:func:`walk_plan`; a CPU ``q`` runs :func:`paged_attention_reference`.
Decode-only: the output carries no gradient, as the reference registers
no VJP.

Both kernels take head dims :data:`HEAD_DIMS` in fp32, bf16 and fp16
(:func:`kernel_takes`); on CUDA tensors of another dtype the wrappers run
the plain versions and count that in ``.twin_routes``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from ._build import kernel_takes  # noqa: F401 (the family's predicate)

NEG_INF = -1e30
PAGE_SIZE_DEFAULT = 64
CHUNK_DEFAULT = 16
HEAD_DIMS = (32, 64, 80, 96, 128)      # the built instantiations
_KERNEL = "ragged_paged_attention"
_DECODE = "paged_decode_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_ragged_paged_attention": [_P] * 11 + [_I] * 9
    + [ctypes.c_float, _I, _I, _P],
    "ptt_ragged_smem_bytes": [_I] * 4,
}
# the split walk (csrc/paged_walk.cuh): blocks a plan aims for, in waves of
# the card's SMs (more splits keep more pages in flight: chip_smoke.py
# --paged-walks times 2 to 16); the most bytes of split partials a plan may
# keep (device memory the scratch may take at large batches)
SPLIT_WAVES = 8
PARTIAL_CAP = 8 << 20
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float16: 3}
_DECODE_SIGNATURES = {
    "ptt_paged_decode_attention": [_P] * 8 + [_I] * 8
    + [ctypes.c_float, _I, _I, _P],
}


def smem_bytes(rows: int, d: int, pool_dtype=torch.float32,
               pages: int = 1) -> int:
    """Dynamic shared memory one block of the kernel uses for ``rows`` =
    chunk * group query rows over pools of ``pool_dtype``, walking
    ``pages`` pages a split (builds the kernel on first use)."""
    return _build.load(_KERNEL, _SIGNATURES).ptt_ragged_smem_bytes(
        rows, d, _KV_CODES[pool_dtype], pages)




class WalkPlan(NamedTuple):
    splits: int          # blocks a (sequence, kv head) pair's walk takes
    pages: int           # pages a split walks (the last may walk fewer)
    blocks: int          # the grid: sequences x kv heads x splits
    waves: float         # blocks over the card's SMs
    partial_bytes: int   # fp32 partials the splits leave (0: one split)


def walk_plan(b: int, heads: int, pps: int, page_size: int, d: int,
              rows: int, kv_elt: int, sms: int, want: int = 0) -> WalkPlan:
    """How the kernels split a page walk, from shapes alone (never from the
    context lengths, so a captured step stays valid): ``b`` sequences x
    ``heads`` kv heads, page tables ``pps`` pages wide, pages of
    ``page_size`` rows of ``d`` values of ``kv_elt`` bytes, ``rows`` query
    rows a block, ``sms`` SMs. Aims for ``want`` splits a pair (default:
    :data:`SPLIT_WAVES` waves of blocks), gives each split one page at
    least and keeps the fp32 partials (``rows`` x ``d + 2`` a split) within
    :data:`PARTIAL_CAP`."""
    del page_size, kv_elt   # a split takes whole pages, whatever they hold
    units = max(b * heads, 1)
    splits = max(1, min(want or -(-SPLIT_WAVES * sms // units), pps))
    per_split = 16 * (-(-rows * (d + 2) // 4))      # bytes, 16-aligned
    while splits > 1 and units * splits * per_split > PARTIAL_CAP:
        splits -= 1
    pages = -(-max(pps, 1) // splits)
    splits = -(-max(pps, 1) // pages)
    blocks = units * splits
    return WalkPlan(splits, pages, blocks, blocks / sms,
                    units * splits * per_split if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     kv_lens, q_lens, scale=None,
                                     k_scales=None, v_scales=None):
    """Gather-based oracle (torch twin of the jnp
    ``ragged_paged_attention_reference``): gather every page of each
    sequence (int8 pages dequantize after the gather with their scales),
    mask by the per-row causal limit, softmax in fp32. Returns ``[b,
    chunk, hq, d]`` in q's dtype with rows past ``q_lens`` zero."""
    b, c, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pages[pt].reshape(b, pps * page_size, hkv, d).float()
    v = v_pages[pt].reshape(b, pps * page_size, hkv, d).float()
    if k_scales is not None:
        k = k * k_scales[pt].reshape(b, pps * page_size, hkv, 1).float()
        v = v * v_scales[pt].reshape(b, pps * page_size, hkv, 1).float()
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


def _launch_cuda(q, k_pages, v_pages, page_table, kv_lens, q_lens, scale,
                 k_scales, v_scales):
    b, c, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    code = _build.dtype_code(q.dtype, "ragged_paged_attention")
    quant = k_scales is not None
    pool_dtype = torch.int8 if quant else q.dtype
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != pool_dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {pool_dtype} "
                            f"(q is {q.dtype})")
    scales = (k_scales, v_scales) if quant else ()
    for name, t in zip(("k_scales", "v_scales"), scales):
        if t.dtype != torch.float32 or tuple(t.shape) != (num_pages,
                                                          page_size, hkv):
            raise TypeError(f"{name} must be fp32 [{num_pages}, {page_size}, "
                            f"{hkv}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("page_table", page_table), ("kv_lens", kv_lens),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    tensors = (q, k_pages, v_pages, page_table, kv_lens, q_lens) + scales
    if any(t.device != q.device for t in tensors):
        raise ValueError("ragged_paged_attention: all inputs must be on "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_paged_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("ragged_paged_attention: q and the pools must be "
                         "16-byte aligned (the kernel loads 16-byte rows)")
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"ragged_paged_attention kernel is built for head_dim in "
            f"{HEAD_DIMS}, got {d}")
    lib = _build.load(_KERNEL, _SIGNATURES)
    out = torch.empty_like(q)
    if b == 0:
        return out
    rows, pps = c * (hq // hkv), page_table.shape[1]
    plan = walk_plan(b, hkv, pps, page_size, d, rows,
                     k_pages.element_size(), _sms(q.device.index))
    part = counters = None
    if plan.splits > 1:
        part = _build.kept(q.device, "walk", plan.partial_bytes // 4,
                           torch.float32)
        counters = _build.kept(q.device, "walk", b * hkv)
    err = lib.ptt_ragged_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None, page_table.data_ptr(),
        kv_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), b, c, hq, hkv,
        num_pages, page_size, pps, d, plan.pages, float(scale), code,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "ragged_paged_attention launch")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                           scale=None, k_scales=None, v_scales=None):
    """Ragged prefill+decode attention over the paged KV cache.

    q: ``[b, chunk, hq, d]`` right-padded query chunks; pools
    ``[num_pages, page_size, hkv, d]``; page_table ``[b, pps]`` int32;
    kv_lens / q_lens ``[b]`` int32; int8 pools take fp32 ``k_scales`` /
    ``v_scales`` ``[num_pages, page_size, hkv]``. Returns ``[b, chunk, hq,
    d]`` in q's dtype. A CUDA ``q`` launches the kernel (``.launches``
    counts them); a CPU ``q`` runs the plain reference.
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
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, kv_lens, q_lens, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"got {q.device}")
    if not kernel_takes(q.dtype):
        ragged_paged_attention.twin_routes += 1
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, kv_lens, q_lens, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    return _launch_cuda(q, k_pages, v_pages, page_table, kv_lens, q_lens,
                        scale, k_scales, v_scales)


ragged_paged_attention.launches = 0
ragged_paged_attention.twin_routes = 0


# ---------------------------------------------------------------------------
# single-token decode (the legacy two-program path)
# ---------------------------------------------------------------------------


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              scale=None):
    """Gather-based oracle (torch twin of the jnp
    ``paged_attention_reference``): gather every page of each sequence in
    fp32, mask ``col < length``, softmax, zero empty slots (``length <=
    0``). q ``[b, hq, d]``; returns ``[b, hq, d]`` in q's dtype."""
    b, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pt = page_table.long().clamp(0, num_pages - 1)
    k = k_pages[pt].reshape(b, pps * page_size, hkv, d).float()
    v = v_pages[pt].reshape(b, pps * page_size, hkv, d).float()
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    lengths = lengths.long().reshape(-1, 1)
    valid = torch.arange(pps * page_size, device=q.device)[None] < lengths
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # empty slots: the all-masked softmax is uniform garbage — zero it
    p = torch.where((lengths > 0).reshape(-1, 1, 1, 1), p, 0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(b, hq, d).to(q.dtype)


def _launch_decode(q, k_pages, v_pages, page_table, lengths, scale):
    b, hq, d = q.shape
    num_pages, page_size, hkv, _ = k_pages.shape
    code = _build.dtype_code(q.dtype, "paged_attention")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected q's {q.dtype}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"paged_attention: all inputs must be on {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned (the kernel loads 16-byte rows)")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"paged_attention kernel is built for "
                                  f"head_dim in {HEAD_DIMS}, got {d}")
    lib = _build.load(_DECODE, _DECODE_SIGNATURES)
    out = torch.empty_like(q)
    if b == 0:
        return out
    pps = page_table.shape[1]
    plan = walk_plan(b, hkv, pps, page_size, d, hq // hkv,
                     k_pages.element_size(), _sms(q.device.index))
    part = counters = None
    if plan.splits > 1:
        part = _build.kept(q.device, "walk", plan.partial_bytes // 4,
                           torch.float32)
        counters = _build.kept(q.device, "walk", b * hkv)
    err = lib.ptt_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), b, hq, hkv,
        num_pages, page_size, pps, d, plan.pages, float(scale), code,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_attention launch")
    paged_attention.launches += 1
    return out


@torch.no_grad()
def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None):
    """Single-token decode attention over the paged KV cache.

    q: ``[b, hq, d]``; pools ``[num_pages, page_size, hkv, d]`` in q's
    dtype; page_table ``[b, pps]`` int32 (-1 unallocated); lengths ``[b]``
    int32 (0 = empty slot -> zeros). Returns ``[b, hq, d]`` in q's dtype,
    without a gradient. A CUDA ``q`` launches the kernel (``.launches``
    counts them; split partials and arrival counters come from
    ``_build.kept``, shared with the ragged kernel, so a captured step
    holds them); a CPU ``q`` runs :func:`paged_attention_reference`.
    """
    b, hq, d = q.shape
    hkv = k_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs q heads {hq} divisible by kv {hkv}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if page_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"page_table / lengths must lead with the batch {b}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if not kernel_takes(q.dtype):
        paged_attention.twin_routes += 1
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, scale=scale)
    return _launch_decode(q, k_pages, v_pages, page_table, lengths, scale)


paged_attention.launches = 0
paged_attention.twin_routes = 0
