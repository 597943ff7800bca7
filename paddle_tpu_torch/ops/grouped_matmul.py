"""Ragged grouped GEMM — the MoE expert FFN's matmuls.

Port of ``paddle_tpu/ops/pallas/grouped_matmul.py``: ``out[i] = x[i] @
dequant(W)[g(i)]`` for token rows PRE-SORTED by expert, with ``group_offsets
[E+1]`` the prefix sum of the experts' row counts (empty experts allowed).
``W`` is an expert stack ``[E, K, N]`` — float, int8, or split-half packed
int4 ``[E, K/2, N]`` (``quant_matmul.pack_int4`` per expert) — with scales
``[E, N]`` per channel or ``[E, groups, N]`` per group along K. A quantized
element dequantizes as ``q * s`` in ``x``'s dtype (bf16 / fp16 round it),
float weights are cast to ``x``'s dtype, products accumulate in fp32, and
the result is cast to ``x``'s dtype.

On a CUDA tensor :func:`grouped_matmul_fwd` / :func:`grouped_matmul_bwd`
launch the hand-written kernels of ``csrc/grouped_matmul.cu`` (or raise);
on a CPU tensor they run :func:`grouped_matmul_reference` and
:func:`grouped_matmul_dx_reference`. :func:`_plan` picks the kernel before the
launch, from shapes and pointers: bf16 or fp16 activations with fp weights at K
and N multiples of 8 and 16-byte aligned pointers take the tensor-core kernel
(``"tc"``, ``ptt_gmm_tc`` / ``ptt_gmm_bwd_tc``; counted apart in
``.tc_launches``); the bf16 / fp16 int8 / int4 forward at the serving rows on
whole 16-byte chunks the skinny route (``"sk"``, ``ptt_gmm_sk``; counted apart
in ``.sk_launches``); the bf16 / fp16 int8 dx at any rows on whole chunks the
dx route (``"dx"``, ``ptt_gmm_dx_tc``: the weight-only GEMM's dx tile with
each row tile bound to an expert; counted apart in
``grouped_matmul_bwd.dx_launches``); everything else (fp32 activations, the
quantized prefill rows' forward, other widths) the CUDA-core kernel
(``"cc"``). :func:`grouped_matmul` is
differentiable on both: one custom op (``paddle_tpu_torch::grouped_matmul``)
whose backward gives ``dx`` through the backward kernel and, for float
weights, ``dw[e] = x_e^T dy_e`` as a plain matmul over each expert's rows
(the reference's ``_gmm_bwd`` computes it with an einsum outside its
kernels, too); quantized weights and their scales get no gradient. int4 has
no backward kernel in the reference either: its ``dx`` is the dequantized
plain contraction on both devices.
"""
from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from typing import NamedTuple, Optional

import torch

from . import _build
from ._build import kernel_takes  # noqa: F401 (the family's predicate)
from .quant_matmul import (_TC_DTYPES, _norm_scales, dequantize_weight,
                           dx_split)

_KERNEL = "grouped_matmul"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = [_P] * 7 + [_I] * 11 + [_P]
_TC_ENTRY = [_P] * 6 + [_I] * 10 + [_P]
_SIGNATURES = {name: _ENTRY for name in ("ptt_gmm", "ptt_gmm_q", "ptt_gmm_q4",
                                         "ptt_gmm_bwd", "ptt_gmm_q_bwd",
                                         "ptt_gmm_sk")}
_SIGNATURES.update(ptt_gmm_tc=_TC_ENTRY, ptt_gmm_bwd_tc=_TC_ENTRY,
                   ptt_gmm_dx_tc=[_P] * 7 + [_I] * 10 + [_P])
# the CUDA-core kernel's tiles (csrc/grouped_matmul.cu gmm_kernel): 32 rows
# of one expert x 64 output columns a block, 64 reduction indices a stage
# (32 stored rows of packed int4)
BM, _BJ, _BR = 32, 64, 64
_BLOCKS_PER_SM = 2   # split the reduction until this many blocks per SM
# the tensor-core tiles: serving (gmm_tc_kernel, mma.sync) and prefill
# (gmm_wg_kernel, wgmma); the C entry's tile code, rows and columns a
# block, and the blocks an SM the reduction is split towards. On an H100
# at the serving rows, fewer and longer serving blocks streamed the
# weights faster than a deeper split (w1 + w2 in 0.0218 ms split 1 / 4,
# 0.0315 split 6 / 16 at two blocks an SM, chip_smoke.py phase 11); the
# prefill tile splits only while its tiles leave SMs idle. 64 reduction
# indices a stage
TC_TILES = {"serving": dict(code=0, bm=32, bn=128,
                            blocks_per_sm=Fraction(1, 3)),
            "prefill": dict(code=1, bm=128, bn=128, blocks_per_sm=1)}
_TC_BK = 64
# the serving tile up to this many rows per expert (ceil(M / E)), the
# prefill tile above it
SERVING_ROWS = 64
# the skinny route (gmm_sk_kernel, csrc/skinny_gemm.cuh): row tiles of up to
# SK_ROWS rows of one expert x SK_COLS output columns a block, the stored
# weight rows (K, or K / 2 packed int4) in stages of SK_STAGE through a 96 KB
# ring; K is split (_split) until the grid's blocks fill SK_BLOCKS_PER_SM x
# the SMs: one wave of resident blocks, two an SM. On an H100 at the
# serving rows (w1 + w2, bf16) 2 blocks an SM ran int8 / int4 in 0.0416 /
# 0.0307 ms, 1 in 0.0511 / 0.0336, 4 in 0.0428 / 0.0332 and 1/2 in 0.0653
# / 0.0415 (PERF.md §6)
SK_ROWS, SK_COLS, SK_STAGE = 64, 64, 64
SK_BLOCKS_PER_SM = 2
# the dx route (gmm_dx_kernel, csrc/dx_tile.cuh): DX_COLS stored rows of an
# expert's int8 stack (dx columns) x a row tile of up to DX_ROWS rows of that
# expert a block, the reduction over N in stages of DX_STAGE columns, split
# by quant_matmul.dx_split (DX_PER stages a split while the grid keeps
# between half an SM and two blocks an SM)
DX_ROWS, DX_COLS, DX_STAGE = 64, 64, 64


# ---------------------------------------------------------------------------
# ragged layout helpers
# ---------------------------------------------------------------------------


def token_group_ids(group_offsets, m: int):
    """Per-row expert id ``[m] int32`` from the ``[E+1]`` offsets: rows in
    ``[offsets[e], offsets[e+1])`` belong to expert ``e``, clamped into
    ``[0, E-1]`` as the reference does."""
    e = group_offsets.shape[0] - 1
    offs = group_offsets.to(torch.int32).contiguous()
    rows = torch.arange(m, dtype=torch.int32, device=offs.device)
    gid = torch.searchsorted(offs, rows, right=True) - 1
    return gid.clamp(0, e - 1).to(torch.int32)


def max_row_tiles(m: int, e: int, bm: int = BM) -> int:
    """Grid rows that cover every live row tile whatever the split of ``m``
    rows over ``e`` experts: ``sum ceil(n_e / bm) <= ceil(m / bm) + min(e,
    m) - 1`` (each non-empty expert adds at most one partial tile)."""
    return max(1, -(-m // bm) + min(e, m) - 1)


def row_tiles(group_offsets, m: int, bm: int = BM):
    """The kernel's row-tile binding (the CUDA counterpart of the
    reference's ``_pack_layout`` tile -> group table), as tensors ``(expert,
    lo, hi)`` over :func:`max_row_tiles` grid rows: expert ``e`` owns
    ``ceil(n_e / bm)`` tiles, numbered expert after expert, tile ``t`` of
    it rows ``[lo, hi)``; grid rows past the last live tile have expert
    -1. Each block of ``csrc/grouped_matmul.cu`` computes its own row of
    this table from the offsets; this is its plain version."""
    offs = group_offsets.to(torch.int64).clamp(0, m)
    e = offs.shape[0] - 1
    lo_e = offs[:-1].clone()
    hi_e = offs[1:].clone()
    lo_e[0] = 0
    hi_e[-1] = m
    hi_e = torch.maximum(hi_e, lo_e)
    nt = (hi_e - lo_e + bm - 1) // bm
    first = torch.cumsum(nt, 0) - nt                        # [E]
    t = torch.arange(max_row_tiles(m, e, bm), device=offs.device)
    owner = torch.searchsorted(first + nt, t, right=True)  # expert or E
    live = owner < e
    oc = owner.clamp_max(e - 1)
    lo = lo_e[oc] + (t - first[oc]) * bm
    hi = torch.minimum(hi_e[oc], lo + bm)
    return (torch.where(live, oc, -1), torch.where(live, lo, 0),
            torch.where(live, hi, 0))


def _norm_scales_grouped(scales, e: int, k: int, n: int):
    """Normalize grouped scales to ``[E, groups, N]``; returns ``(scales3d,
    group_size)`` — the per-expert twin of ``quant_matmul._norm_scales``."""
    s = scales[:, None, :] if scales.dim() == 2 else scales
    if s.dim() != 3 or s.shape[0] != e:
        raise ValueError(
            f"grouped scales must be [E, N] or [E, groups, N] with E={e}, "
            f"got {tuple(scales.shape)}")
    _, group = _norm_scales(s[0], k, n)
    return s, group


def _weight_bits(weights, k: int) -> int:
    """0 = float weights, 8 = int8, 4 = nibble-packed int4 (split-half
    rows, ``[E, K/2, N]``)."""
    kw = weights.shape[1]
    if weights.dtype == torch.int8:
        if kw == k:
            return 8
        if kw * 2 == k:
            return 4
        raise ValueError(
            f"grouped quantized weight in-dim {kw} matches neither K={k} "
            f"(int8) nor K/2={k // 2} (packed int4)")
    if kw != k:
        raise ValueError(f"grouped weight in-dim {kw} != K={k}")
    return 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def dequantize_grouped_weight(weights, scales, k=None,
                              out_dtype=torch.float32):
    """The full-precision expert stack ``[E, K, N]`` (per-expert
    ``quant_matmul.dequantize_weight``)."""
    if weights.dtype != torch.int8:
        return weights.to(out_dtype)
    kk = weights.shape[1] if k is None else k
    s3, _ = _norm_scales_grouped(scales, weights.shape[0], kk,
                                 weights.shape[-1])
    return torch.stack([dequantize_weight(q, s, k=kk, out_dtype=out_dtype)
                        for q, s in zip(weights, s3)])


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def grouped_matmul_reference(x, weights, group_offsets, scales=None):
    """Segment-matmul oracle, the reference's spelling: one dense product
    per expert over ALL rows (``[E, M, N]``, fp32 accumulation) and a row
    gather by :func:`token_group_ids`, cast to ``x``'s dtype."""
    m, k = x.shape
    acc = _acc_dtype(x.dtype)
    wfp = dequantize_grouped_weight(weights, scales, k=k, out_dtype=x.dtype)
    ys = torch.matmul(x.to(acc), wfp.to(acc))                 # [E, M, N]
    gid = token_group_ids(group_offsets, m).long()
    out = ys[gid, torch.arange(m, device=x.device)]
    return out.to(x.dtype)


def grouped_matmul_dx_reference(dy, weights, group_offsets, scales, k,
                                x_dtype):
    """``dx[i] = dy[i] @ dequant(W)[g(i)]^T`` with the weights in
    ``x_dtype``, ``dy`` cast to ``x_dtype`` first, fp32 accumulation, the
    result in ``x_dtype`` — the reference's ``_bwd_dx_impl``."""
    m = dy.shape[0]
    acc = _acc_dtype(x_dtype)
    wfp = dequantize_grouped_weight(weights, scales, k=k, out_dtype=x_dtype)
    dxs = torch.matmul(dy.to(x_dtype).to(acc), wfp.to(acc).transpose(1, 2))
    gid = token_group_ids(group_offsets, m).long()
    return dxs[gid, torch.arange(m, device=dy.device)].to(x_dtype)


def grouped_matmul_dw(x, dy, group_offsets, e: int, w_dtype):
    """``dw[e] = x_e^T dy_e`` over each expert's row range in fp32, cast to
    the weights' dtype (the reference's segment outer product). Reads the
    offsets on the host."""
    offs = [min(max(int(o), 0), x.shape[0])
            for o in group_offsets.tolist()]
    dw = torch.zeros((e, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    for i in range(e):
        lo = 0 if i == 0 else offs[i]
        hi = x.shape[0] if i == e - 1 else max(offs[i + 1], lo)
        if hi > lo:
            dw[i] = x[lo:hi].float().T @ dy[lo:hi].float()
    return dw.to(w_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """One launch: the kernel (``"tc"`` tensor cores / ``"sk"`` the
    skinny route / ``"dx"`` the dx route / ``"cc"`` CUDA cores), the tc
    tile family (None otherwise), rows a tile, grid rows, column tiles,
    splits of the reduction and stages per split."""
    route: str
    tile: Optional[str]
    bm: int
    rows: int
    cols: int
    splits: int
    per: int


def _split(stages, live, blocks_per_sm, sms):
    """(splits, stages per split): split the reduction until about
    ``blocks_per_sm`` blocks an SM are live."""
    want = max(1, min(stages, -(-blocks_per_sm * sms // live)))
    per = -(-stages // want)
    return -(-stages // per), per


def _plan(m, e, k, n, bits, bwd, dtype, aligned, sms, groups=1) -> Plan:
    """The launch of one grouped GEMM of ``m`` rows over ``e`` experts,
    ``[K, N]`` weights of ``bits`` (0 fp, 8, 4) with ``groups`` scale rows,
    forward or dx (``bwd``), activations of ``dtype``; ``aligned``: the
    activations, weights, scales and output start on 16 bytes; ``sms``: the
    card's SMs. A pure function of its arguments, decided before any
    launch.

    The int8 / int4 forward takes the skinny route when ``dtype`` is bf16
    or fp16,
    ``ceil(m / e) <= SERVING_ROWS``, the stored rows (K, int4 K / 2) are a
    multiple of ``SK_STAGE``, N of 16 and the scale groups of 16 rows, and
    the pointers are aligned. Its grid rows cover every live 64-row tile
    (:func:`max_row_tiles`), and K is split until those rows x the column
    tiles fill ``SK_BLOCKS_PER_SM`` blocks an SM (every grid row counted
    live). Each dtype goes to the kernel an H100 ran faster at the serving
    rows (48 over 4 experts, w1 + w2 of GPT-125M, 2 blocks an SM, PERF.md
    §6 rows 16-17): bf16 to this route (int8 0.0416, int4 0.0307 ms against
    the CUDA-core kernel's 0.0812 / 0.0832) and fp16 with it (the same
    tile, bytes and tensor-core rate), fp32 to the CUDA-core kernel
    (0.0736 ms against 0.0957 on the skinny tile's FMA branch, which is
    therefore not built).

    The int8 dx takes the dx route when ``dtype`` is bf16 or fp16, K is a
    multiple of ``DX_COLS``, N of 16 and the scale groups of 16 rows, and
    the pointers are aligned, at any rows (serving or prefill): column
    tiles of ``DX_COLS`` dx columns, grid rows over every live
    ``DX_ROWS``-row tile (:func:`max_row_tiles`, every grid row counted
    live), N split by ``quant_matmul.dx_split``. fp32, int4 (whose dx is
    the plain contraction, as the reference's) and the rest of the dx keep
    the CUDA-core kernel."""
    kw = k // 2 if bits == 4 else k
    if (bits == 8 and bwd and dtype in _TC_DTYPES and aligned
            and k % DX_COLS == 0 and n % 16 == 0
            and (k // max(groups, 1)) % 16 == 0):
        rows = max_row_tiles(m, e, DX_ROWS)
        cols = k // DX_COLS
        splits, per = dx_split(rows * cols, -(-n // DX_STAGE), sms)
        return Plan("dx", None, DX_ROWS, rows, cols, splits, per)
    if (bits and not bwd and dtype in _TC_DTYPES and aligned
            and -(-m // e) <= SERVING_ROWS and kw % SK_STAGE == 0
            and n % 16 == 0 and (k // max(groups, 1)) % 16 == 0):
        rows = max_row_tiles(m, e, SK_ROWS)
        cols = -(-n // SK_COLS)
        splits, per = _split(kw // SK_STAGE, rows * cols, SK_BLOCKS_PER_SM,
                             sms)
        return Plan("sk", None, SK_ROWS, rows, cols, splits, per)
    if (bits == 0 and dtype in _TC_DTYPES and aligned and k % 8 == 0
            and n % 8 == 0):
        tile = "serving" if -(-m // e) <= SERVING_ROWS else "prefill"
        t = TC_TILES[tile]
        cols = -(-(k if bwd else n) // t["bn"])
        stages = -(-(n if bwd else k) // _TC_BK)
        # split against the tiles the rows fill, not the bound below
        live = cols * -(-m // t["bm"])
        splits, per = _split(stages, live, t["blocks_per_sm"], sms)
        return Plan("tc", tile, t["bm"], max_row_tiles(m, e, t["bm"]), cols,
                    splits, per)
    rw = 32 if bits == 4 else 64
    cols = -(-kw // rw) if bwd else -(-n // _BJ)
    stages = -(-n // _BR) if bwd else -(-kw // rw)
    rows = max_row_tiles(m, e)
    # split against the tiles the rows fill, not the bound above
    live = cols * -(-m // BM)
    splits, per = _split(stages, live, _BLOCKS_PER_SM, sms)
    return Plan("cc", None, BM, rows, cols, splits, per)


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(a, weights, scales3d, offsets, k, n, bits, bwd):
    """One kernel launch: forward ``a = x [M, K]`` -> ``[M, N]``, backward
    ``a = dy [M, N]`` -> ``[M, K]``, in ``a``'s dtype. Returns the output
    and the route that ran (None when ``M == 0``: no launch)."""
    code = _build.dtype_code(a.dtype, "grouped_matmul")
    tensors = [a, weights, offsets] + ([] if scales3d is None
                                       else [scales3d])
    if any(t.device != a.device for t in tensors):
        raise ValueError(f"grouped_matmul: all inputs must be on {a.device}")
    if bits == 0 and weights.dtype != a.dtype:
        weights = weights.to(a.dtype)   # the reference's astype(x.dtype)
    a = a.contiguous()
    weights = weights.contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    if scales3d is not None:
        scales3d = scales3d.to(torch.float32).contiguous()
    m, e = a.shape[0], weights.shape[0]
    out = torch.empty((m, k if bwd else n), dtype=a.dtype, device=a.device)
    if m == 0:
        return out, None
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, weights, out) + (
        () if scales3d is None else (scales3d,)))
    groups = 1 if scales3d is None else scales3d.shape[1]
    plan = _plan(m, e, k, n, bits, bwd, a.dtype, aligned,
                 _sms(a.device.index), groups)
    ws = (torch.empty((plan.splits, m, out.shape[1]), dtype=torch.float32,
                      device=a.device) if plan.splits > 1 else None)
    counters = _build.kept(a.device, "gmm", plan.rows * plan.cols)
    lib = _build.load(_KERNEL, _SIGNATURES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if plan.route == "tc":
        name = "ptt_gmm_bwd_tc" if bwd else "ptt_gmm_tc"
        err = getattr(lib, name)(
            a.data_ptr(), weights.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            counters.data_ptr(), m, k, n, e, TC_TILES[plan.tile]["code"],
            plan.rows, plan.splits, plan.per, code, a.device.index, stream)
    elif plan.route == "dx":
        name = "ptt_gmm_dx_tc"
        err = lib.ptt_gmm_dx_tc(
            a.data_ptr(), weights.data_ptr(), scales3d.data_ptr(),
            offsets.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), counters.data_ptr(), m,
            k, n, e, groups, plan.rows, plan.splits, plan.per, code,
            a.device.index, stream)
    elif plan.route == "sk":
        name = "ptt_gmm_sk"
        err = lib.ptt_gmm_sk(
            a.data_ptr(), weights.data_ptr(), scales3d.data_ptr(),
            offsets.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), counters.data_ptr(), m,
            k, n, e, groups, bits, plan.rows, plan.splits, plan.per, code,
            a.device.index, stream)
    else:
        vec = int(n * weights.element_size() % 16 == 0
                  and weights.data_ptr() % 16 == 0)
        name = {0: "ptt_gmm", 8: "ptt_gmm_q", 4: "ptt_gmm_q4"}[bits] \
            + ("_bwd" if bwd else "")
        err = getattr(lib, name)(
            a.data_ptr(), weights.data_ptr(),
            None if scales3d is None else scales3d.data_ptr(),
            offsets.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), counters.data_ptr(), m,
            k, n, e, 1 if scales3d is None else scales3d.shape[1],
            plan.rows, plan.splits, plan.per, vec, code, a.device.index,
            stream)
    _build.check(lib, err, f"grouped_matmul {name} launch")
    return out, plan.route


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul runs on cuda or cpu, got {t.device}")




_BITS_NAME = {0: "fp", 8: "int8", 4: "int4"}


def grouped_matmul_fwd(x2, weights, group_offsets, scales3d=None):
    """``x2 [M, K]`` rows through their experts' weights, in ``x2``'s dtype:
    a kernel on a CUDA tensor (``.launches["fp" | "int8" | "int4"]``
    counts every kernel, ``.tc_launches`` the fp tensor-core one alone,
    ``.sk_launches`` the skinny route alone), the reference on a CPU
    tensor."""
    _check_device(x2)
    k = x2.shape[1]
    bits = _weight_bits(weights, k)
    if x2.device.type == "cpu":
        return grouped_matmul_reference(x2, weights, group_offsets,
                                        scales=scales3d)
    if not kernel_takes(x2.dtype):
        grouped_matmul_fwd.twin_routes += 1
        return grouped_matmul_reference(x2, weights, group_offsets,
                                        scales=scales3d)
    out, route = _launch(x2, weights, scales3d, group_offsets, k,
                         weights.shape[2], bits, bwd=False)
    if route:
        grouped_matmul_fwd.launches[_BITS_NAME[bits]] += 1
        grouped_matmul_fwd.tc_launches += route == "tc"
        grouped_matmul_fwd.sk_launches += route == "sk"
    return out


grouped_matmul_fwd.launches = {"fp": 0, "int8": 0, "int4": 0}
grouped_matmul_fwd.tc_launches = 0
grouped_matmul_fwd.sk_launches = 0
grouped_matmul_fwd.twin_routes = 0


def grouped_matmul_bwd(dy, weights, group_offsets, scales3d, k, x_dtype):
    """``dx [M, K]`` in ``x_dtype``: a kernel on a CUDA tensor for fp and
    int8 weights (``.launches["fp" | "int8"]`` counts every kernel,
    ``.tc_launches`` the fp tensor-core one alone, ``.dx_launches`` the
    int8 dx route alone), the reference on a CPU tensor and for int4 (the
    reference has no int4 backward kernel)."""
    _check_device(dy)
    bits = _weight_bits(weights, k)
    if dy.device.type == "cpu" or bits == 4:
        return grouped_matmul_dx_reference(dy, weights, group_offsets,
                                           scales3d, k, x_dtype)
    if not kernel_takes(x_dtype):
        grouped_matmul_bwd.twin_routes += 1
        return grouped_matmul_dx_reference(dy, weights, group_offsets,
                                           scales3d, k, x_dtype)
    out, route = _launch(dy.to(x_dtype), weights, scales3d, group_offsets,
                         k, weights.shape[2], bits, bwd=True)
    if route:
        grouped_matmul_bwd.launches[_BITS_NAME[bits]] += 1
        grouped_matmul_bwd.tc_launches += route == "tc"
        grouped_matmul_bwd.dx_launches += route == "dx"
    return out


grouped_matmul_bwd.launches = {"fp": 0, "int8": 0}
grouped_matmul_bwd.tc_launches = 0
grouped_matmul_bwd.dx_launches = 0
grouped_matmul_bwd.twin_routes = 0


@torch.library.custom_op("paddle_tpu_torch::grouped_matmul", mutates_args=())
def grouped_matmul_op(x: torch.Tensor, weights: torch.Tensor,
                      group_offsets: torch.Tensor,
                      scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Differentiable ragged grouped GEMM over ``[E, groups, N]`` scales:
    :func:`grouped_matmul_fwd` forward, :func:`grouped_matmul_bwd` (dx) and
    :func:`grouped_matmul_dw` (fp dw) backward."""
    return grouped_matmul_fwd(x, weights, group_offsets, scales)


def _op_setup_context(ctx, inputs, output):
    x, weights, group_offsets, scales = inputs
    ctx.bits = _weight_bits(weights, x.shape[1])
    ctx.save_for_backward(x if ctx.bits == 0 else None, weights,
                          group_offsets, scales)
    ctx.k, ctx.x_dtype = x.shape[1], x.dtype


def _op_backward(ctx, dy):
    x, weights, offsets, scales = ctx.saved_tensors
    dy = dy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = grouped_matmul_bwd(dy, weights, offsets, scales, ctx.k,
                                ctx.x_dtype)
    if ctx.bits == 0 and ctx.needs_input_grad[1]:
        dw = grouped_matmul_dw(x, dy, offsets, weights.shape[0],
                               weights.dtype)
    return dx, dw, None, None


grouped_matmul_op.register_autograd(_op_backward,
                                    setup_context=_op_setup_context)


def grouped_matmul(x, weights, group_offsets, scales=None, use_kernel=None):
    """Ragged grouped GEMM: ``out[i] = x[i] @ dequant(weights)[g(i)]``.

    x: ``[M, K]`` float rows PRE-SORTED by expert (ascending id); weights:
    ``[E, K, N]`` float / int8 or ``[E, K/2, N]`` packed int4;
    group_offsets: ``[E+1]`` int prefix sum (``offsets[0] == 0``,
    ``offsets[E] == M``, monotone — empty experts allowed); scales ``[E,
    N]`` per channel or ``[E, groups, N]`` per group, required iff the
    weights are quantized. Returns ``[M, N]`` in x's dtype; differentiable
    in x and (float) weights. Where no gradient can flow the forward
    wrapper runs without the autograd op.
    """
    if x.dim() != 2:
        raise ValueError(f"grouped_matmul wants 2D tokens [M, K], got "
                         f"{tuple(x.shape)}")
    if weights.dim() != 3:
        raise ValueError(f"grouped_matmul wants stacked weights [E, K, N], "
                         f"got {tuple(weights.shape)}")
    k = x.shape[1]
    e, _, n = weights.shape
    if tuple(group_offsets.shape) != (e + 1,):
        raise ValueError(f"group_offsets must be [E+1]={e + 1}, got "
                         f"{tuple(group_offsets.shape)}")
    bits = _weight_bits(weights, k)
    if bits and scales is None:
        raise ValueError("quantized grouped_matmul needs scales")
    if not bits and scales is not None:
        raise ValueError("float grouped_matmul takes no scales")
    scales3d = (None if scales is None
                else _norm_scales_grouped(scales, e, k, n)[0])
    _check_device(x)
    if use_kernel is False:
        return grouped_matmul_reference(x, weights, group_offsets, scales3d)
    if use_kernel and x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: the kernel runs on a CUDA tensor,"
                         f" got {x.device} (use_kernel=None runs the plain "
                         "version there)")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weights.requires_grad)
    fn = grouped_matmul_op if needs_grad else grouped_matmul_fwd
    return fn(x, weights, group_offsets, scales3d)
