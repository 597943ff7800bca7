"""Weight-only quantized GEMM — the serving step's projections when the
weights are int8 or int4.

Port of ``paddle_tpu/ops/pallas/quant_matmul.py``: ``y = x @ dequant(W) +
bias`` with ``W`` int8 ``[K, N]`` or split-half packed int4 ``[K/2, N]``
(byte ``i`` holds row ``i`` in its low nibble and row ``K/2 + i`` in its
high nibble) and scales ``[N]`` per channel or ``[groups, N]`` per group
along K. A weight element dequantizes as ``q * s`` computed in ``x``'s
dtype (bf16 and fp16 round it), products accumulate in fp32, and the
result is cast to ``x``'s dtype; a bias is added in fp32 before that cast.

On a CUDA tensor :func:`quant_matmul_fwd` / :func:`quant_matmul_bwd`
launch the hand-written kernels of ``csrc/quant_matmul.cu`` (or raise),
the route chosen before the launch by the pure :func:`qmm_plan`: the bf16 or
fp16 int8 and packed int4 forward at up to :data:`TC_ROWS` tokens on aligned
widths takes the tensor-core kernel (``"tc"``, counted in
``quant_matmul_fwd.tc_launches`` too), and so does their dx at any number of
rows (``qmm_dx_kernel``, counted in ``quant_matmul_bwd.tc_launches``);
everything else (fp32, more tokens in the forward, odd widths, unaligned
pointers) the CUDA-core kernel (``"cc"``); on a CPU tensor
they run :func:`quant_matmul_reference` and
:func:`quant_matmul_dx_reference`. :func:`quant_matmul` is differentiable
on both: one custom op (``paddle_tpu_torch::quant_matmul``) whose backward
gives ``dx = dy @ dequant(W)^T`` through the backward kernel and the bias
its row sum; the quantized weight and its scales get no gradient (the
reference returns float0 and zeros for them). Calls that need no gradient
(the serving step runs under ``no_grad``) skip the op's autograd dispatch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from ._build import kernel_takes  # noqa: F401 (the family's predicate)

_KERNEL = "quant_matmul"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = [_P] * 7 + [_I] * 9 + [_P]
_SIGNATURES = {f"ptt_qmm_{name}": _ENTRY
               for name in ("int8", "int4", "int8_bwd", "int4_bwd")}
_SIGNATURES["ptt_qmm_tc"] = [_P] * 7 + [_I] * 9 + [_P]
_SIGNATURES["ptt_qmm_dx_tc"] = [_P] * 6 + [_I] * 9 + [_P]
# the CUDA-core kernel's tiles (csrc/quant_matmul.cu qmm_kernel): 32
# activation rows x 64 output columns a block, 64 reduction indices a
# stage; a stage of the int8 weight is 64 stored rows, of the packed int4
# weight 32
_BM, _BJ, _BR = 32, 64, 64
_BLOCKS_PER_SM = 2   # split the reduction until this many blocks per SM
# the tensor-core kernel (qmm_tc_kernel, csrc/skinny_gemm.cuh): up to
# TC_ROWS tokens, 64 output columns a block, the stored rows (K, or K / 2 of
# a packed int4 weight: a stage then feeds 2 x 64 reduction rows) in stages
# of 64 through a ring of TC_RING bytes of shared memory; they are split
# until the blocks fill one wave of the card's SMs
TC_ROWS, TC_COLS, TC_STAGE, TC_RING = 64, 64, 64, 96 << 10
# the tensor-core dx (qmm_dx_kernel): a block owns TC_STAGE stored rows (64
# dx columns, or 128 of a packed int4 weight: its low and high nibbles) and
# a pass of up to TC_ROWS dy rows (the passes are a grid dimension, so any M
# runs), and walks the reduction over N in stages of TC_STAGE columns
# through the same ring. A split walks DX_PER stages where the grid then
# keeps between half an SM and two blocks an SM (two fit in shared memory):
# every split leaves an fp32 partial of its tile that the tile's last block
# reads back, so splitting until the blocks fill the card made that sum the
# longest part of the call; an H100 ran GPT-125M's four int4 g128 dx at M 24
# in 0.0416 ms with 3 stages a split against 0.0506 with the card filled
# (PERF.md §6, row 12)
DX_PER = 3
# the activation types the tensor-core routes are built for (here and in
# the grouped GEMM, csrc/skinny_gemm.cuh)
_TC_DTYPES = (torch.bfloat16, torch.float16)


# ---------------------------------------------------------------------------
# int4 nibble packing (split-half layout) and scale layout
# ---------------------------------------------------------------------------


def pack_int4(q):
    """Pack int8 values in [-8, 7] along the in-dim (axis -2): ``[..., K,
    N] -> [..., K/2, N]``, byte ``i`` = row ``i`` (low nibble) | row
    ``K/2 + i`` (high nibble). K must be even."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {k}")
    lo = q[..., :k // 2, :].to(torch.int32) & 0xF
    hi = q[..., k // 2:, :].to(torch.int32) & 0xF
    byte = (hi << 4) | lo                      # 0..255
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: ``[..., K/2, N] int8 -> [..., K, N]
    int8``, each nibble sign-extended from 4-bit two's complement."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def _is_packed(qweight, k: int) -> bool:
    if qweight.shape[0] == k:
        return False
    if qweight.shape[0] * 2 == k:
        return True
    raise ValueError(
        f"quantized weight in-dim {qweight.shape[0]} matches neither K={k} "
        f"(int8) nor K/2={k // 2} (packed int4)")


def _norm_scales(scales, k: int, n: int):
    """Normalize scales to ``[groups, N]``; returns (scales2d, group_size)."""
    s = scales.reshape(1, -1) if scales.dim() == 1 else scales
    if s.shape[-1] != n:
        raise ValueError(f"scales last dim {s.shape[-1]} != out dim {n}")
    groups = s.shape[0]
    if k % groups:
        raise ValueError(f"K={k} not divisible by {groups} scale groups")
    return s, k // groups


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def dequantize_weight(qweight, scales, k=None, out_dtype=torch.float32):
    """The full-precision weight ``[K, N]``: widen and scale per group row,
    both in ``out_dtype``. Packed int4 weights need ``k`` (the logical
    in-dim): without it a ``[K/2, N]`` array is taken as int8."""
    if k is not None and _is_packed(qweight, k):
        qweight = unpack_int4(qweight)
    kk, n = qweight.shape
    s, group = _norm_scales(scales, kk, n)
    return qweight.to(out_dtype) * s.to(out_dtype).repeat_interleave(
        group, dim=0)


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def quant_matmul_reference(x, qweight, scales, bias=None):
    """Dequantize-then-matmul: the weight materializes in ``x``'s dtype,
    the product accumulates in fp32 (fp64 inputs stay fp64), a bias adds
    in that precision, the result is cast to ``x``'s dtype."""
    acc = _acc_dtype(x.dtype)
    w = dequantize_weight(qweight, scales, k=x.shape[-1], out_dtype=x.dtype)
    y = torch.matmul(x.to(acc), w.to(acc))
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype)


def quant_matmul_dx_reference(dy, qweight, scales, k, x_dtype):
    """``dx = dy @ dequant(W)^T`` with the weight in ``x_dtype``, ``dy``
    cast to ``x_dtype`` first, fp32 accumulation, the result in
    ``x_dtype`` — the reference's custom VJP (``_qmm_bwd``)."""
    acc = _acc_dtype(x_dtype)
    w = dequantize_weight(qweight, scales, k=k, out_dtype=x_dtype)
    return (dy.to(x_dtype).to(acc) @ w.to(acc).T).to(x_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

class QmmPlan(NamedTuple):
    route: str      # "tc": qmm_tc_kernel (forward) / qmm_dx_kernel (dx),
    #                 "cc": qmm_kernel
    tiles: int      # output tiles (column tiles x row tiles)
    splits: int     # blocks sharing a tile's reduction
    per: int        # reduction stages a split walks (the last may walk fewer)


def dx_split(tiles, stages, sms):
    """(splits, stages per split) of the tensor-core dx tile's reduction
    over N (``csrc/dx_tile.cuh``; the weight-only and the int8 grouped
    GEMM's dx): ``DX_PER`` stages a split, fewer while the grid of
    ``tiles`` x splits blocks is under ``sms / 2``, more while it is over
    ``2 sms`` (two blocks fit an SM)."""
    per = min(stages, DX_PER)
    while per > 1 and 2 * tiles * -(-stages // per) < sms:
        per -= 1
    while per < stages and tiles * -(-stages // per) > 2 * sms:
        per += 1
    return -(-stages // per), per


def qmm_plan(m, k, n, groups, dtype, packed, bwd, aligned, sms) -> QmmPlan:
    """The launch of one weight-only GEMM: ``m`` rows, a ``[K, N]`` weight
    (``packed`` int4 or int8) with ``groups`` scale rows, forward or dx
    (``bwd``), activations of ``dtype``; ``aligned``: x (or dy), the weight,
    its scales and the output start on 16 bytes; ``sms``: the card's SMs. A
    pure function of its arguments, decided before any launch.

    bf16 or fp16 with the stored rows (K, or K / 2 packed) a multiple of
    ``TC_STAGE``, ``N % 16`` and the scale groups' rows ``% 16`` all 0 (so
    each 16-row step, in either half of a packed weight, lies in one group)
    and aligned pointers take the tensor-core kernels: the forward at ``1 <=
    m <= TC_ROWS`` (``qmm_tc_kernel``; its stages are 64 stored rows, split
    across blocks until they fill the card), the dx at any ``m >= 1``
    (``qmm_dx_kernel``: 64 stored rows x a pass of up to 64 dy rows a tile,
    stages of 64 columns of N, ``DX_PER`` a split where that keeps the grid
    between ``sms / 2`` and ``2 sms`` blocks). Everything else (fp32, the
    forward at more rows, odd widths, unaligned pointers) takes the
    CUDA-core kernel. Each dtype goes to the kernel an H100 ran faster at
    GPT-125M's four serving GEMMs (M 24, A/B in turns, PERF.md §6 rows 9 to
    12): bf16 and fp16 to the tensor-core routes (forward int8 0.0374
    against 0.0763 ms for the four, int4 g128 0.0384 against 0.0735), fp32
    to the CUDA-core kernel (int8 0.0678 against 0.0783 ms on the route's
    FMA branch, which is therefore not built); the CUDA-core kernel splits
    its stages until the blocks fill the card."""
    kw = k // 2 if packed else k
    gs = k // max(groups, 1)
    tc = (kw % TC_STAGE == 0 and n % 16 == 0 and gs % 16 == 0 and aligned
          and dtype in _TC_DTYPES and m >= 1)
    if tc and bwd:
        tiles = kw // TC_STAGE * -(-m // TC_ROWS)
        return QmmPlan("tc", tiles, *dx_split(tiles, -(-n // TC_STAGE), sms))
    if tc and m <= TC_ROWS:
        tiles = -(-n // TC_COLS)
        stages = kw // TC_STAGE
        want = max(1, -(-sms // tiles))
        per = max(1, stages // want)
        return QmmPlan("tc", tiles, -(-stages // per), per)
    rw = 32 if packed else 64
    tiles_j = -(-kw // rw) if bwd else -(-n // _BJ)
    stages = -(-n // _BR) if bwd else -(-kw // rw)
    tiles = tiles_j * -(-m // _BM)
    want = max(1, min(stages, -(-_BLOCKS_PER_SM * sms // tiles)))
    per = -(-stages // want)
    return QmmPlan("cc", tiles, -(-stages // per), per)


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(a, qweight, scales2d, bias, k, n, bwd):
    """One kernel launch: forward ``a = x [M, K]`` -> ``[M, N]``, backward
    ``a = dy [M, N]`` -> ``[M, K]``, in ``a``'s dtype, split partials and
    arrival counters from ``_build.kept`` (kept once grown, so a captured
    CUDA graph holds them). Returns the output, the kernel's name and the
    route (None, None when ``M == 0`` and nothing launched)."""
    code = _build.dtype_code(a.dtype, "quant_matmul")
    packed = _is_packed(qweight, k)
    if qweight.dtype != torch.int8:
        raise TypeError(f"quant_matmul: qweight must be int8, got "
                        f"{qweight.dtype}")
    tensors = [a, qweight, scales2d] + ([] if bias is None else [bias])
    if any(t.device != a.device for t in tensors):
        raise ValueError(f"quant_matmul: all inputs must be on {a.device}")
    a = a.contiguous()
    qweight = qweight.contiguous()
    scales2d = scales2d.to(torch.float32).contiguous()
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    m = a.shape[0]
    name = ("int4" if packed else "int8") + ("_bwd" if bwd else "")
    out = torch.empty((m, k if bwd else n), dtype=a.dtype, device=a.device)
    if m == 0:
        return out, None, None
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, qweight, scales2d, out))
    plan = qmm_plan(m, k, n, scales2d.shape[0], a.dtype, packed, bwd,
                    aligned, _sms(a.device.index))
    ws = None
    if plan.splits > 1:
        ws = _build.kept(a.device, "qmm", plan.splits * m * out.shape[1],
                         torch.float32)
    counters = _build.kept(a.device, "qmm", plan.tiles)
    args = (a.data_ptr(), qweight.data_ptr(), scales2d.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), counters.data_ptr(), m, k,
            n, scales2d.shape[0], plan.splits, plan.per)
    tail = (code, a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream)
    lib = _build.load(_KERNEL, _SIGNATURES)
    if plan.route == "tc" and bwd:
        err = lib.ptt_qmm_dx_tc(*args[:3], *args[4:-2], 4 if packed else 8,
                                *args[-2:], *tail)
    elif plan.route == "tc":
        err = lib.ptt_qmm_tc(*args[:-2], 4 if packed else 8, *args[-2:],
                             *tail)
    else:
        err = getattr(lib, f"ptt_qmm_{name}")(
            *args, int(n % 16 == 0 and qweight.data_ptr() % 16 == 0), *tail)
    _build.check(lib, err, f"quant_matmul {name} ({plan.route}) launch")
    return out, name, plan.route


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_matmul runs on cuda or cpu, got {t.device}")




def quant_matmul_fwd(x2, qweight, scales2d, bias=None):
    """``x2 [M, K] @ dequant(qweight) (+ bias)`` in ``x2``'s dtype: the
    kernel :func:`qmm_plan` picks on a CUDA tensor (``.launches["int8" |
    "int4"]`` counts both routes, ``.tc_launches`` the tensor-core one), the
    reference on a CPU tensor."""
    _check_device(x2)
    if x2.device.type == "cpu":
        return quant_matmul_reference(x2, qweight, scales2d, bias=bias)
    if not kernel_takes(x2.dtype):
        quant_matmul_fwd.twin_routes += 1
        return quant_matmul_reference(x2, qweight, scales2d, bias=bias)
    out, name, route = _launch(x2, qweight, scales2d, bias, x2.shape[1],
                               qweight.shape[1], bwd=False)
    if name:
        quant_matmul_fwd.launches[name] += 1
        quant_matmul_fwd.tc_launches += route == "tc"
    return out


quant_matmul_fwd.launches = {"int8": 0, "int4": 0}
quant_matmul_fwd.tc_launches = 0
quant_matmul_fwd.twin_routes = 0


def quant_matmul_bwd(dy, qweight, scales2d, k, x_dtype):
    """``dx = dy [M, N] @ dequant(qweight)^T`` in ``x_dtype``: the kernel
    :func:`qmm_plan` picks on a CUDA tensor (``.launches["int8" | "int4"]``
    counts both routes, ``.tc_launches`` the tensor-core one), the reference
    on a CPU tensor."""
    _check_device(dy)
    if dy.device.type == "cpu":
        return quant_matmul_dx_reference(dy, qweight, scales2d, k, x_dtype)
    if not kernel_takes(x_dtype):
        quant_matmul_bwd.twin_routes += 1
        return quant_matmul_dx_reference(dy, qweight, scales2d, k, x_dtype)
    out, name, route = _launch(dy.to(x_dtype), qweight, scales2d, None, k,
                               qweight.shape[1], bwd=True)
    if name:
        quant_matmul_bwd.launches[name[:4]] += 1
        quant_matmul_bwd.tc_launches += route == "tc"
    return out


quant_matmul_bwd.launches = {"int8": 0, "int4": 0}
quant_matmul_bwd.tc_launches = 0
quant_matmul_bwd.twin_routes = 0


@torch.library.custom_op("paddle_tpu_torch::quant_matmul", mutates_args=())
def quant_matmul_op(x: torch.Tensor, qweight: torch.Tensor,
                    scales: torch.Tensor, bias: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """Differentiable ``x [M, K] @ dequant(qweight) (+ bias)`` with
    ``[groups, N]`` scales: :func:`quant_matmul_fwd` forward,
    :func:`quant_matmul_bwd` backward."""
    return quant_matmul_fwd(x, qweight, scales, bias)


def _op_setup_context(ctx, inputs, output):
    x, qweight, scales, bias = inputs
    ctx.save_for_backward(qweight, scales)
    ctx.k, ctx.x_dtype = x.shape[1], x.dtype
    ctx.bias_dtype = None if bias is None else bias.dtype


def _op_backward(ctx, dy):
    qweight, scales = ctx.saved_tensors
    dx = None
    if ctx.needs_input_grad[0]:
        dx = quant_matmul_bwd(dy.contiguous(), qweight, scales, ctx.k,
                              ctx.x_dtype)
    db = None
    if ctx.bias_dtype is not None and ctx.needs_input_grad[3]:
        db = dy.float().sum(0).to(ctx.bias_dtype)
    return dx, None, None, db


quant_matmul_op.register_autograd(_op_backward,
                                  setup_context=_op_setup_context)


def quant_matmul(x, qweight, scales, bias=None):
    """Weight-only quantized GEMM ``y = x @ dequant(qweight) + bias`` with
    the weight staying int8 (or packed int4) on the device.

    x: ``[..., K]`` fp32/bf16/fp16; qweight: ``[K, N]`` int8 or ``[K/2, N]``
    packed int4 (see :func:`pack_int4`); scales: ``[N]`` per channel or
    ``[groups, N]`` per group (``K % groups == 0``); bias: ``[N]`` or None.
    Returns ``[..., N]`` in x's dtype; differentiable in x and bias.
    Where no gradient can flow (grad mode off, or neither x nor bias
    requires grad) the forward wrapper runs without the autograd op, whose
    dispatch costs more host time than the kernel takes.
    """
    k = x.shape[-1]
    n = qweight.shape[-1]
    _is_packed(qweight, k)
    scales2d, _ = _norm_scales(scales, k, n)
    lead = x.shape[:-1]
    m = int(math.prod(lead)) if lead else 1
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or (bias is not None and bias.requires_grad))
    fn = quant_matmul_op if needs_grad else quant_matmul_fwd
    y = fn(x.reshape(m, k), qweight, scales2d, bias)
    return y.reshape(*lead, n)
