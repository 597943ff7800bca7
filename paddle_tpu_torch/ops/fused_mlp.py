"""Fused LayerNorm and tanh-GELU, forward and backward — the MLP-block
kernels of the ``fused_mlp`` training path.

Port of ``paddle_tpu/ops/pallas/fused_mlp.py``:

- LayerNorm over the last axis with fp32 statistics, optionally with a
  residual in and out (``s = x + residual``, ``y = LN(s)``, the pre-LN
  block's residual add and norm in one pass); the mean and rstd are saved
  so the backward does not reduce the forward again;
- the tanh-approximate GELU with an optional bias epilogue; its backward
  recomputes ``u = x + bias`` and the tanh from the saved GEMM output.

On a CUDA tensor the wrappers :func:`ln_fwd`, :func:`ln_bwd`,
:func:`gelu_fwd` and :func:`gelu_bwd` launch the hand-written kernels of
``csrc/fused_mlp.cu`` (or raise), one per TPU kernel, each counting its
launches in ``.launches``; on a CPU tensor they run the plain versions
:func:`ln_fwd_reference`, :func:`ln_bwd_reference`,
:func:`gelu_fwd_reference` and :func:`gelu_bwd_reference`, which follow
the kernels' casts (fp32 compute, one cast at the end). The kernels take
any number of rows and any width up to :data:`MAX_H` (the Pallas kernels
need whole row blocks and widths that are multiples of 128, and fall back
to the XLA reference otherwise; the port has no fallback).

Four custom ops (``paddle_tpu_torch::fused_layer_norm``,
``::fused_ln_residual``, ``::fused_gelu``, ``::fused_bias_gelu``) carry
the autograd formulas of the reference's custom VJPs; their backwards run
the backward kernels. The LN ops return ``mean`` and ``rstd`` as outputs,
so a selective checkpoint policy can keep them (``models/gpt_spmd.py``,
``remat_save_ln``). The public entries :func:`fused_layer_norm`,
:func:`fused_ln_residual`, :func:`fused_gelu` and :func:`fused_bias_gelu`
keep the reference's signatures; where no gradient can flow they call the
wrappers without the ops, whose dispatch costs more host time than a small
kernel. :func:`ln_reference` and :func:`gelu_reference` are the twins of
the reference's oracles.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from ._build import kernel_takes  # noqa: F401 (the family's predicate)

_KERNEL = "fused_mlp"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptt_ln_fwd": [_P] * 8 + [_I, _I, ctypes.c_float, _I, _I, _I, _P],
    "ptt_ln_bwd": [_P] * 11 + [_I] * 11 + [_P],
    "ptt_gelu_fwd": [_P] * 3 + [_I] * 7 + [_P],
    "ptt_gelu_bwd": [_P] * 7 + [_I] * 7 + [_P],
}
MAX_H = 8192          # the LN kernels' widest row (csrc/fused_mlp.cu kMaxH)
# most threads of an LN backward block by 16-byte chunks a thread holds
# (csrc/fused_mlp.cu kLnBwdThreads, kLnBwdWide): one block an SM at up to
# 80 / 128 registers a thread; four chunks only for fp32
LN_BWD_THREADS = {1: 768, 2: 512, 4: 512}
LN_BWD_GROUPS = 15    # row groups a block when a row takes more than a warp
                      # (a named barrier each: ids 1-15)
LN_BWD_BATCH = 8      # partial rows a thread of the summing block has in
                      # flight (csrc/fused_mlp.cu kSumBatch)
GELU_THREADS = 128    # threads of a GELU block (csrc/fused_mlp.cu kGeluThreads)
GELU_BLOCKS_PER_SM = 8  # GELU blocks an SM holds (64 registers a thread)
GELU_STRIP = 16       # widest strip of a GELU block, in 16-byte chunks
GELU_ROWS = 2         # rows a GELU thread walks (without dbias partials)
GELU_PART_SHARE = 0.005  # dbias partial rows: at most this share of the
                         # bias backward's bytes (unless one band)

_K0 = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------


def ln_fwd_reference(x, residual, gamma, beta, eps):
    """``[rows, h]`` LayerNorm as the forward kernel computes it: ``s = x
    (+ residual)`` in fp32, two-pass statistics, ``y = (s - mean) * rstd *
    gamma + beta`` in fp32 cast once to x's dtype. Returns ``(y, mean,
    rstd)``, or ``(y, s, mean, rstd)`` with a residual, where ``s`` is
    rounded to x's dtype after the statistics were taken from fp32 ``s``;
    ``mean`` and ``rstd`` are ``[rows]`` fp32."""
    s = x.float() if residual is None else x.float() + residual.float()
    mean = s.mean(-1)
    c = s - mean[:, None]
    rstd = torch.rsqrt((c * c).mean(-1) + eps)
    y = (c * rstd[:, None] * gamma.float() + beta.float()).to(x.dtype)
    if residual is None:
        return y, mean, rstd
    return y, s.to(x.dtype), mean, rstd


def ln_bwd_reference(dy, dso, s, mean, rstd, gamma):
    """The LN backward kernel's function: ``(dx, dgamma, dbeta)`` with
    ``dx`` in ``s``'s dtype (``+ dso`` in fp32 when given) and the two
    parameter gradients as fp32 sums over the rows."""
    dy = dy.float()
    xhat = (s.float() - mean[:, None]) * rstd[:, None]
    dxhat = dy * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    ds = rstd[:, None] * (dxhat - m1 - xhat * m2)
    if dso is not None:
        ds = ds + dso.float()
    return ds.to(s.dtype), (dy * xhat).sum(0), dy.sum(0)


def _u32(x, bias):
    return x.float() if bias is None else x.float() + bias.float()


def gelu_fwd_reference(x, bias=None):
    """tanh-GELU of ``x (+ bias)`` in fp32, cast once to x's dtype (the
    forward kernel's casts)."""
    u = _u32(x, bias)
    t = torch.tanh(_K0 * (u + _A * u * u * u))
    return (0.5 * u * (1.0 + t)).to(x.dtype)


def gelu_bwd_reference(dy, x, bias=None):
    """``(dx, dbias)``: ``dx = dy * gelu'(x + bias)`` in fp32, cast to x's
    dtype; ``dbias`` the fp32 row sum of the uncast ``dx`` (None without a
    bias)."""
    u = _u32(x, bias)
    u2 = u * u
    t = torch.tanh(_K0 * (u + _A * u * u2))
    du = dy.float() * (0.5 * (1.0 + t)
                       + 0.5 * u * (1.0 - t * t) * _K0 * (1.0 + 3.0 * _A * u2))
    return du.to(x.dtype), None if bias is None else du.sum(0)


def ln_reference(x, g, b, eps=1e-5):
    """Twin of the reference's ``ln_reference``: fp32 statistics and
    affine over the last axis, cast to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def gelu_reference(x, b=None):
    """Twin of the reference's ``gelu_reference`` (``jax.nn.gelu`` with
    the tanh approximation), computed op by op in x's dtype: in bf16 every
    step rounds, so it is not the kernels' oracle (that is
    :func:`gelu_fwd_reference`, fp32 with one cast)."""
    u = x if b is None else x + b
    k = torch.tensor(math.sqrt(2 / math.pi), dtype=u.dtype)
    return u * (0.5 * (1.0 + torch.tanh(k * (u + 0.044715 * u ** 3))))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count




def _check(what, t, params=(), stats=()):
    """The dtype code of ``t [rows, h]``; raises on what the kernels do not
    take: a dtype other than fp32 / bf16 / fp16, parameters or gradients of
    another dtype or device than ``t``, rows that are not contiguous,
    statistics that are not ``[rows]`` fp32."""
    code = _build.dtype_code(t.dtype, what)
    if t.dim() != 2:
        raise ValueError(f"{what} takes [rows, h], got {tuple(t.shape)}")
    for p in (t, *params, *stats):
        if p is None:
            continue
        if p.device != t.device:
            raise ValueError(f"{what}: all inputs must be on {t.device}")
        if not p.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    for p in params:
        if p is not None and p.dtype != t.dtype:
            raise TypeError(f"{what}: a {p.dtype} input with {t.dtype} rows")
    for p in stats:
        if p.dtype != torch.float32 or tuple(p.shape) != (t.shape[0],):
            raise ValueError(f"{what}: statistics must be [rows] float32")
    return code


def _vec(t, *others) -> int:
    """1 when every row of every tensor starts on a 16-byte boundary."""
    ok = (t.shape[-1] * t.element_size()) % 16 == 0
    return int(ok and all(o.data_ptr() % 16 == 0
                          for o in (t, *others) if o is not None))


def _vec_param(p, h):
    if p.dim() != 1 or p.shape[0] != h:
        raise ValueError(f"parameter of shape {tuple(p.shape)} for rows of "
                         f"width {h}")
    return p


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ln_fwd(x, residual, gamma, beta, eps):
    """LayerNorm of ``x [rows, h] (+ residual)``: the kernel on a CUDA
    tensor (``.launches`` counts it), :func:`ln_fwd_reference` on a CPU
    tensor. Returns ``(y, mean, rstd)`` or, with a residual, ``(y, s,
    mean, rstd)``. ``gamma`` and ``beta`` are ``[h]`` in x's dtype."""
    if x.device.type == "cpu":
        return ln_fwd_reference(x, residual, gamma, beta, eps)
    if not kernel_takes(x.dtype):
        ln_fwd.twin_routes += 1
        return ln_fwd_reference(x, residual, gamma, beta, eps)
    rows, h = x.shape
    for p in (gamma, beta):
        _vec_param(p, h)
    code = _check("fused_mlp ln_fwd", x, (residual, gamma, beta))
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if h > MAX_H:
        raise ValueError(f"fused_mlp ln_fwd takes h <= {MAX_H}, got {h}")
    y = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        lib = _build.load(_KERNEL, _SIGNATURES)
        err = lib.ptt_ln_fwd(
            x.data_ptr(), _ptr(residual), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), _ptr(s), mean.data_ptr(), rstd.data_ptr(), rows, h,
            float(eps), _vec(x, residual, gamma, beta, y, s), code,
            x.device.index, _stream(x))
        _build.check(lib, err, "fused_mlp ln_fwd launch")
        ln_fwd.launches += 1
    return (y, mean, rstd) if s is None else (y, s, mean, rstd)


ln_fwd.launches = 0
ln_fwd.twin_routes = 0


class LnBwdPlan(NamedTuple):
    """An LN backward launch: ``blocks`` blocks of ``groups`` row groups of
    ``threads`` threads; block b owns rows ``[b band, (b + 1) band)``, its
    group k the band's rows k, k + groups, ...; a thread holds ``per``
    16-byte chunks of each. The blocks' partial sums are added in sets of
    ``set`` blocks, then the ``sets`` sets."""
    per: int
    threads: int
    groups: int
    band: int
    blocks: int
    set: int
    sets: int

    def scratch(self, h: int) -> int:
        """fp32 values of the partial rows: one ``[2, h]`` a block and a
        set."""
        return (self.blocks + self.sets) * 2 * h


@functools.lru_cache(maxsize=256)
def ln_bwd_plan(rows: int, h: int, elt: int, sms: int) -> LnBwdPlan:
    """The LN backward kernel's launch for ``[rows, h]`` elements of ``elt``
    bytes on a card of ``sms`` SMs.

    A row's group is the fewest whole warps whose threads hold it at the
    fewest 16-byte chunks a thread that fit (the fewest registers a
    thread, so the most threads an SM); a block as many groups as ``LN_BWD_THREADS``
    allows; at most one block an SM (a persistent grid: one fp32 partial
    row a block) and no more blocks than full groups need, so a small
    input takes few blocks and few partial rows; each block owns one
    contiguous band of rows. The partial rows are added in sets of
    ceil(sqrt(blocks)) blocks, then the sets, so no block adds more than
    about sqrt(blocks) rows; up to ``LN_BWD_BATCH`` blocks in one set (one
    round of loads, no second arrival)."""
    if rows <= 0 or not 0 < h <= MAX_H:
        raise ValueError(f"fused_mlp ln_bwd takes rows > 0 and 0 < h <= "
                         f"{MAX_H}, got [{rows}, {h}]")
    chunks = -(-h // (16 // elt))
    for per in (1, 2, 4) if elt == 4 else (1, 2):
        threads = 32 * -(-chunks // (32 * per))
        if threads <= LN_BWD_THREADS[per]:
            break
    groups = LN_BWD_THREADS[per] // threads
    if threads > 32:
        groups = min(groups, LN_BWD_GROUPS)
    blocks = min(sms, -(-rows // groups))
    band = -(-rows // blocks)
    blocks = -(-rows // band)
    set_ = blocks if blocks <= LN_BWD_BATCH else math.isqrt(blocks - 1) + 1
    return LnBwdPlan(per, threads, groups, band, blocks, set_,
                     -(-blocks // set_))


def ln_bwd(dy, dso, s, mean, rstd, gamma):
    """``(dx, dgamma, dbeta)`` of the LayerNorm whose input was ``s [rows,
    h]`` (+ ``dso``, the gradient reaching ``s`` itself): the kernel on a
    CUDA tensor, one launch that also sums dgamma and dbeta (``.launches``
    counts it), :func:`ln_bwd_reference` on a CPU tensor. dx in s's dtype;
    dgamma, dbeta fp32."""
    if dy.device.type == "cpu":
        return ln_bwd_reference(dy, dso, s, mean, rstd, gamma)
    if not kernel_takes(s.dtype):
        ln_bwd.twin_routes += 1
        return ln_bwd_reference(dy, dso, s, mean, rstd, gamma)
    rows, h = s.shape
    _vec_param(gamma, h)
    code = _check("fused_mlp ln_bwd", s, (dy, dso, gamma), (mean, rstd))
    for t in (dy, dso):
        if t is not None and t.shape != s.shape:
            raise ValueError(f"gradient {tuple(t.shape)} does not fit "
                             f"{tuple(s.shape)}")
    if h > MAX_H:
        raise ValueError(f"fused_mlp ln_bwd takes h <= {MAX_H}, got {h}")
    dx = torch.empty_like(s)
    if not rows:
        zeros = torch.zeros(h, dtype=torch.float32, device=s.device)
        return dx, zeros, zeros.clone()
    plan = ln_bwd_plan(rows, h, s.element_size(), _sms(s.device.index))
    dg = torch.empty(h, dtype=torch.float32, device=s.device)
    db = torch.empty_like(dg)
    # the partial rows and arrival counters, kept per device
    part = _build.kept(s.device, "ln_bwd", plan.scratch(h), torch.float32)
    counters = _build.kept(s.device, "ln_bwd", plan.sets + 1)
    lib = _build.load(_KERNEL, _SIGNATURES)
    err = lib.ptt_ln_bwd(
        dy.data_ptr(), _ptr(dso), s.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), gamma.data_ptr(), dx.data_ptr(), dg.data_ptr(),
        db.data_ptr(), part.data_ptr(), counters.data_ptr(), rows, h,
        plan.per, plan.threads, plan.groups, plan.band, plan.blocks,
        plan.set, _vec(s, dy, dso, gamma, dx), code, s.device.index,
        _stream(s))
    _build.check(lib, err, "fused_mlp ln_bwd launch")
    ln_bwd.launches += 1
    return dx, dg, db


ln_bwd.launches = 0
ln_bwd.twin_routes = 0


class GeluPlan(NamedTuple):
    """A GELU launch: a grid of ``strips x bands`` blocks; a block owns
    ``strip`` 16-byte column chunks of each of ``band`` rows."""
    strip: int
    band: int
    strips: int
    bands: int


def gelu_plan(rows: int, n: int, elt: int, sms: int,
              partials: bool = False) -> GeluPlan:
    """The GELU kernels' launch for ``[rows, n]`` elements of ``elt`` bytes
    on a card of ``sms`` SMs; ``partials``: the bias backward, which
    writes one fp32 dbias row of ``n`` per band.

    Many small blocks, each thread walking ``GELU_ROWS`` rows, so the
    card's block scheduler keeps every SM fed to the end (one persistent
    wave of long bands is slower: its blocks end unevenly; ``gelu_plans.py``
    times both). With partials the bands stay within ``GELU_PART_SHARE``
    of the backward's bytes (``3 * rows * n * elt``), so a band is longer.
    Where that leaves less than a wave of blocks, the strip narrows
    (more strips, more row lanes a block) down to one chunk, or until a
    block would have more lanes than there are rows."""
    chunks = -(-n // (16 // elt))
    target = sms * GELU_BLOCKS_PER_SM
    max_bands = (max(1, int(GELU_PART_SHARE * 3 * rows * elt / 4))
                 if partials else rows)
    strip = min(GELU_STRIP, 1 << (chunks - 1).bit_length())
    while True:
        strips = -(-chunks // strip)
        lanes = GELU_THREADS // strip
        bands = min(-(-rows // (lanes * GELU_ROWS)), max_bands)
        if strips * bands >= target or strip == 1 or 2 * lanes > rows:
            break
        strip //= 2
    band = -(-rows // bands)
    return GeluPlan(strip, band, strips, -(-rows // band))


def gelu_fwd(x, bias=None):
    """tanh-GELU of ``x [rows, n] (+ bias [n])``: the kernel on a CUDA
    tensor (``.launches`` counts it), :func:`gelu_fwd_reference` on a CPU
    tensor."""
    if x.device.type == "cpu":
        return gelu_fwd_reference(x, bias)
    if not kernel_takes(x.dtype):
        gelu_fwd.twin_routes += 1
        return gelu_fwd_reference(x, bias)
    rows, n = x.shape
    if bias is not None:
        _vec_param(bias, n)
    code = _check("fused_mlp gelu_fwd", x, (bias,))
    y = torch.empty_like(x)
    if rows and n:
        vec = _vec(x, bias, y)
        plan = gelu_plan(rows, n, x.element_size(), _sms(x.device.index))
        lib = _build.load(_KERNEL, _SIGNATURES)
        err = lib.ptt_gelu_fwd(x.data_ptr(), _ptr(bias), y.data_ptr(), rows,
                               n, plan.strip, plan.band, vec, code,
                               x.device.index, _stream(x))
        _build.check(lib, err, "fused_mlp gelu_fwd launch")
        gelu_fwd.launches += 1
    return y


gelu_fwd.launches = 0
gelu_fwd.twin_routes = 0


def gelu_bwd(dy, x, bias=None):
    """``(dx, dbias)`` of :func:`gelu_fwd` at ``x (+ bias)``: the kernel on
    a CUDA tensor (``.launches`` counts it; dbias summed in the kernel, in
    a fixed order), :func:`gelu_bwd_reference` on a CPU tensor. dx in x's
    dtype; dbias fp32 (None without a bias)."""
    if dy.device.type == "cpu":
        return gelu_bwd_reference(dy, x, bias)
    if not kernel_takes(x.dtype):
        gelu_bwd.twin_routes += 1
        return gelu_bwd_reference(dy, x, bias)
    rows, n = x.shape
    if bias is not None:
        _vec_param(bias, n)
    code = _check("fused_mlp gelu_bwd", x, (dy, bias))
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    dx = torch.empty_like(x)
    if not (rows and n):
        return dx, (None if bias is None else torch.zeros(
            n, dtype=torch.float32, device=x.device))
    vec = _vec(x, dy, bias, dx)
    plan = gelu_plan(rows, n, x.element_size(), _sms(x.device.index),
                     partials=bias is not None)
    part = dbias = counters = None
    if bias is not None:
        part = torch.empty((plan.bands, n), dtype=torch.float32,
                           device=x.device)
        dbias = torch.empty(n, dtype=torch.float32, device=x.device)
        counters = _build.kept(x.device, "gelu_bwd", plan.strips)
    lib = _build.load(_KERNEL, _SIGNATURES)
    err = lib.ptt_gelu_bwd(dy.data_ptr(), x.data_ptr(), _ptr(bias),
                           dx.data_ptr(), _ptr(part), _ptr(dbias),
                           _ptr(counters), rows, n, plan.strip, plan.band,
                           vec, code, x.device.index, _stream(x))
    _build.check(lib, err, "fused_mlp gelu_bwd launch")
    gelu_bwd.launches += 1
    return dx, dbias


gelu_bwd.launches = 0
gelu_bwd.twin_routes = 0


# ---------------------------------------------------------------------------
# custom ops with autograd (the reference's custom VJPs)
# ---------------------------------------------------------------------------


@torch.library.custom_op("paddle_tpu_torch::fused_layer_norm",
                         mutates_args=())
def fused_layer_norm_op(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable ``(y, mean, rstd)`` of ``x [rows, h]``: :func:`ln_fwd`
    forward, :func:`ln_bwd` backward (mean and rstd get no gradient)."""
    return ln_fwd(x, None, gamma, beta, eps)


def _ln_setup(ctx, inputs, output):
    x, gamma, _, _ = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, mean, rstd, gamma)
    ctx.mark_non_differentiable(mean, rstd)


def _ln_backward(ctx, dy, _dmean, _drstd):
    x, mean, rstd, gamma = ctx.saved_tensors
    dx, dg, db = ln_bwd(dy.contiguous(), None, x, mean, rstd, gamma)
    return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


fused_layer_norm_op.register_autograd(_ln_backward, setup_context=_ln_setup)


@torch.library.custom_op("paddle_tpu_torch::fused_ln_residual",
                         mutates_args=())
def fused_ln_residual_op(x: torch.Tensor, residual: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, eps: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Differentiable ``(y, s, mean, rstd)`` with ``s = x + residual``:
    :func:`ln_fwd` forward, :func:`ln_bwd` backward with ``s``'s own
    gradient added in the kernel; x and the residual get the same
    gradient."""
    return ln_fwd(x, residual, gamma, beta, eps)


def _ln_res_setup(ctx, inputs, output):
    gamma = inputs[2]
    _, s, mean, rstd = output
    ctx.save_for_backward(s, mean, rstd, gamma)
    ctx.mark_non_differentiable(mean, rstd)


def _ln_res_backward(ctx, dy, ds, _dmean, _drstd):
    s, mean, rstd, gamma = ctx.saved_tensors
    dx, dg, db = ln_bwd(dy.contiguous(), ds.contiguous(), s, mean, rstd,
                        gamma)
    return dx, dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


fused_ln_residual_op.register_autograd(_ln_res_backward,
                                       setup_context=_ln_res_setup)


@torch.library.custom_op("paddle_tpu_torch::fused_gelu", mutates_args=())
def fused_gelu_op(x: torch.Tensor) -> torch.Tensor:
    """Differentiable tanh-GELU of ``x [rows, n]``: :func:`gelu_fwd`
    forward, :func:`gelu_bwd` backward."""
    return gelu_fwd(x)


def _gelu_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _gelu_backward(ctx, dy):
    (x,) = ctx.saved_tensors
    return gelu_bwd(dy.contiguous(), x)[0]


fused_gelu_op.register_autograd(_gelu_backward, setup_context=_gelu_setup)


@torch.library.custom_op("paddle_tpu_torch::fused_bias_gelu", mutates_args=())
def fused_bias_gelu_op(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable ``gelu(x + bias)``: :func:`gelu_fwd` forward,
    :func:`gelu_bwd` backward, which recomputes ``x + bias`` from the
    saved ``x`` (the GEMM output) — no activation is saved."""
    return gelu_fwd(x, bias)


def _bias_gelu_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _bias_gelu_backward(ctx, dy):
    x, bias = ctx.saved_tensors
    dx, db = gelu_bwd(dy.contiguous(), x, bias)
    return dx, db.to(bias.dtype)


fused_bias_gelu_op.register_autograd(_bias_gelu_backward,
                                     setup_context=_bias_gelu_setup)


# ---------------------------------------------------------------------------
# public entries ([..., h] tensors; leading dims flattened to rows)
# ---------------------------------------------------------------------------


def _flat(x):
    return x.reshape(-1, x.shape[-1]).contiguous()


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def fused_layer_norm(x, gamma, beta, eps=1e-5, use_kernel=None):
    """LayerNorm over the last axis with fp32 statistics, in one kernel.

    ``use_kernel``: None or True = the kernel on a CUDA tensor and its
    plain version on a CPU tensor, through the differentiable op; False =
    :func:`ln_reference`."""
    if use_kernel is False:
        return ln_reference(x, gamma, beta, eps)
    x2 = _flat(x)
    if _needs_grad(x, gamma, beta):
        y = fused_layer_norm_op(x2, gamma, beta, float(eps))[0]
    else:
        y = ln_fwd(x2, None, gamma, beta, float(eps))[0]
    return y.reshape(x.shape)


def fused_ln_residual(x, residual, gamma, beta, eps=1e-5, use_kernel=None):
    """``s = x + residual; y = LN(s)`` in one kernel. Returns ``(y, s)``:
    s is the new residual stream for the following branch. ``use_kernel``
    as :func:`fused_layer_norm`."""
    if use_kernel is False:
        s = x + residual
        return ln_reference(s, gamma, beta, eps), s
    x2, r2 = _flat(x), _flat(residual)
    if _needs_grad(x, residual, gamma, beta):
        y, s = fused_ln_residual_op(x2, r2, gamma, beta, float(eps))[:2]
    else:
        y, s = ln_fwd(x2, r2, gamma, beta, float(eps))[:2]
    return y.reshape(x.shape), s.reshape(x.shape)


def fused_gelu(x, use_kernel=None):
    """tanh-approximate GELU in one kernel (``use_kernel`` as
    :func:`fused_layer_norm`; False = :func:`gelu_reference`)."""
    if use_kernel is False:
        return gelu_reference(x)
    x2 = _flat(x)
    fn = fused_gelu_op if _needs_grad(x) else gelu_fwd
    return fn(x2).reshape(x.shape)


def fused_bias_gelu(x, bias: Optional[torch.Tensor], use_kernel=None):
    """``gelu(x + bias)`` (tanh approximation) in one kernel: the GEMM
    epilogue. ``bias=None`` is :func:`fused_gelu`."""
    if bias is None:
        return fused_gelu(x, use_kernel=use_kernel)
    if use_kernel is False:
        return gelu_reference(x, bias)
    x2 = _flat(x)
    fn = fused_bias_gelu_op if _needs_grad(x, bias) else gelu_fwd
    return fn(x2, bias).reshape(x.shape)
