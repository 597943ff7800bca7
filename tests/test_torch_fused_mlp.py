"""Port fused-MLP ops (``ops/fused_mlp.py``) against the JAX package's
``ops/pallas/fused_mlp.py`` on the CPU.

The same seeded numpy inputs go through the reference's Pallas kernels in
interpret mode (``use_kernel=True``) and the port's public entries, whose
custom ops run the kernels' plain versions on a CPU tensor; ``jax.vjp``
with a seeded cotangent against ``torch.autograd.grad``. Tolerances: fp32
max abs error <= 1e-5 of the tensor's max ``|want|`` (the same fp32 math,
sums in another order); bf16 each row's max abs error <= 1e-2 of the
row's max ``|want|`` (both sides round an fp32 result once, so an element
may differ by one bf16 step, <= 2^-7 of it). Odd row counts and widths
that are no multiple of 128, which the port's kernels take and the
reference's kernel does not on a TPU, are held against the reference's
``ln_reference`` / ``gelu_reference`` and their ``jax.vjp``.

The CUDA GELU kernels compute ``0.5 u (1 + tanh z)`` as the equal ``u
sigma(2z)`` (one ``ex2`` and one reciprocal). That form is written out here
in fp32 torch, with the kernel's constants, exponent clamp and flush of
subnormal reciprocals, and held to the same tolerances against the twins
and the interpret-mode JAX kernels over ``u`` in +-30 plus +-1e4, +-inf and
NaN: the non-finite entries must sit at the same places with the same
values (NaN, +inf, -inf), and the finite ones are held over the finite
entries' max. The kernels' launch plan (``gelu_plan``) is checked at
``sms=132`` without a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_mlp as jfm
from paddle_tpu_torch.incubate.nn import functional as FI
from paddle_tpu_torch.ops import fused_mlp as tfm

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-5


def _np(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(a, leg):
    jd, td = DTYPES[leg]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td).requires_grad_()


def _assert_close(got, want, leg, what=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.isfinite(want).all() or not np.isfinite(got).all():
        for test in (np.isnan, np.isposinf, np.isneginf):
            assert np.array_equal(test(got), test(want)), (what, test)
        got, want = (np.where(np.isfinite(want), a, 0) for a in (got, want))
    diff = np.abs(got - want)
    if leg == "fp32":
        err = diff.max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-5, (what, err)
        return
    rows = diff.reshape(-1, want.shape[-1])
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(-1)
    err = (rows.max(-1) / np.maximum(scale, 1e-30)).max()
    assert err <= 1e-2, (what, err)


def _check_vjp(jfn, tfn, arrays, cots, leg):
    """Forward and VJP of ``jfn`` (jax) against ``tfn`` (torch) on the same
    numpy ``arrays``, with the numpy cotangents ``cots``."""
    jx, tx = zip(*(_pair(a, leg) for a in arrays))
    want, vjp = jax.vjp(jfn, *jx)
    got = tfn(*tx)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, leg, f"out {i}")
    jc, tc = zip(*(_pair(c, leg) for c in cots))
    want_grads = vjp(jc if len(jc) > 1 else jc[0])
    got_grads = torch.autograd.grad(got, tx, [t.detach() for t in tc])
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        assert g.dtype == tx[i].dtype
        _assert_close(g, w, leg, f"grad {i}")


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 128), (2, 32, 256)])
def test_layer_norm_matches_jax_kernel(leg, shape):
    rng = np.random.RandomState(0)
    h = shape[-1]
    arrays = (_np(rng, shape), 1 + _np(rng, (h,), 0.1), _np(rng, (h,), 0.1))
    _check_vjp(lambda x, g, b: jfm.fused_layer_norm(x, g, b, EPS, True),
               lambda x, g, b: tfm.fused_layer_norm(x, g, b, EPS),
               arrays, (_np(rng, shape),), leg)


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
def test_ln_residual_matches_jax_kernel_both_cotangents(leg):
    """``(y, s)`` and the backward with both cotangents: the residual stream
    ``s`` carries its own gradient, added inside the kernel, and x and the
    residual get the same gradient."""
    rng = np.random.RandomState(1)
    shape, h = (96, 128), 128
    arrays = (_np(rng, shape), _np(rng, shape), 1 + _np(rng, (h,), 0.1),
              _np(rng, (h,), 0.1))
    _check_vjp(lambda x, r, g, b: jfm.fused_ln_residual(x, r, g, b, EPS,
                                                        True),
               lambda x, r, g, b: tfm.fused_ln_residual(x, r, g, b, EPS),
               arrays, (_np(rng, shape), _np(rng, shape)), leg)


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
def test_gelu_matches_jax_kernel(leg):
    rng = np.random.RandomState(2)
    shape = (64, 256)
    _check_vjp(lambda x: jfm.fused_gelu(x, True),
               lambda x: tfm.fused_gelu(x),
               (_np(rng, shape, 2.0),), (_np(rng, shape),), leg)


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 512), (2, 16, 256)])
def test_bias_gelu_matches_jax_kernel(leg, shape):
    rng = np.random.RandomState(3)
    n = shape[-1]
    _check_vjp(lambda x, b: jfm.fused_bias_gelu(x, b, True),
               lambda x, b: tfm.fused_bias_gelu(x, b),
               (_np(rng, shape, 2.0), _np(rng, (n,), 0.5)),
               (_np(rng, shape),), leg)


@pytest.mark.parametrize("shape", [(77, 200), (3, 5, 40), (1, 8)])
def test_odd_shapes_match_jax_references(shape):
    """Rows and widths the Pallas kernels do not tile: the port's ops
    against ``ln_reference`` / ``gelu_reference`` and their VJPs (fp32)."""
    rng = np.random.RandomState(4)
    h = shape[-1]
    g, b = 1 + _np(rng, (h,), 0.1), _np(rng, (h,), 0.1)
    x, r, dy, ds = (_np(rng, shape) for _ in range(4))
    _check_vjp(lambda x_, g_, b_: jfm.ln_reference(x_, g_, b_, EPS),
               lambda x_, g_, b_: tfm.fused_layer_norm(x_, g_, b_, EPS),
               (x, g, b), (dy,), "fp32")
    _check_vjp(lambda x_, r_, g_, b_: (jfm.ln_reference(x_ + r_, g_, b_, EPS),
                                       x_ + r_),
               lambda x_, r_, g_, b_: tfm.fused_ln_residual(x_, r_, g_, b_,
                                                            EPS),
               (x, r, g, b), (dy, ds), "fp32")
    _check_vjp(lambda x_, b_: jfm.gelu_reference(x_, b_),
               lambda x_, b_: tfm.fused_bias_gelu(x_, b_),
               (2 * x, b), (dy,), "fp32")


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
def test_references_twin_jax_oracles(leg):
    """``ln_reference`` and ``gelu_reference`` (op by op in x's dtype) are
    the twins of the reference's oracles; the ``use_kernel=False`` entries
    take them."""
    rng = np.random.RandomState(5)
    x, g, b = _np(rng, (40, 96)), 1 + _np(rng, (96,), 0.1), _np(rng, (96,))
    jx, tx = _pair(x, leg)
    jg, tg = _pair(g, leg)
    jb, tb = _pair(b, leg)
    _assert_close(tfm.ln_reference(tx, tg, tb, EPS),
                  jfm.ln_reference(jx, jg, jb, EPS), leg)
    _assert_close(tfm.fused_layer_norm(tx, tg, tb, EPS, use_kernel=False),
                  jfm.ln_reference(jx, jg, jb, EPS), leg)
    _assert_close(tfm.gelu_reference(tx, tb), jfm.gelu_reference(jx, jb), leg)
    _assert_close(tfm.fused_bias_gelu(tx, tb, use_kernel=False),
                  jfm.gelu_reference(jx, jb), leg)
    _assert_close(tfm.gelu_reference(tx), jfm.gelu_reference(jx), leg)


def test_plain_versions_follow_the_kernel_casts():
    """bf16: statistics from the unrounded fp32 ``s``, ``s`` written rounded;
    GELU in fp32 with one cast (not op by op like ``gelu_reference``)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_np(rng, (16, 64))).bfloat16()
    r = torch.from_numpy(_np(rng, (16, 64))).bfloat16()
    g, b = torch.ones(64, dtype=torch.bfloat16), torch.zeros(
        64, dtype=torch.bfloat16)
    y, s, mean, rstd = tfm.ln_fwd_reference(x, r, g, b, EPS)
    s32 = x.float() + r.float()
    assert torch.equal(s, s32.bfloat16())
    torch.testing.assert_close(mean, s32.mean(-1), rtol=0, atol=1e-6)
    assert mean.dtype == rstd.dtype == torch.float32
    assert y.dtype == torch.bfloat16
    u = torch.from_numpy(_np(rng, (16, 64), 3.0)).bfloat16()
    want = torch.nn.functional.gelu(u.float(), approximate="tanh").bfloat16()
    assert (tfm.gelu_fwd_reference(u).float() - want.float()).abs().max() \
        <= 2 ** -7 * want.float().abs().max()


def test_wrapper_checks_raise():
    """What the kernels do not take raises before any launch (the checks
    are device-independent; the launch itself needs a card)."""
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tfm._check("ln", x.double())
    with pytest.raises(TypeError, match="rows"):
        tfm._check("ln", x, (torch.zeros(8, dtype=torch.bfloat16),))
    with pytest.raises(ValueError, match="contiguous"):
        tfm._check("ln", torch.zeros(8, 4).t())
    with pytest.raises(ValueError, match=r"\[rows, h\]"):
        tfm._check("ln", torch.zeros(2, 4, 8))
    with pytest.raises(ValueError, match="statistics"):
        tfm._check("ln", x, (), (torch.zeros(4, dtype=torch.float64),))
    with pytest.raises(ValueError, match="width"):
        tfm._vec_param(torch.zeros(7), 8)
    assert tfm._vec(torch.zeros(4, 8)) == 1
    assert tfm._vec(torch.zeros(4, 6)) == 0        # 24-byte rows
    assert tfm._check("ln", x) == 0
    assert tfm._check("ln", x.bfloat16()) == 1
    assert tfm._check("ln", x.half()) == 2


def test_no_grad_skips_the_ops_and_grad_mode_takes_them():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_np(rng, (2, 3, 16))).requires_grad_()
    g, b = torch.ones(16, requires_grad=True), torch.zeros(16)
    y = tfm.fused_layer_norm(x, g, b)
    assert y.grad_fn is not None and y.shape == x.shape
    with torch.no_grad():
        y2 = tfm.fused_layer_norm(x, g, b)
        y3, s3 = tfm.fused_ln_residual(x, x, g, b)
        z = tfm.fused_bias_gelu(x, b)
    assert y2.grad_fn is None and z.grad_fn is None and s3.grad_fn is None
    torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)
    assert tfm.fused_gelu(x.detach()).grad_fn is None


def test_incubate_functional_surface():
    """``incubate.nn.functional`` keeps the reference's signatures; a
    LayerNorm without weight or bias is the plain composite."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(_np(rng, (6, 32)))
    g, b = 1 + torch.from_numpy(_np(rng, (32,), 0.1)), torch.zeros(32)
    torch.testing.assert_close(FI.fused_layer_norm(x, g, b, epsilon=1e-6),
                               tfm.ln_reference(x, g, b, 1e-6))
    torch.testing.assert_close(FI.fused_layer_norm(x, g, None),
                               tfm.ln_reference(x, g, b))
    torch.testing.assert_close(FI.fused_layer_norm(x, None, None),
                               tfm.ln_reference(x, torch.ones(32), b))
    y, s = FI.fused_ln_residual(x, x, g, b, epsilon=1e-5, use_pallas=False)
    torch.testing.assert_close(s, 2 * x)
    torch.testing.assert_close(FI.fused_bias_gelu(x, b),
                               tfm.gelu_fwd_reference(x, b))
    torch.testing.assert_close(FI.fused_bias_gelu(x),
                               tfm.gelu_fwd_reference(x))


# ---------------------------------------------------------------------------
# the CUDA GELU kernels' sigmoid form and launch plan
# ---------------------------------------------------------------------------

_F = np.float32
_C1 = _F(-2) * _F(1.4426950408889634) * _F(tfm._K0)  # kC1: -2 log2(e) K0
_C2 = _C1 * _F(tfm._A)                                # kC2
_D1, _D2 = _F(2) * _F(tfm._K0), _F(3) * _F(tfm._A)


def _ftz(t):
    """``rcp.approx.ftz``: subnormal results flush to zero."""
    return torch.where(t.abs() < 2.0 ** -126, torch.zeros_like(t), t)


def _sigmoid_fwd(x, bias=None):
    """``gelu_f`` of ``csrc/fused_mlp.cu`` in fp32 torch, cast once."""
    u = tfm._u32(x, bias)
    e = torch.exp2(u * (float(_C2) * u * u + float(_C1)))
    return (u * _ftz(1.0 / (1.0 + e))).to(x.dtype)


def _sigmoid_bwd(dy, x, bias=None):
    """``gelu_grad`` of ``csrc/fused_mlp.cu`` in fp32 torch: ``(dx,
    dbias)`` as :func:`gelu_bwd_reference` returns them."""
    u = tfm._u32(x, bias)
    u2 = u * u
    e = torch.exp2(torch.fmin(u * (float(_C2) * u2 + float(_C1)),
                              torch.tensor(127.0)))
    s = _ftz(1.0 / (1.0 + e))
    du = dy.float() * ((float(_D1) * u * s) * ((e * s) * (float(_D2) * u2
                                                          + 1.0)) + s)
    return du.to(x.dtype), None if bias is None else du.sum(0)


def _extreme_inputs(rng, rows, n):
    """``u`` uniform in +-30 with +-1e4, +-inf and NaN in every row."""
    u = rng.uniform(-30, 30, (rows, n)).astype(np.float32)
    special = np.array([1e4, -1e4, np.inf, -np.inf, np.nan], np.float32)
    for r in range(rows):
        u[r, rng.choice(n, special.size, replace=False)] = special
    return u


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
@pytest.mark.parametrize("has_bias", [False, True])
def test_sigmoid_form_matches_tanh_form_at_extremes(leg, has_bias):
    """The kernels' ``u sigma(2z)`` and its derivative against the twins
    (the tanh form) and the interpret-mode JAX kernels, forward, dx and
    dbias, over +-30, +-1e4, +-inf and NaN."""
    rng = np.random.RandomState(11)
    rows, n = 64, 256
    x = _extreme_inputs(rng, rows, n)
    b = _np(rng, (n,), 0.5) if has_bias else None
    dy = _np(rng, (rows, n))
    jd, td = DTYPES[leg]
    tx, tdy = (torch.from_numpy(a).to(td) for a in (x, dy))
    tb = None if b is None else torch.from_numpy(b).to(td)
    y = _sigmoid_fwd(tx, tb)
    dx, db = _sigmoid_bwd(tdy, tx, tb)
    _assert_close(y, tfm.gelu_fwd_reference(tx, tb).float(), leg,
                  "y vs twin")
    want_dx, want_db = tfm.gelu_bwd_reference(tdy, tx, tb)
    _assert_close(dx, want_dx.float(), leg, "dx vs twin")
    if has_bias:
        _assert_close(db, want_db, "fp32", "dbias vs twin")
    jx, jdy = jnp.asarray(x, jd), jnp.asarray(dy, jd)
    if has_bias:
        jy, vjp = jax.vjp(lambda a, c: jfm.fused_bias_gelu(a, c, True), jx,
                          jnp.asarray(b, jd))
        jdx, jdb = vjp(jdy)
        _assert_close(db.to(td), jdb, leg, "dbias vs jax")
    else:
        jy, vjp = jax.vjp(lambda a: jfm.fused_gelu(a, True), jx)
        (jdx,) = vjp(jdy)
    _assert_close(y, jy, leg, "y vs jax")
    _assert_close(dx, jdx, leg, "dx vs jax")


def _plan_cover(rows, n, elt, plan):
    """How many threads of the planned grid own each (row, 16-byte chunk),
    by the kernel's own index arithmetic."""
    chunks = -(-n // (16 // elt))
    lanes = tfm.GELU_THREADS // plan.strip
    t = np.arange(tfm.GELU_THREADS)
    steps = -(-plan.band // lanes)
    hits = []
    for by in range(plan.bands):
        r1 = min(rows, (by + 1) * plan.band)
        r = by * plan.band + t // plan.strip + lanes * np.arange(steps)[:, None]
        for bx in range(plan.strips):
            c = np.broadcast_to(bx * plan.strip + t % plan.strip, r.shape)
            ok = (r < r1) & (c < chunks)
            hits.append(r[ok] * chunks + c[ok])
    return np.bincount(np.concatenate(hits), minlength=rows * chunks)


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("partials", [False, True])
@pytest.mark.parametrize("shape", [(8192, 6144), (2048, 3072), (77, 200),
                                   (1, 6144), (64, 8), (33, 6152)])
def test_gelu_plan_covers_fills_and_bounds_partials(shape, partials, elt):
    """At 132 SMs: every (row, chunk) belongs to exactly one thread; at the
    flagship and GPT-125M shapes at least a wave of blocks; without dbias
    partials at most ``GELU_ROWS`` rows a thread; with the bias backward's
    partials, one fp32 row a band within ``GELU_PART_SHARE`` of its bytes
    (or one band)."""
    rows, n = shape
    sms = 132
    plan = tfm.gelu_plan(rows, n, elt, sms, partials)
    assert plan.strip & (plan.strip - 1) == 0
    assert 1 <= plan.strip <= tfm.GELU_STRIP
    assert plan.bands == -(-rows // plan.band) <= 65535
    cover = _plan_cover(rows, n, elt, plan)
    assert cover.min() == 1 and cover.max() == 1
    if rows >= 2048:
        assert plan.strips * plan.bands >= sms * tfm.GELU_BLOCKS_PER_SM
    if not partials:     # rows a thread walks
        assert -(-plan.band // (tfm.GELU_THREADS // plan.strip)) \
            <= tfm.GELU_ROWS
    part, bwd = plan.bands * n * 4, 3 * rows * n * elt
    assert not partials or plan.bands == 1 or \
        part <= tfm.GELU_PART_SHARE * bwd


# ---------------------------------------------------------------------------
# the CUDA LN backward's launch plan and its order of sums
# ---------------------------------------------------------------------------


def _plan_rows(rows, plan):
    """The rows each (block, group) walks, in order, by the kernel's own
    index arithmetic: block b owns ``[b band, (b + 1) band)``, its group k
    the band's rows k, k + groups, ..."""
    out = {}
    for b in range(plan.blocks):
        r1 = min(rows, (b + 1) * plan.band)
        for k in range(plan.groups):
            out[b, k] = list(range(b * plan.band + k, r1, plan.groups))
    return out


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("shape", [(8192, 1536), (2048, 768), (77, 200),
                                   (1, 1536), (3, 768), (8191, 1536),
                                   (16, tfm.MAX_H), (9, 1001), (5, 8)])
def test_ln_bwd_plan_covers_rows_in_band_order(shape, sms, elt):
    """Every row belongs to exactly one (block, group), the blocks' bands
    are contiguous and in order; a row's group is the fewest whole warps
    that hold it at the fewest chunks a thread that fit; a block fits its
    thread cap (and its named barriers); at most one block an SM and no
    more blocks than rows; the partial rows' sets cover the blocks, one set
    up to ``LN_BWD_BATCH`` blocks, else ~sqrt(blocks) sets of
    ~sqrt(blocks); the counters fit ``_build.kept``'s first buffer and the
    groups' shared sums the shared memory of a block."""
    rows, h = shape
    plan = tfm.ln_bwd_plan(rows, h, elt, sms)
    walked = _plan_rows(rows, plan)
    flat = sorted(r for rs in walked.values() for r in rs)
    assert flat == list(range(rows))
    for b in range(plan.blocks):
        band = sorted(r for (bb, _), rs in walked.items() if bb == b
                      for r in rs)
        assert band == list(range(b * plan.band,
                                  min(rows, (b + 1) * plan.band)))
    assert 1 <= plan.blocks <= min(sms, rows)
    chunks = -(-h // (16 // elt))
    per_ok = [p for p in ((1, 2, 4) if elt == 4 else (1, 2))
              if 32 * -(-chunks // (32 * p)) <= tfm.LN_BWD_THREADS[p]]
    assert plan.per == per_ok[0]
    assert plan.threads % 32 == 0
    assert plan.threads * plan.per >= chunks > (plan.threads - 32) * plan.per
    assert plan.groups * plan.threads <= tfm.LN_BWD_THREADS[plan.per]
    assert plan.threads == 32 or plan.groups <= tfm.LN_BWD_GROUPS
    assert plan.groups * 8 * h <= 227 * 1024
    assert plan.set * plan.sets >= plan.blocks > plan.set * (plan.sets - 1)
    if plan.blocks <= tfm.LN_BWD_BATCH:   # one set: one round of loads
        assert plan.sets == 1
    else:
        assert plan.set ** 2 >= plan.blocks > (plan.set - 1) ** 2
    assert plan.scratch(h) == (plan.blocks + plan.sets) * 2 * h
    assert plan.sets + 1 <= 4096    # _build.kept's least buffer
    # no block owns more rows than an even split over the blocks a grid of
    # one block an SM (or of full groups) needs
    assert plan.band == -(-rows // min(sms, -(-rows // plan.groups)))


def test_ln_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=str(tfm.MAX_H)):
        tfm.ln_bwd_plan(4, tfm.MAX_H + 1, 2, 132)
    with pytest.raises(ValueError, match="rows"):
        tfm.ln_bwd_plan(0, 128, 2, 132)
    assert tfm.ln_bwd_plan(4, tfm.MAX_H, 4, 132).per == 4
    assert tfm.ln_bwd_plan(4, tfm.MAX_H, 2, 132).per == 2


def _plan_twin(dy, dso, s, mean, rstd, g, plan):
    """The LN backward in fp32 torch in the kernel's order of sums on
    ``plan``: each group adds its rows' ``dy * xhat`` and ``dy`` in row
    order, a block its groups in group order, the last block of each set
    its set's blocks in block order, the last set the sets in set order;
    dx row by row as the plain version computes it."""
    dx = tfm.ln_bwd_reference(dy, dso, s, mean, rstd, g)[0]
    dy32 = dy.float()
    xhat = (s.float() - mean[:, None]) * rstd[:, None]
    parts = []
    for b in range(plan.blocks):
        block = None
        for k in range(plan.groups):
            acc = torch.zeros(2, s.shape[1])
            for r in _plan_rows(s.shape[0], plan)[b, k]:
                acc = acc + torch.stack([dy32[r] * xhat[r], dy32[r]])
            block = acc if block is None else block + acc
        parts.append(block)
    sets = []
    for i in range(plan.sets):
        acc = torch.zeros(2, s.shape[1])
        for part in parts[i * plan.set:(i + 1) * plan.set]:
            acc = acc + part
        sets.append(acc)
    total = sets[0]
    for part in sets[1:]:
        total = total + part
    return dx, total[0], total[1]


@pytest.mark.parametrize("leg", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,sms", [((64, 128), 3), ((77, 200), 4),
                                       ((9, 1001), 132), ((1, 8), 132),
                                       ((640, 16), 132)])
def test_ln_bwd_plan_sums_match_jax(leg, shape, sms):
    """dx, dgamma and dbeta summed in the kernel's order on its plan (many
    groups a block, a short last band, one set of blocks at 3-4 SMs, two
    levels of sets at [640, 16])
    against ``jax.vjp`` of the reference: its Pallas kernel in interpret
    mode where the rows tile, else ``ln_reference``."""
    rng = np.random.RandomState(13)
    rows, h = shape
    x, dy = _np(rng, shape), _np(rng, shape)
    g, b = 1 + _np(rng, (h,), 0.1), _np(rng, (h,), 0.1)
    jd, td = DTYPES[leg]
    jfn = (lambda x_, g_, b_: jfm.fused_layer_norm(x_, g_, b_, EPS, True)) \
        if shape == (64, 128) else \
        (lambda x_, g_, b_: jfm.ln_reference(x_, g_, b_, EPS))
    _, vjp = jax.vjp(jfn, *(jnp.asarray(a, jd) for a in (x, g, b)))
    want = vjp(jnp.asarray(dy, jd))
    tx, tdy, tg = (torch.from_numpy(a).to(td) for a in (x, dy, g))
    _, mean, rstd = tfm.ln_fwd_reference(tx, None, tg, tg, EPS)
    plan = tfm.ln_bwd_plan(rows, h, tx.element_size(), sms)
    assert shape != (640, 16) or plan.sets > 1
    got = _plan_twin(tdy, None, tx, mean, rstd, tg, plan)
    _assert_close(got[0], want[0], leg, "dx")
    for i in (1, 2):    # fp32 sums; JAX returns them in gamma's dtype
        _assert_close(got[i], want[i], leg, f"sum {i}")
