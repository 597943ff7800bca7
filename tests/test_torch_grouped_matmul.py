"""Port ragged grouped GEMM (``paddle_tpu_torch/ops/grouped_matmul.py``)
against the JAX package on the CPU.

The JAX Pallas kernels cannot trace on this jax (``pltpu.TPUCompilerParams``
was renamed), so the port is held against ``grouped_matmul_reference`` and
``grouped_matmul(use_kernel=False)`` only; both sides get the same seeded
numpy inputs and the port's own quantized payloads. Tolerances: fp32
``atol/rtol 1e-5`` (another summation order); bf16 outputs round one fp32
sum each side, held per row to ``1e-2`` of the row's max ``|want|`` (one
bf16 step is <= 2^-7). Layout helpers and integer outputs are compared
exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import grouped_matmul as jgmm
from paddle_tpu_torch.inference.quantize import quantize_weight
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.ops import grouped_matmul as tgmm
from paddle_tpu_torch.ops.quant_matmul import DX_PER

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ROW_TOL = 1e-2
# rows per expert: empty experts first, middle and last; a 1-row expert;
# more rows than one 32-row tile
COUNTS = {"mixed": [0, 5, 0, 1, 40, 3], "tail_empty": [9, 33, 0],
          "one": [0, 0, 7]}
# every row-tile height a launch plan can choose (the CUDA-core kernel's
# and each tensor-core tile family's), and the reference's 8
PLAN_BMS = sorted({tgmm.BM} | {t["bm"] for t in tgmm.TC_TILES.values()})
LAYOUT_BMS = sorted({8, *PLAN_BMS})
SMS = 132   # an H100's SMs: plans are pure functions, no card needed


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _j(a, dtype=None):
    """numpy -> jnp, bf16 through ml_dtypes."""
    if dtype == torch.bfloat16:
        return jnp.asarray(np.asarray(a, np.float32).astype(
            ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(a):
    """A jax or torch float array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
        return
    diff = np.abs(got - want).max(-1)
    scale = np.maximum(np.abs(want).max(-1), 1e-30)
    assert (diff / scale).max() <= BF16_ROW_TOL


def _case(counts, k, n, weights, dtype, seed=0):
    """(x, weights, scales, offsets) as torch tensors and the same as jnp."""
    rng = np.random.default_rng(seed)
    m, e = sum(counts), len(counts)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((e, k, n))).astype(np.float32)
    offs = _offsets(counts)
    tx = _t(x, dtype)
    if weights == "fp":
        tw, ts = _t(w, dtype), None
        jw, js = _j(w, dtype), None
    else:
        bits, group = {"int8": ("int8", -1), "int8g8": ("int8", 8),
                       "int4": ("int4", -1), "int4g8": ("int4", 8),
                       "int8g32": ("int8", 32),
                       "int4g32": ("int4", 32)}[weights]
        qw = quantize_weight(_t(w, dtype), bits, group)
        tw, ts = qw["q"], qw["s"]
        jw, js = jnp.asarray(tw.numpy()), jnp.asarray(ts.numpy())
    return (tx, tw, ts, _t(offs)), (_j(x, dtype), jw, js, jnp.asarray(offs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weights", ["fp", "int8", "int8g8", "int4",
                                     "int4g8"])
@pytest.mark.parametrize("counts", sorted(COUNTS))
def test_twin_matches_jax_reference(dtype, weights, counts):
    (tx, tw, ts, toffs), (jx, jw, js, joffs) = _case(COUNTS[counts], 24, 40,
                                                     weights, dtype)
    want = jgmm.grouped_matmul_reference(jx, jw, joffs, scales=js)
    got = tgmm.grouped_matmul_reference(tx, tw, toffs, scales=ts)
    assert got.dtype == dtype
    _close(got, want, dtype)
    # the public entry (CPU: the twin) with per-channel [E, N] scales too
    if ts is not None and ts.shape[1] == 1:
        _close(tgmm.grouped_matmul(tx, tw, toffs, ts[:, 0]), want, dtype)
    _close(tgmm.grouped_matmul(tx, tw, toffs, ts), want, dtype)


@pytest.mark.parametrize("bm", LAYOUT_BMS)
@pytest.mark.parametrize("counts", sorted(COUNTS))
def test_layout_matches_jax(counts, bm):
    """``token_group_ids`` equals the reference's; ``row_tiles`` (the
    kernels' tile binding, at every tile height a plan can choose) gives
    each live tile the group and the rows the reference's padded pack
    layout gives it."""
    c = COUNTS[counts]
    m, e = sum(c), len(c)
    offs = _offsets(c)
    np.testing.assert_array_equal(
        tgmm.token_group_ids(_t(offs), m).numpy(),
        np.asarray(jgmm.token_group_ids(jnp.asarray(offs), m)))
    dest, tile_gid, _ = jgmm._pack_layout(jnp.asarray(offs), m, e, bm)
    dest, tile_gid = np.asarray(dest), np.asarray(tile_gid)
    ex, lo, hi = (t.numpy() for t in tgmm.row_tiles(_t(offs), m, bm))
    live = int((ex >= 0).sum())
    assert live == sum(-(-n // bm) for n in c)
    assert len(ex) == tgmm.max_row_tiles(m, e, bm) >= live
    np.testing.assert_array_equal(ex[:live], tile_gid[:live])
    assert (ex[live:] == -1).all()
    for t in range(live):
        want_rows = np.nonzero(dest // bm == t)[0]
        np.testing.assert_array_equal(np.arange(lo[t], hi[t]), want_rows)


@pytest.mark.parametrize("bm", PLAN_BMS)
def test_max_row_tiles_bounds_every_split(bm):
    rng = np.random.default_rng(3)
    for _ in range(200):
        e = int(rng.integers(1, 9))
        c = rng.integers(0, 2 * bm + 6, e) * (rng.random(e) < 0.7)
        m = int(c.sum())
        if m == 0:
            continue
        assert sum(-(-int(n) // bm) for n in c) <= tgmm.max_row_tiles(m, e,
                                                                     bm)


def _check_plan(p, m, e, k, n, bwd, counts):
    """A tensor-core plan's grid: every stage of 64 of the reduction in
    exactly one split, no split empty (the C entries refuse one), the
    grid rows over every live tile of ``counts``."""
    stages = -(-(n if bwd else k) // 64)
    assert p.cols == -(-(k if bwd else n) // tgmm.TC_TILES[p.tile]["bn"])
    assert p.per >= 1 and 1 <= p.splits <= stages
    assert p.splits * p.per >= stages > (p.splits - 1) * p.per
    assert p.rows == tgmm.max_row_tiles(m, e, p.bm)
    assert sum(-(-c // p.bm) for c in counts) <= p.rows


def _check_sk_plan(p, m, e, k, n, bits, counts):
    """A skinny-route plan's grid: 64-column tiles, every 64-row stage of
    the stored rows in exactly one split, no split empty, the grid rows
    over every live 64-row tile of ``counts``, and the K split filling one
    wave: the fewest splits of equal stage counts that bring the grid
    (every row counted live) to ``SK_BLOCKS_PER_SM`` blocks an SM, or to
    one split a stage."""
    stages = (k // 2 if bits == 4 else k) // tgmm.SK_STAGE
    assert (p.route, p.tile, p.bm) == ("sk", None, tgmm.SK_ROWS)
    assert p.cols == -(-n // tgmm.SK_COLS)
    assert p.per >= 1 and 1 <= p.splits <= stages
    assert p.splits * p.per >= stages > (p.splits - 1) * p.per
    assert p.rows == tgmm.max_row_tiles(m, e, tgmm.SK_ROWS)
    assert sum(-(-c // tgmm.SK_ROWS) for c in counts) <= p.rows
    blocks, wave = p.rows * p.cols, tgmm.SK_BLOCKS_PER_SM * SMS
    want = min(stages, max(1, -(-wave // blocks)))
    assert p.per == -(-stages // want) and p.splits <= want


def test_plan_routes():
    """bf16 fp weights at aligned widths multiple of 8 take the
    tensor-core kernel, the serving tile at the serving rows and the
    prefill tile at the prefill rows; the int8 / int4 forward at the
    serving rows on whole aligned chunks takes the skinny route in bf16,
    and the int8 dx the dx route; fp32 (fp or quantized weights), the
    quantized prefill rows' forward, stored rows not a multiple of 64, N
    not of 16, scale groups not of 16k rows, an unaligned pointer and the
    int4 dx take the CUDA-core kernel; the splits cover the reduction and
    the grid rows the live tiles."""
    bf16, f32 = torch.bfloat16, torch.float32
    serving, prefill = [30, 0, 11, 7], [2400, 0, 900, 796]
    # the skinny route at the serving rows (a): w1's 48 column tiles x 4
    # grid rows split K two ways to fill two blocks an SM, w2's 12 x 4 six
    # ways
    for bits in (8, 4):
        for k, n in ((768, 3072), (3072, 768)):
            for groups in (1, k // 128):
                for dtype in (bf16, f32):
                    p = tgmm._plan(48, 4, k, n, bits, False, dtype, True, SMS,
                                   groups)
                    if dtype == f32:
                        assert (p.route, p.bm) == ("cc", tgmm.BM)
                        continue
                    _check_sk_plan(p, 48, 4, k, n, bits, serving)
                    assert p.splits == (2 if n == 3072 else 6)
                # the int8 dx at the serving rows takes the dx route, int4's
                # (a plain contraction) keeps the CUDA-core plan
                p = tgmm._plan(48, 4, k, n, bits, True, bf16, True, SMS,
                               groups)
                assert p.route == ("dx" if bits == 8 else "cc")
                for args in ((4096, 4, k, n, bits, False, bf16, True, groups),
                             (48, 4, k, n, bits, False, bf16, False, groups),
                             (48, 4, k, n + 8, bits, False, bf16, True,
                              groups),
                             (48, 4, k, n, bits, False, bf16, True, k // 8)):
                    p = tgmm._plan(*args[:8], SMS, args[8])
                    assert (p.route, p.bm) == ("cc", tgmm.BM), args
        # stored rows off the 64-row stages: int8 K 1040, int4 K / 2 544
        # (per-channel groups of 16k rows)
        for k in (1040, 1088):
            want = "sk" if (k // 2 if bits == 4 else k) % 64 == 0 else "cc"
            assert tgmm._plan(48, 4, k, 768, bits, False, bf16, True,
                              SMS).route == want
    # random serving splits: the grid rows cover the live 64-row tiles
    rng = np.random.default_rng(12)
    for _ in range(300):
        e = int(rng.integers(1, 9))
        counts = [int(c) for c in rng.integers(0, 130, e)
                  * (rng.random(e) < 0.8)]
        m = sum(counts)
        if m == 0 or -(-m // e) > tgmm.SERVING_ROWS:
            continue
        bits = int(rng.choice([8, 4]))
        k = int(rng.integers(1, 40)) * 128
        n = int(rng.integers(1, 200)) * 16
        p = tgmm._plan(m, e, k, n, bits, False, bf16, True, SMS)
        _check_sk_plan(p, m, e, k, n, bits, counts)
    for bwd in (False, True):
        for k, n in ((768, 3072), (3072, 768)):
            for counts, tile, bm in ((serving, "serving", 32),
                                     (prefill, "prefill", 128)):
                m = sum(counts)
                p = tgmm._plan(m, 4, k, n, 0, bwd, bf16, True, SMS)
                assert (p.route, p.tile, p.bm) == ("tc", tile, bm)
                _check_plan(p, m, 4, k, n, bwd, counts)
            # the serving tile splits the reduction where it has few
            # column tiles (768 wide: 6); the prefill tile fills the card
            # with row tiles instead
            p = tgmm._plan(48, 4, k, n, 0, bwd, bf16, True, SMS)
            assert (p.cols, p.splits) == ((6, 4) if (k if bwd else n) == 768
                                          else (24, 1))
            assert tgmm._plan(4096, 4, k, n, 0, bwd, bf16, True,
                              SMS).splits == 1
        # the int8 prefill rows: the dx route for the dx, the CUDA-core
        # kernel for the forward
        p = tgmm._plan(4096, 4, 3072, 768, 8, bwd, bf16, True, SMS)
        assert p.route == ("dx" if bwd else "cc")
        for args in ((48, 4, 768, 3072, 0, bwd, f32, True),
                     (4096, 4, 768, 3072, 0, bwd, f32, True),
                     (4096, 4, 3072, 768, 8, bwd, f32, True),
                     (23, 5, 136, 76, 0, bwd, bf16, True),
                     (23, 5, 132, 72, 0, bwd, bf16, True),
                     (48, 4, 768, 3072, 0, bwd, bf16, False)):
            p = tgmm._plan(*args, SMS)
            assert (p.route, p.tile, p.bm) == ("cc", None, tgmm.BM), args
            assert p.rows == tgmm.max_row_tiles(args[0], args[1])
            assert 1 <= p.splits and (p.splits - 1) * p.per < max(
                1, -(-args[3] // 64) if bwd else -(-args[2] // 64))
    # the odd shape (c) takes the tensor cores: K 136, N 72 are multiples
    # of 8 though not of the tiles
    p = tgmm._plan(18, 5, 136, 72, 0, False, bf16, True, SMS)
    assert (p.route, p.tile) == ("tc", "serving")
    # random splits: the grid rows cover the live tiles, the splits the
    # reduction
    rng = np.random.default_rng(11)
    for _ in range(300):
        e = int(rng.integers(1, 9))
        counts = [int(c) for c in rng.integers(0, 600, e)
                  * (rng.random(e) < 0.8)]
        m = sum(counts)
        if m == 0:
            continue
        k, n = (int(v) * 8 for v in rng.integers(1, 500, 2))
        bwd = bool(rng.random() < 0.5)
        p = tgmm._plan(m, e, k, n, 0, bwd, bf16, True, SMS)
        assert p.route == "tc"
        assert p.tile == ("serving" if -(-m // e) <= tgmm.SERVING_ROWS
                          else "prefill")
        _check_plan(p, m, e, k, n, bwd, counts)


def _sk_int4_stage(packed, scales3d, k: int, s: int,
                   out_dtype=torch.float32):
    """Stage ``s`` of the skinny route's split-half int4 tile, in plain
    torch: the stored rows ``[64 s, 64 s + 64)`` of ``packed [E, K/2,
    N]``. Stored row ``i`` holds reduction row ``i`` in its low nibble and
    ``K/2 + i`` in its high nibble (sign-extended ``((p & 0xF) ^ 8) - 8``,
    as the reference's ``_gmm_q4_kernel``), each scaled by the scale row of
    its own group. Returns ``(rows_lo, rows_hi, groups_lo, groups_hi, lo,
    hi)``: the reduction rows the stage feeds, the scale row each uses, and
    the dequantized ``[E, 64, N]`` values (``q * s`` in ``out_dtype``). The
    kernel holds ``4`` scale rows a half from ``groups_lo[0]`` and
    ``groups_hi[0]`` (groups of 16k rows: one group a 16-row step)."""
    kh = k // 2
    gs = k // scales3d.shape[1]
    i = torch.arange(tgmm.SK_STAGE * s, tgmm.SK_STAGE * (s + 1))
    rows_lo, rows_hi = i, i + kh
    groups_lo, groups_hi = rows_lo // gs, rows_hi // gs
    b = packed[:, i].to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    sc = scales3d.to(out_dtype)
    return (rows_lo, rows_hi, groups_lo, groups_hi,
            lo.to(out_dtype) * sc[:, groups_lo], hi.to(out_dtype)
            * sc[:, groups_hi])


@pytest.mark.parametrize("group", [128, -1])
@pytest.mark.parametrize("k", [768, 3072])
def test_sk_int4_stage_feeds_both_halves(k, group):
    """The skinny route's split-half int4 stage, the contract its kernel
    is written to: stored row ``i`` of stage ``s`` feeds reduction rows
    ``64 s + i`` (low nibble) and ``K/2 + 64 s + i`` (high nibble), each
    with its own group's scale row; a 16-row step of either half lies in
    one group and each half of a stage within the 4 scale rows the kernel
    holds from its first group. The stages together give every row once,
    equal to ``dequantize_grouped_weight`` (fp32 and bf16, bit for bit)."""
    e, n = 2, 32
    rng = np.random.default_rng(k + group)
    w = torch.from_numpy((0.1 * rng.standard_normal((e, k, n))).astype(
        np.float32))
    qw = quantize_weight(w, "int4", group)
    q, s3 = qw["q"], qw["s"]
    gs = k // s3.shape[1]
    for dtype in (torch.float32, torch.bfloat16):
        got = torch.full((e, k, n), float("nan"), dtype=dtype)
        seen = torch.zeros(k, dtype=torch.int64)
        for st in range(k // 2 // tgmm.SK_STAGE):
            rl, rh, gl, gh, lo, hi = _sk_int4_stage(q, s3, k, st, dtype)
            first = tgmm.SK_STAGE * st
            assert torch.equal(rl, torch.arange(first, first + 64))
            assert torch.equal(rh, rl + k // 2)
            assert torch.equal(gl, rl // gs) and torch.equal(gh, rh // gs)
            for groups in (gl, gh):
                steps = groups.view(4, 16)
                assert bool((steps == steps[:, :1]).all())
                assert int(groups[-1] - groups[0]) < 4
            got[:, rl], got[:, rh] = lo, hi
            seen[rl] += 1
            seen[rh] += 1
        assert bool((seen == 1).all())
        want = tgmm.dequantize_grouped_weight(q, s3, k=k, out_dtype=dtype)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weights", ["int8", "int8g32", "int4g32"])
def test_sk_split_plan_sums_to_the_jax_reference(dtype, weights):
    """The skinny route's arithmetic in torch: each 64-row tile of an
    expert multiplied, split by split of the plan, with its expert's weight
    dequantized as the kernel does (``q * s`` rounded to the activation
    type; int4 stage by stage through ``_sk_int4_stage``, both nibbles of a
    stored row against their own k-slices), the fp32 splits summed in
    order and cast once — against the JAX reference (as ``_close``)."""
    counts = [5, 0, 70, 2]
    k, n = 512, 48
    (tx, tw, ts, toffs), (jx, jw, js, joffs) = _case(counts, k, n, weights,
                                                     dtype, seed=6)
    bits = 4 if weights.startswith("int4") else 8
    m, e = sum(counts), len(counts)
    p = tgmm._plan(m, e, k, n, bits, False, torch.bfloat16, True, SMS,
                   ts.shape[1])
    assert p.route == "sk" and p.splits > 1
    deq = tgmm.dequantize_grouped_weight(tw, ts, k=k, out_dtype=dtype)
    stages = (k // 2 if bits == 4 else k) // tgmm.SK_STAGE
    ex, lo, hi = tgmm.row_tiles(toffs, m, tgmm.SK_ROWS)
    out = torch.empty(m, n)
    for t in range(int((ex >= 0).sum())):
        x = tx[int(lo[t]):int(hi[t])].float()
        acc = torch.zeros(x.shape[0], n)
        for z in range(p.splits):
            part = torch.zeros(x.shape[0], n)
            for st in range(z * p.per, min((z + 1) * p.per, stages)):
                if bits == 4:
                    rl, rh, _, _, wl, wh = _sk_int4_stage(tw, ts, k, st,
                                                          dtype)
                    part += (x[:, rl] @ wl[int(ex[t])].float()
                             + x[:, rh] @ wh[int(ex[t])].float())
                else:
                    ks = slice(64 * st, 64 * st + 64)
                    part += x[:, ks] @ deq[int(ex[t]), ks].float()
            acc += part
        out[int(lo[t]):int(hi[t])] = acc
    want = jgmm.grouped_matmul_reference(jx, jw, joffs, scales=js)
    _close(out.to(dtype), want, dtype)


def _check_dx_plan(p, m, e, k, n, counts, sms=SMS):
    """A dx-route plan's grid: 64-column tiles of dx, the grid rows over
    every live 64-row tile of ``counts``, every 64-column stage of N in
    exactly one split, no split empty, and ``dx_split``'s rule: ``DX_PER``
    stages a split where the grid (every row counted live) then holds
    ``sms / 2`` to ``2 sms`` blocks, else the nearest count of stages that
    brings it there or to one stage / one split a tile."""
    stages = -(-n // tgmm.DX_STAGE)
    assert (p.route, p.tile, p.bm) == ("dx", None, tgmm.DX_ROWS)
    assert p.cols == k // tgmm.DX_COLS
    assert p.rows == tgmm.max_row_tiles(m, e, tgmm.DX_ROWS)
    assert sum(-(-c // tgmm.DX_ROWS) for c in counts) <= p.rows
    assert p.per >= 1 and 1 <= p.splits <= stages
    assert p.splits * p.per >= stages > (p.splits - 1) * p.per
    tiles = p.rows * p.cols

    def blocks(per):
        return tiles * -(-stages // per)

    assert 2 * blocks(p.per) >= sms or p.per == 1
    assert blocks(p.per) <= 2 * sms or p.per == stages
    first = min(stages, DX_PER)
    if sms <= 2 * blocks(first) and blocks(first) <= 2 * sms:
        assert p.per == first
    elif p.per < first:   # lowered only as far as half an SM a block
        assert 2 * blocks(p.per + 1) < sms
    elif p.per > first:   # raised only as far as two blocks an SM
        assert blocks(p.per - 1) > 2 * sms


def test_dx_plan_routes_and_splits():
    """The bf16 / fp16 int8 dx takes the dx route at the serving rows (a)
    and the prefill rows (b), per channel and in groups of 128, both MoE
    GEMMs of GPT-125M (their splits pinned), and at random rows, experts
    and widths (K % 64, N % 16); fp32, K off 64, N off 16, groups off 16k
    rows, an unaligned pointer and int4 keep the CUDA-core plan, fp weights
    the tensor-core one."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    serving, prefill = [30, 0, 11, 7], [2400, 0, 900, 796]
    # (a): 4 grid rows x w1's 12 / w2's 48 column tiles: w1's 48 stages of
    # N go 10 a split (5 splits, 240 blocks), w2's 12 in one (192 blocks);
    # (b): 67 grid rows fill the card without a split
    want = {(48, 768): (5, 10), (48, 3072): (1, 12),
            (4096, 768): (1, 48), (4096, 3072): (1, 12)}
    for dtype in (bf16, f16):
        for counts in (serving, prefill):
            m = sum(counts)
            for k, n in ((768, 3072), (3072, 768)):
                for groups in (1, k // 128):
                    p = tgmm._plan(m, 4, k, n, 8, True, dtype, True, SMS,
                                   groups)
                    _check_dx_plan(p, m, 4, k, n, counts)
                    assert (p.splits, p.per) == want[(m, k)]
    for args in ((48, 4, 768, 3072, 8, True, f32, True, 1),
                 (18, 5, 136, 72, 8, True, bf16, True, 17),
                 (48, 4, 768, 3080, 8, True, bf16, True, 1),
                 (48, 4, 768, 3072, 8, True, f16, True, 96),
                 (48, 4, 768, 3072, 8, True, bf16, False, 1),
                 (48, 4, 768, 3072, 4, True, bf16, True, 6)):
        p = tgmm._plan(*args[:8], SMS, args[8])
        assert (p.route, p.bm) == ("cc", tgmm.BM), args
    for counts in (serving, prefill):
        p = tgmm._plan(sum(counts), 4, 768, 3072, 0, True, bf16, True, SMS)
        assert p.route == "tc"
    rng = np.random.default_rng(19)
    for _ in range(300):
        e = int(rng.integers(1, 9))
        counts = [int(c) for c in rng.integers(0, 900, e)
                  * (rng.random(e) < 0.8)]
        m = sum(counts)
        if m == 0:
            continue
        k = int(rng.integers(1, 64)) * 64
        n = int(rng.integers(1, 300)) * 16
        sms = int(rng.choice([8, 40, 132]))
        p = tgmm._plan(m, e, k, n, 8, True, bf16, True, sms)
        _check_dx_plan(p, m, e, k, n, counts, sms)


def _dx_tiles(dy, q, s3, offs, k, dtype, plan):
    """The dx route's arithmetic in plain torch: each live 64-row tile of
    one expert (``row_tiles``) times that expert's stack, dequantized as the
    reference does (``q * s`` in ``dtype``: the scale rounded, the product
    rounded once), 64 dx columns at a time, each split of N's stages
    summed in fp32 and the splits added in split order, cast once."""
    m, n = dy.shape
    ex, lo, hi = tgmm.row_tiles(offs, m, tgmm.DX_ROWS)
    gs = k // s3.shape[1]
    deq = (q.float() * s3.to(dtype).float().repeat_interleave(gs, 1)).to(
        dtype)
    assert torch.equal(deq, tgmm.dequantize_grouped_weight(
        q, s3, k=k, out_dtype=dtype))
    stages = -(-n // tgmm.DX_STAGE)
    dx = torch.full((m, k), float("nan"))
    y = dy.to(dtype).float()
    for t in range(int((ex >= 0).sum())):
        rows = slice(int(lo[t]), int(hi[t]))
        w = deq[int(ex[t])].float()
        for c in range(plan.cols):
            cols = slice(tgmm.DX_COLS * c, tgmm.DX_COLS * (c + 1))
            acc = torch.zeros(int(hi[t] - lo[t]), tgmm.DX_COLS)
            for z in range(plan.splits):
                ns = slice(tgmm.DX_STAGE * z * plan.per,
                           min(n, tgmm.DX_STAGE * (z + 1) * plan.per))
                acc += y[rows, ns] @ w[cols, ns].T
            dx[rows, cols] = acc
    return dx.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weights", ["int8", "int8g32"])
@pytest.mark.parametrize("counts", [[0, 5, 0, 1, 70, 3], [70]])
def test_dx_tile_split_plan_sums_to_the_jax_vjp(dtype, weights, counts):
    """The dx route's tile decomposition (expert-bound 64-row tiles, 64
    dx columns, splits of N summed in split order, the reference's
    rounding of ``q * s``) at a plan with splits, mixed rows with empty
    experts and a one-expert case: equal to ``grouped_matmul_dx_reference``
    and to ``jax.vjp`` of ``grouped_matmul(use_kernel=False)`` (fp32 to
    1e-5, bf16 per row to 1e-2 of its max)."""
    k, n = 128, 512
    (tx, tw, ts, toffs), (jx, jw, js, joffs) = _case(counts, k, n, weights,
                                                     dtype, seed=9)
    m, e = sum(counts), len(counts)
    dy = np.random.default_rng(10).standard_normal((m, n)).astype(
        np.float32)
    p = tgmm._plan(m, e, k, n, 8, True, torch.bfloat16, True, 40,
                   ts.shape[1])
    assert p.route == "dx" and p.splits > 1
    got = _dx_tiles(_t(dy), tw, ts, toffs, k, dtype, p)
    assert bool(torch.isfinite(got).all())
    _close(got, tgmm.grouped_matmul_dx_reference(_t(dy, dtype), tw, toffs,
                                                 ts, k, dtype), dtype)
    _, vjp = jax.vjp(lambda x: jgmm.grouped_matmul(
        x, jw, joffs, scales=js, use_kernel=False), jx)
    (jdx,) = vjp(_j(dy, dtype))
    _close(got, jdx, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weights", ["fp", "int8g8", "int4g8"])
def test_custom_op_grads_match_jax_vjp(dtype, weights):
    """dx (and dw for fp weights) of the port's custom op equal
    ``jax.vjp`` of ``grouped_matmul(use_kernel=False)``; quantized weights
    take no gradient."""
    (tx, tw, ts, toffs), (jx, jw, js, joffs) = _case(COUNTS["mixed"], 24, 40,
                                                     weights, dtype, seed=1)
    rng = np.random.default_rng(2)
    dy = rng.standard_normal((tx.shape[0], 40)).astype(np.float32)
    fp = weights == "fp"

    def f(x, w):
        return jgmm.grouped_matmul(x, w, joffs, scales=js, use_kernel=False)

    if fp:
        want, vjp = jax.vjp(f, jx, jw)
        jdx, jdw = vjp(_j(dy, dtype))
    else:
        want, vjp = jax.vjp(lambda x: f(x, jw), jx)
        (jdx,) = vjp(_j(dy, dtype))
    tx = tx.clone().requires_grad_()
    if fp:
        tw = tw.clone().requires_grad_()
    y = tgmm.grouped_matmul(tx, tw, toffs, ts)
    assert y.grad_fn is not None
    y.backward(_t(dy, dtype))
    _close(y, want, dtype)
    _close(tx.grad, jdx, dtype)
    if fp:
        assert tw.grad.dtype == dtype
        _close(tw.grad.reshape(-1, 40), np.asarray(jdw, np.float32).reshape(
            -1, 40), dtype)
    else:
        assert not tw.requires_grad


def test_custom_op_matches_plain_autograd():
    """The custom op's gradients (fp32) equal torch autograd through the
    twin (``use_kernel=False``)."""
    (tx, tw, _, toffs), _ = _case(COUNTS["tail_empty"], 16, 24, "fp",
                                  torch.float32, seed=4)
    r = torch.randn(tx.shape[0], 24, generator=torch.Generator().manual_seed(0))
    grads = []
    for use_kernel in (None, False):
        x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
        (tgmm.grouped_matmul(x, w, toffs, use_kernel=use_kernel) * r
         ).sum().backward()
        grads.append((x.grad, w.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **TOL)


def test_argument_checks_match_reference():
    (tx, tw, ts, toffs), _ = _case([3, 4], 16, 8, "int8", torch.float32)
    with pytest.raises(ValueError, match="2D tokens"):
        tgmm.grouped_matmul(tx[None], tw, toffs, ts)
    with pytest.raises(ValueError, match="stacked weights"):
        tgmm.grouped_matmul(tx, tw[0], toffs, ts)
    with pytest.raises(ValueError, match="group_offsets"):
        tgmm.grouped_matmul(tx, tw, toffs[:-1], ts)
    with pytest.raises(ValueError, match="needs scales"):
        tgmm.grouped_matmul(tx, tw, toffs)
    with pytest.raises(ValueError, match="takes no scales"):
        tgmm.grouped_matmul(tx, tw.float(), toffs, ts)
    with pytest.raises(ValueError, match="matches neither"):
        tgmm.grouped_matmul(tx, tw[:, :5], toffs, ts)
    with pytest.raises(ValueError, match="in-dim"):
        tgmm.grouped_matmul(tx, tw.float()[:, :5], toffs)
    with pytest.raises(ValueError, match="scale groups"):
        tgmm.grouped_matmul(tx, tw, toffs, torch.ones(2, 3, 8))
    with pytest.raises(ValueError, match=r"\[E, N\]"):
        tgmm.grouped_matmul(tx, tw, toffs, torch.ones(3, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgmm.grouped_matmul(tx, tw, toffs, ts, use_kernel=True)


def test_nn_quant_grouped_matmul_is_the_port_entry():
    """``nn.quant.grouped_matmul`` (the reference's public name) runs the
    port's grouped GEMM, fp and quantized."""
    for weights in ("fp", "int4g8"):
        (tx, tw, ts, toffs), (jx, jw, js, joffs) = _case(
            COUNTS["mixed"], 24, 40, weights, torch.float32, seed=5)
        got = tquant.grouped_matmul(tx, tw, toffs, scales=ts)
        torch.testing.assert_close(
            got, tgmm.grouped_matmul_reference(tx, tw, toffs, ts))
        _close(got, jgmm.grouped_matmul_reference(jx, jw, joffs, js),
               torch.float32)


def test_dequantize_grouped_weight_matches_jax():
    (_, tw, ts, _), (_, jw, js, _) = _case([2, 2], 16, 24, "int4g8",
                                           torch.bfloat16)
    got = tgmm.dequantize_grouped_weight(tw, ts, k=16,
                                         out_dtype=torch.bfloat16)
    want = jgmm.dequantize_grouped_weight(jw, js, k=16,
                                          out_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(_np(got), _np(want))
