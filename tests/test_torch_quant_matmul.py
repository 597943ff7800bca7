"""Port weight-only quantization (packing, quantizer, weight-only GEMM and
its dx, the int8 KV write) on the CPU against the JAX package's plain
functions, on the same seeded numpy inputs.

Quantized payloads (``q``, ``s``, int8 KV pages and scales) must be
bit-equal: both sides run the same fp32 formula with round-half-even.
Products are held fp32 at ``rtol 1e-5, atol 1e-6`` (the two libraries sum
in other orders); bf16 products per row to one bf16 step (``1e-2`` of the
row's max), since each side rounds an fp32 sum to bf16 once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.nn import quant as jquant
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.tensor.creation import to_tensor
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.ops import grouped_matmul as tgmm
from paddle_tpu_torch.ops import quant_matmul as tqm

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ROW_TOL = 1e-2


def _bits(a):
    """A numpy/JAX array or a tensor as raw integers (bf16 as its bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _torch_dtype(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[dtype]


def _weights(seed, k, n, dtype):
    w = np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32)
    return jnp.asarray(w).astype(dtype), torch.from_numpy(w).to(
        _torch_dtype(dtype))


def test_pack_unpack_int4_bit_equal_over_all_nibbles():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.concatenate([lo.reshape(16, 16), hi.reshape(16, 16)]
                       ).astype(np.int8)                   # [32, 16]
    want = np.asarray(jqm.pack_int4(jnp.asarray(q)))
    got = tqm.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.reshape(-1).tolist())) == 256    # every byte value
    np.testing.assert_array_equal(tqm.unpack_int4(got).numpy(), q)
    np.testing.assert_array_equal(
        tqm.unpack_int4(got).numpy(),
        np.asarray(jqm.unpack_int4(jnp.asarray(want))))
    with pytest.raises(ValueError, match="even"):
        tqm.pack_int4(torch.zeros((7, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="even"):
        jqm.pack_int4(jnp.zeros((7, 4), jnp.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size", [-1, 8])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_quantize_bit_equal(algo, group_size, dtype):
    """Against the quantizer body the reference's serving conversion runs
    (eagerly, under ``jax.vmap``). Its jitted ``nn.quant.weight_quantize``
    op may put a scale one ulp off: XLA turns ``/ qmax`` into ``*
    (1 / qmax)`` inside a jit."""
    jw, tw = _weights(1, 64, 24, dtype)
    jq, js = jquant._weight_quantize_fn(jw, jquant._qmax(algo),
                                        algo.endswith("int4"), group_size)
    tq, ts = tquant.weight_quantize(tw, algo=algo, group_size=group_size)
    assert tq.dtype == torch.int8 and ts.dtype == tw.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    deq_j = jquant.weight_dequantize(to_tensor(jq), to_tensor(js), algo=algo,
                                     out_dtype="float32")._data
    deq_t = tquant.weight_dequantize(tq, ts, algo=algo,
                                     out_dtype=torch.float32)
    np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq_j))


def _quantized(seed, k, n, bits, group_size, dtype="float32"):
    jw, _ = _weights(seed, k, n, dtype)
    algo = f"weight_only_int{bits}"
    q, s = jquant._weight_quantize_fn(jw, jquant._qmax(algo), bits == 4,
                                      group_size)
    return np.array(q), np.array(s.astype(jnp.float32))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bits,group_size,k", [(8, -1, 64), (8, 8, 40),
                                               (4, -1, 64), (4, 8, 48)])
def test_quant_matmul_twin_and_dx_match_jax(bits, group_size, k, bias):
    n = 20
    q, s = _quantized(2, k, n, bits, group_size)
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    g = rng.standard_normal((2, 3, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    want = jqm.quant_matmul_reference(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s), bias=jb)
    jdx, jdb = jax.grad(
        lambda x_, b_: (jqm.quant_matmul(x_, jnp.asarray(q), jnp.asarray(s),
                                         bias=b_, use_kernel=False)
                        * jnp.asarray(g)).sum(), argnums=(0, 1))(
        jnp.asarray(x), jb)
    tx = torch.from_numpy(x).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    got = tqm.quant_matmul(tx, torch.from_numpy(q), ts, bias=tb)
    assert got.grad_fn is not None and got.shape == (2, 3, n)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FP32_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **FP32_TOL)
    if bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb),
                                   **FP32_TOL)
    assert ts.grad is None      # frozen PTQ scales: no gradient (JAX: zeros)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_bf16_matches_jax(bits):
    q, s = _quantized(4, 64, 32, bits, 16, dtype="bfloat16")
    x = np.random.RandomState(5).standard_normal((6, 64)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul_reference(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q),
        jnp.asarray(s)).astype(jnp.float32))
    got = tqm.quant_matmul(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want).max(-1)
    assert (diff <= BF16_ROW_TOL * np.abs(want).max(-1)).all()


def test_dequantize_and_dx_reference_match_jax():
    """The plain versions the kernels are held against on the card."""
    q, s = _quantized(6, 48, 16, 4, 8)
    want = np.asarray(jqm.dequantize_weight(jnp.asarray(q), jnp.asarray(s),
                                            k=48))
    got = tqm.dequantize_weight(torch.from_numpy(q), torch.from_numpy(s),
                                k=48)
    np.testing.assert_array_equal(got.numpy(), want)
    dy = np.random.RandomState(7).standard_normal((5, 16)).astype(np.float32)
    jdx = jax.vjp(lambda x_: jqm.quant_matmul(x_, jnp.asarray(q),
                                              jnp.asarray(s),
                                              use_kernel=False),
                  jnp.zeros((5, 48), jnp.float32))[1](jnp.asarray(dy))[0]
    tdx = tqm.quant_matmul_dx_reference(torch.from_numpy(dy),
                                        torch.from_numpy(q),
                                        torch.from_numpy(s), 48,
                                        torch.float32)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **FP32_TOL)


def test_cpu_tensors_take_plain_path_and_shapes_are_checked():
    q, s = _quantized(8, 32, 8, 8, -1)
    before = (dict(tqm.quant_matmul_fwd.launches),
              dict(tqm.quant_matmul_bwd.launches))
    x = torch.randn(3, 32, requires_grad=True)
    tqm.quant_matmul(x, torch.from_numpy(q), torch.from_numpy(s)).sum(
        ).backward()
    assert (tqm.quant_matmul_fwd.launches,
            tqm.quant_matmul_bwd.launches) == before
    with pytest.raises(ValueError, match="matches neither"):
        tqm.quant_matmul(torch.randn(3, 30), torch.from_numpy(q),
                         torch.from_numpy(s))
    with pytest.raises(ValueError, match="scale groups"):
        tqm.quant_matmul(x, torch.from_numpy(q), torch.ones(3, 8))
    y = tquant.weight_only_linear(x, torch.from_numpy(q),
                                  weight_scale=torch.from_numpy(s))
    torch.testing.assert_close(y, tquant.quant_matmul(
        x, torch.from_numpy(q), torch.from_numpy(s)))
    # the grouped GEMM entry is the port's (on the CPU: the twin)
    qg = tquant.weight_quantize(torch.randn(2, 16, 24), group_size=8)
    xs, offs = torch.randn(5, 16), torch.tensor([0, 3, 5], dtype=torch.int32)
    torch.testing.assert_close(
        tquant.grouped_matmul(xs, qg[0], offs, scales=qg[1]),
        tgmm.grouped_matmul_reference(xs, qg[0], offs, qg[1]))


def test_paged_write_packed_quant_bit_equal():
    rng = np.random.RandomState(9)
    num_pages, ps, hkv, d = 6, 4, 2, 8
    pages = rng.randint(-127, 128, (num_pages, ps, hkv, d)).astype(np.int8)
    scales = rng.rand(num_pages, ps, hkv).astype(np.float32)
    pt = np.array([[2, 5, -1], [0, -1, -1]], np.int32)
    tok_slot = np.array([0, 0, 0, 0, 0, 1, 1, -1, -1], np.int32)
    tok_pos = np.array([2, 3, 4, 5, 6, 1, 8, 0, -1], np.int32)
    toks = (rng.standard_normal((9, hkv, d)) * 3).astype(np.float32)
    toks[1, 0] = 0.0                       # an all-zero row: scale 1e-8/127
    # the reference's unified step runs the write inside its jit
    jp, js = jax.jit(jkv.paged_write_packed_quant, static_argnums=6)(
        jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(toks),
        jnp.asarray(pt), jnp.asarray(tok_slot), jnp.asarray(tok_pos), ps)
    tp, ts = tkv.paged_write_packed_quant(
        torch.from_numpy(pages), torch.from_numpy(scales),
        torch.from_numpy(toks), torch.from_numpy(pt),
        torch.from_numpy(tok_slot), torch.from_numpy(tok_pos), ps)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not np.array_equal(tp.numpy(), pages)
    for bad in ("int4", "fp8"):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            tkv.kv_cache_quantized(bad)
    assert tkv.kv_cache_quantized("int8") and not tkv.kv_cache_quantized(None)


SERVING_GEMMS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def test_qmm_plan_routes_every_shape():
    """The pure plan routes every M, width, alignment, dtype and weight
    before any launch: with the stored rows (K, or K / 2 packed) % 64 (its
    stages), N % 16, scale groups of a multiple of 16 rows and aligned
    pointers, the bf16 int8 and packed int4 forward at 1 <= M <= 64 takes
    the tensor-core kernel, and so does their dx at any M (its tiles: 64
    stored rows x a pass of up to 64 dy rows; its stages: 64 columns of N);
    everything else (fp32, the forward at M > 64 as in legacy prefill
    buckets, odd widths, unaligned pointers) the CUDA-core one; either way
    every reduction stage is walked by exactly one split."""
    for m in (1, 7, 8, 24, 33, 64, 65, 128, 512):
        for k, n, groups in ((768, 2304, 1), (3072, 768, 24), (200, 130, 5),
                             (768, 770, 1), (768, 768, 48), (96, 64, 3),
                             (768, 768, 64), (128, 64, 4), (128, 64, 1),
                             (256, 96, 8), (384, 64, 1)):
            for dtype in (torch.float32, torch.bfloat16):
                for packed, bwd, aligned in ((False, False, True),
                                             (False, False, False),
                                             (True, False, True),
                                             (True, False, False),
                                             (False, True, True),
                                             (True, True, True),
                                             (False, True, False)):
                    plan = tqm.qmm_plan(m, k, n, groups, dtype, packed, bwd,
                                        aligned, 132)
                    kw = k // 2 if packed else k
                    tc = ((bwd or m <= 64) and aligned
                          and kw % tqm.TC_STAGE == 0 and n % 16 == 0
                          and (k // groups) % 16 == 0
                          and dtype == torch.bfloat16)
                    assert plan.route == ("tc" if tc else "cc"), (m, k, n)
                    assert plan == tqm.qmm_plan(m, k, n, groups, dtype,
                                                packed, bwd, aligned, 132)
                    if tc and bwd:
                        stages = -(-n // tqm.TC_STAGE)
                        assert plan.tiles == (kw // tqm.TC_STAGE
                                              * -(-m // tqm.TC_ROWS))
                    elif tc:
                        stages = kw // tqm.TC_STAGE
                        assert plan.tiles == -(-n // tqm.TC_COLS)
                    else:
                        rw = 32 if packed else 64
                        stages = -(-n // 64) if bwd else -(-kw // rw)
                    assert (plan.splits - 1) * plan.per < stages \
                        <= plan.splits * plan.per


def test_qmm_plan_fills_the_card_at_the_serving_shapes():
    """GPT-125M's four GEMMs at the 24-token budget and a decode round of 8
    take the tensor-core route with at least one block per SM of the
    H100's 132 (int8 per channel and g128, packed int4 g128 and per
    channel), or one a stage where a packed weight has fewer stages (wo:
    K / 2 = 384 stored rows, 6 stages x 12 column tiles), and a block's
    shared memory fits the 227 KB it may use."""
    for m in (24, 8):
        for k, n in SERVING_GEMMS:
            for packed, groups in ((False, 1), (False, k // 128),
                                   (True, k // 128), (True, 1)):
                plan = tqm.qmm_plan(m, k, n, groups, torch.bfloat16, packed,
                                    False, True, 132)
                stored = (k // 2 if packed else k) // tqm.TC_STAGE
                assert plan.route == "tc"
                assert plan.tiles * plan.splits >= min(132,
                                                       plan.tiles * stored)
                assert plan.splits * plan.per >= stored
    assert 2 * tqm.TC_RING <= 232448      # two blocks share an SM
    assert hasattr(tqm._sms, "cache_info")   # the SM count is read once


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size", [-1, 32])
def test_tc_split_plan_sums_to_the_jax_gemm(dtype, group_size, bits):
    """The tensor-core route's arithmetic in torch: each split's fp32
    product over its stored-row slice (the weight dequantized as the kernel
    does, q times the bf16-rounded scale in bf16; a packed int4 slice of
    stored rows [r0, r1) feeds reduction rows [r0, r1) from its low nibbles
    and [K/2 + r0, K/2 + r1) from its high ones), the splits summed in
    order, the bias added in fp32, one cast — against the JAX reference
    GEMM (fp32: max abs error over the output's max ``|want|``, to 1e-6,
    as the other summation order allows; bf16 per row as the module
    says)."""
    m, k, n = 24, 512 if bits == 4 else 256, 96
    q, s = _quantized(11, k, n, bits, group_size, dtype)
    rng = np.random.RandomState(12)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    td = _torch_dtype(dtype)
    xt = torch.from_numpy(x).to(td)
    s2 = torch.from_numpy(s).reshape(-1, n)
    packed = bits == 4
    # the route's splits (the plan's for bf16; fp32 sums the same splits)
    plan = tqm.qmm_plan(m, k, n, s2.shape[0], torch.bfloat16, packed, False,
                        True, 132)
    assert plan.route == "tc" and plan.splits > 1
    w = tqm.dequantize_weight(torch.from_numpy(q), s2, k=k,
                              out_dtype=td).float()
    kw, kh = q.shape[0], k // 2
    acc = torch.zeros(m, n)
    for z in range(plan.splits):
        r0 = z * plan.per * tqm.TC_STAGE
        r1 = min(kw, (z + 1) * plan.per * tqm.TC_STAGE)
        rows = torch.arange(r0, r1)
        if packed:
            rows = torch.cat([rows, kh + rows])
        acc = acc + xt[:, rows].float() @ w[rows]
    got = (acc + torch.from_numpy(bias)).to(td).float().numpy()
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jqm.quant_matmul_reference(
        jx, jnp.asarray(q), jnp.asarray(s), bias=jnp.asarray(bias)
    ).astype(jnp.float32))
    if dtype == "float32":   # split sums: held as the card holds it
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-6, err
    else:
        err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
        assert err.max() <= BF16_ROW_TOL


def test_qmm_dx_plan_splits_n_into_short_walks_at_the_serving_shapes():
    """GPT-125M's four dx GEMMs at a decode round (8 rows), the 24-token
    budget and 256 rows (the input-gradient drives) take the tensor-core
    dx route in bf16 and fp16, int8 per channel and g128 and packed int4
    g128 and per channel. Every stage of N is walked by exactly one split;
    a split walks ``DX_PER`` stages unless that leaves fewer than half the
    H100's 132 SMs a block (then fewer: int8 wo at M 24 walks 2, int4 wo 1)
    or more than two blocks an SM (then more: M 256); the grid keeps between
    66 blocks (or one a stage) and 264 (or one a tile)."""
    for m in (8, 24, 256):
        for k, n in SERVING_GEMMS:
            for packed, groups in ((False, 1), (False, k // 128),
                                   (True, k // 128), (True, 1)):
                for dtype in (torch.bfloat16, torch.float16):
                    plan = tqm.qmm_plan(m, k, n, groups, dtype, packed, True,
                                        True, 132)
                    stages = -(-n // tqm.TC_STAGE)
                    blocks = plan.tiles * plan.splits
                    assert plan.route == "tc"
                    assert (plan.splits - 1) * plan.per < stages \
                        <= plan.splits * plan.per
                    assert min(66, plan.tiles * stages) <= blocks \
                        <= max(264, plan.tiles), (m, k, n, packed, plan)
                    if plan.per > tqm.DX_PER:   # raised to fit 2 an SM
                        assert plan.tiles * -(-stages // (plan.per - 1)) > 264
                    elif plan.per < tqm.DX_PER:   # lowered to fill half
                        assert plan.tiles * -(-stages // (plan.per + 1)) < 66
    # the shapes the card measured: int4 g128 wqkv at M 24 walks 3 stages a
    # split (72 blocks; 0.0437 ms for the four dx against 0.0520 with one
    # stage a split and the card filled), int8 w1 at M 256 10 (240 blocks)
    assert tqm.qmm_plan(24, 768, 2304, 6, torch.bfloat16, True, True, True,
                        132) == tqm.QmmPlan("tc", 6, 12, 3)
    assert tqm.qmm_plan(256, 768, 3072, 1, torch.bfloat16, False, True, True,
                        132) == tqm.QmmPlan("tc", 48, 5, 10)


def _dx_tc_twin(dy, q, s2, k, td, plan):
    """The dx route's arithmetic in torch (``qmm_dx_kernel``): per tile of
    64 stored rows and pass of 64 dy rows, each split's fp32 partial over its
    stages of N (the weight dequantized as the kernel does: q times the
    scale rounded to ``td``, the product rounded to ``td``; a packed int4
    byte row i feeds dx column i from its low nibble and K / 2 + i from its
    high one, with the scale groups of those columns), the splits summed in
    order from 0, one cast."""
    m, n = dy.shape
    packed = q.shape[0] * 2 == k
    gs = k // s2.shape[0]
    kh = k // 2 if packed else 0
    p32 = q.to(torch.int32)
    halves = ([((p32 & 0xF) ^ 8) - 8, (((p32 >> 4) & 0xF) ^ 8) - 8]
              if packed else [p32])
    dyf = dy.to(td).float()
    out = torch.empty(m, k)
    for h, nib in enumerate(halves):
        cols = h * kh + torch.arange(q.shape[0])
        w = (nib.to(td) * s2[cols // gs].to(td)).float()   # rounded to td
        for r0 in range(0, q.shape[0], tqm.TC_STAGE):
            rows = torch.arange(r0, r0 + tqm.TC_STAGE)
            for m0 in range(0, m, tqm.TC_ROWS):
                ms = slice(m0, min(m, m0 + tqm.TC_ROWS))
                acc = torch.zeros(ms.stop - ms.start, len(rows))
                for z in range(plan.splits):
                    n0 = z * plan.per * tqm.TC_STAGE
                    n1 = min(n, (z + 1) * plan.per * tqm.TC_STAGE)
                    acc = acc + dyf[ms, n0:n1] @ w[rows, n0:n1].T
                out[ms, cols[rows]] = acc
    return out.to(td)


@pytest.mark.parametrize("m", [24, 160])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bits,group_size", [(8, -1), (8, 32), (4, -1),
                                             (4, 32)])
def test_tc_dx_split_plan_sums_to_the_jax_vjp(bits, group_size, dtype, m,
                                              monkeypatch):
    """The tensor-core dx route's arithmetic (``_dx_tc_twin``, on the bf16
    plan's splits; fp32 sums the same splits) against the JAX package's own
    dx: ``jax.vjp`` of ``quant_matmul(..., use_kernel=True)``, which runs
    ``_qmm_bwd_kernel`` / ``_qmm4_bwd_kernel`` in interpret mode (this jax
    names the kernels' compiler parameters ``CompilerParams``, which the
    package spells ``TPUCompilerParams``: aliased for the test). M 160 is
    three passes of 64 dy rows, the last partial; N 208 leaves a last stage
    of 16 columns. fp32: max abs error over the max ``|want|`` to 1e-6 (the
    summation orders differ); bf16 per row as the module says, fp16 per row
    to 2e-3 (two fp16 steps: both sides round one fp32 sum per element)."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    k, n = (256 if bits == 4 else 128), 208
    q, s = _quantized(13, k, n, bits, group_size, dtype)
    dy = np.random.RandomState(14).standard_normal((m, n)).astype(np.float32)
    td = _torch_dtype(dtype)
    s2 = torch.from_numpy(s).reshape(-1, n)
    plan = tqm.qmm_plan(m, k, n, s2.shape[0], torch.bfloat16, bits == 4, True,
                        True, 132)
    assert plan.route == "tc" and plan.splits > 1
    got = _dx_tc_twin(torch.from_numpy(dy), torch.from_numpy(q), s2, k, td,
                      plan).float().numpy()
    jd = jnp.dtype(dtype)
    jdx = jax.vjp(lambda x_: jqm.quant_matmul(
        x_, jnp.asarray(q), jnp.asarray(s), use_kernel=True),
        jnp.zeros((m, k), jd))[1](jnp.asarray(dy).astype(jd))[0]
    want = np.asarray(jdx.astype(jnp.float32))
    if dtype == "float32":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-6, err
    else:
        tol = BF16_ROW_TOL if dtype == "bfloat16" else 2e-3
        err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
        assert err.max() <= tol, err.max()
