"""Port mega-kernel serving (``ops/mega_decode.py`` and ``mega=True``
serving) against the JAX package on the CPU.

The reference's Pallas mega kernels cannot be traced on this jax, so the
port is held against ``mega_attn_layer_reference`` / ``mega_mlp_reference``
under ``jax.jit`` (the jitted step divides by 127 as a product with
fp32(1/127), which is the port's quantizer), ``build_unified_step(...,
use_kernel=False, mega=True)`` and ``ServingPredictor(use_kernel=False,
async_engine=False, mega_decode=True)``. Sizes follow
``tests/test_mega_decode.py``: h 32, head_dim 8, ffn 64, page 8, numpy
seeds. fp32 outputs are held at ``atol/rtol 1e-5`` (other summation
orders) on the rows a lane feeds (rows past ``q_lens`` are padding nobody
reads). The KV quantizer is bit-equal to the jitted reference's on the
same rows; the layer's int8 payloads may sit one step apart where the two
libraries' fp32 K / V rows differ in the last bit (see
:func:`_assert_valid_rows`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.inference.quantize import quantize_weight
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import mega_decode as jmega
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (random_state,
                                             serving_params_from_jax_numpy,
                                             state_from_jax_numpy)
from paddle_tpu_torch.ops import mega_decode as tmega

H, HD, F = 32, 8, 64          # 4 heads
PAGE = 8
TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _to_torch(tree):
    return serving_params_from_jax_numpy(_np_tree(tree), device="cpu")


def _layer(rng, quant=None, group=-1, head_major=False, hd=HD):
    """One layer's serving weights (4 heads of ``hd``) as a JAX dict and its
    port twin (the quantized leaves come from the reference's quantizer,
    bit for bit)."""
    def w(*s):
        return jnp.asarray(rng.randn(*s) * 0.05, jnp.float32)

    H = 4 * hd
    wqkv, bqkv = w(H, 3 * H), w(3 * H) * 0.1
    if head_major:
        nh = H // hd
        perm = np.arange(3 * H).reshape(3, nh, hd).transpose(1, 0, 2
                                                             ).reshape(-1)
        wqkv, bqkv = wqkv[:, perm], bqkv[perm]
    p = {"ln1_g": 1.0 + w(H), "ln1_b": w(H) * 0.1,
         "ln2_g": 1.0 + w(H), "ln2_b": w(H) * 0.1,
         "wqkv": wqkv, "bqkv": bqkv, "wo": w(H, H), "bo": w(H) * 0.1,
         "w1": w(H, F), "b1": w(F) * 0.1, "w2": w(F, H), "b2": w(H) * 0.1}
    if quant:
        for k in ("wqkv", "wo", "w1", "w2"):
            p[k] = quantize_weight(p[k], quant, group_size=group)
    return p, _to_torch(p)


def _geometry(rng, b=5, chunk=4, pps=4, kv_quant=False, hd=HD):
    """Lanes: 0 a deep-context single row, 1 idle (q_len 0), 2 a full chunk
    on a short context, 3 a first chunk (ctx 0), 4 a ragged chunk on a
    context that ends mid-page; 4 heads of ``hd``. Returns numpy arrays."""
    nh = 4
    num_pages = b * pps + 2
    if kv_quant:
        kp = rng.randint(-127, 128, (num_pages, PAGE, nh, hd)).astype(np.int8)
        vp = rng.randint(-127, 128, (num_pages, PAGE, nh, hd)).astype(np.int8)
        ks = (np.abs(rng.randn(num_pages, PAGE, nh)) * 0.01
              + 1e-3).astype(np.float32)
        vs = (np.abs(rng.randn(num_pages, PAGE, nh)) * 0.01
              + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(num_pages, PAGE, nh, hd).astype(np.float32)
        vp = rng.randn(num_pages, PAGE, nh, hd).astype(np.float32)
        ks = vs = None
    ctx = np.array([13, 0, 5, 0, 11][:b], np.int32)
    qlens = np.array([1, 0, chunk, max(chunk - 1, 1), max(chunk // 2, 1)][:b],
                     np.int32)
    pt = np.full((b, pps), -1, np.int32)
    used = iter(rng.permutation(num_pages))
    for i in range(b):
        need = -(-int(ctx[i] + qlens[i]) // PAGE) if qlens[i] else 0
        for j in range(need):
            pt[i, j] = next(used)
    xb = rng.randn(b, chunk, nh * hd).astype(np.float32)
    return xb, (kp, vp, ks, vs), pt, ctx, qlens


def _jt(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _jj(a):
    return None if a is None else jnp.asarray(a)


def _assert_valid_rows(got, want, qlens):
    """Compare [b, chunk, ...] outputs on the rows each lane feeds: fp32 to
    ``TOL``; int8 payloads within one quantization step, and in fewer than
    1% of the entries, where the two libraries' fp32 K / V rows (other GEMM
    summation orders) differ in the last bit at a rounding boundary. The
    scales are absmax * fp32(1/127) of those rows: within ``TOL``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    valid = np.arange(got.shape[1])[None] < np.asarray(qlens)[:, None]
    g, w = got[valid], want[valid]
    if got.dtype == np.int8:
        diff = np.abs(g.astype(np.int32) - w)
        assert diff.max(initial=0) <= 1 and (diff > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(g, w, **TOL)


def _run_attn(p_j, p_t, geom, head_major=False, fuse_epilogue=True):
    xb, (kp, vp, ks, vs), pt, ctx, qlens = geom
    ref = jax.jit(functools.partial(
        jmega.mega_attn_layer_reference, eps=1e-5, head_major=head_major,
        fuse_epilogue=fuse_epilogue))(
        jnp.asarray(xb), p_j, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qlens),
        k_scales=_jj(ks), v_scales=_jj(vs))
    got = tmega.mega_attn_layer(
        _jt(xb), p_t, _jt(kp), _jt(vp), _jt(pt), _jt(ctx), _jt(qlens),
        eps=1e-5, k_scales=_jt(ks), v_scales=_jt(vs), head_major=head_major,
        fuse_epilogue=fuse_epilogue)
    return ref, got


# (chunk, weights, group, int8 KV, head_dim): every weight / KV format at
# head_dim 8 and chunks 1-4; a decode chunk and an int8 chunk at the head
# dims the CUDA kernel is built for (gpt3-tiny 32, 64, gpt3-2.7b 80,
# gpt3-760m 96)
ATTN_CASES = [(chunk, quant, group, kv, HD)
              for chunk in (1, 2, 3, 4)
              for quant, group, kv in (
                  (None, -1, False),
                  ("int8", -1, False),        # per-channel weight scales
                  ("int8", 16, False),        # two groups over h
                  (None, -1, True),           # int8 KV pools, fp weights
                  ("int8", 16, True))] + [    # int8 weights and int8 KV
    (chunk, quant, group, kv, d) for d in (32, 64, 80, 96)
    for chunk, quant, group, kv in ((1, None, -1, False),
                                    (3, "int8", 16, True))]


@pytest.mark.parametrize("chunk,quant,group,kv_quant,d", ATTN_CASES)
def test_attn_twin_matches_jax_reference(chunk, quant, group, kv_quant, d):
    rng = np.random.RandomState(100 + chunk + (d if d != HD else 0))
    p_j, p_t = _layer(rng, quant, group, hd=d)
    geom = _geometry(rng, chunk=chunk, kv_quant=kv_quant, hd=d)
    ref, got = _run_attn(p_j, p_t, geom)
    assert len(got) == len(ref) == (6 if kv_quant else 4)
    qlens = geom[4]
    for r, g in zip(ref, got):       # y2, s, k_new, v_new[, k_sc, v_sc]
        _assert_valid_rows(g.numpy(), r, qlens)
    if kv_quant:
        assert got[2].dtype == got[3].dtype == torch.int8


@pytest.mark.parametrize("kv_quant", [False, True])
def test_attn_twin_head_major_and_partial(kv_quant):
    """The head-major qkv column order and the ``fuse_epilogue=False``
    partial (the tensor-parallel spelling) against the reference."""
    rng = np.random.RandomState(7)
    p_j, p_t = _layer(rng, "int8", 8, head_major=True)
    geom = _geometry(rng, chunk=3, kv_quant=kv_quant)
    for fuse in (True, False):
        ref, got = _run_attn(p_j, p_t, geom, head_major=True,
                             fuse_epilogue=fuse)
        assert len(got) == len(ref) == (2 if kv_quant else 0) + (
            4 if fuse else 3)
        for r, g in zip(ref, got):
            _assert_valid_rows(g.numpy(), r, geom[4])


@pytest.mark.parametrize("quant,group", [(None, -1), ("int8", -1),
                                         ("int8", 16)])
@pytest.mark.parametrize("fuse", [True, False])
def test_mlp_twin_matches_jax_reference(quant, group, fuse):
    rng = np.random.RandomState(5)
    p_j, p_t = _layer(rng, quant, group)
    for t in (1, 6, 9):
        y2 = rng.randn(t, H).astype(np.float32)
        sres = rng.randn(t, H).astype(np.float32)
        ref = jax.jit(functools.partial(jmega.mega_mlp_reference,
                                        fuse_epilogue=fuse))(
            jnp.asarray(y2), jnp.asarray(sres) if fuse else None, p_j)
        got = tmega.mega_mlp(_jt(y2), _jt(sres) if fuse else None, p_t,
                             fuse_epilogue=fuse)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("quant,group", [(None, -1), ("int8", -1),
                                         ("int8", 16)])
@pytest.mark.parametrize("fuse", [True, False])
def test_mlp_twin_live_rows_match_jax_reference(quant, group, fuse):
    """Given ``q_lens``, the twin (the kernel's oracle) equals the JAX
    ``mega_mlp_reference`` on the rows each lane feeds and is exactly zero
    in the others: lanes of chunk 4 with a full, a partial, an idle and a
    one-row lane."""
    rng = np.random.RandomState(7)
    p_j, p_t = _layer(rng, quant, group)
    chunk, qlens = 4, np.array([4, 2, 0, 1], np.int32)
    t = chunk * len(qlens)
    y2 = rng.randn(t, H).astype(np.float32)
    sres = rng.randn(t, H).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        jmega.mega_mlp_reference, fuse_epilogue=fuse))(
        jnp.asarray(y2), jnp.asarray(sres) if fuse else None, p_j))
    got = tmega.mega_mlp(_jt(y2), _jt(sres) if fuse else None, p_t,
                         fuse_epilogue=fuse, q_lens=_jt(qlens),
                         chunk=chunk).numpy()
    live = np.arange(t) % chunk < qlens[np.arange(t) // chunk]
    assert live.sum() == qlens.sum()
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    assert not got[~live].any()
    np.testing.assert_array_equal(
        tmega.live_rows(t, _jt(qlens), chunk).numpy(), live)
    dense = tmega.mega_mlp(_jt(y2), _jt(sres) if fuse else None, p_t,
                           fuse_epilogue=fuse, chunk=chunk).numpy()
    np.testing.assert_allclose(dense, ref, **TOL)


def test_mlp_plan_covers_fills_and_ignores_row_values():
    """The MLP kernel's plan reads the weights' shapes only (no row count,
    no q_lens): GEMM1 producers tile the ffn columns once; GEMM2 consumers
    tile (h columns x ffn splits) once, each split whole 64-row stages and
    a whole number of producers (the last split ends at ffn, on any
    width); GPT-125M's plan fills a wave of the H100's 132 SMs with
    consumers reading as many weight bytes as producers; every block's
    shared memory lets two blocks share an SM."""
    import inspect

    assert list(inspect.signature(tmega.mlp_plan).parameters) == ["h", "f"]
    cols, stage = tmega.MLP_COLS, tmega.MLP_STAGE
    for h, f in ((768, 3072), (1536, 6144), (2560, 10240), (256, 640),
                 (64, 128), (4096, 16384), (192, 640), (128, 128),
                 (200, 640), (200, 600), (4, 7), (100, 1000), (36, 4000)):
        plan = tmega.mlp_plan(h, f)
        assert plan.producers == -(-f // cols)
        assert plan.consumers == -(-h // cols) * plan.splits
        assert plan.blocks == plan.producers + plan.consumers
        # the kernel's split: fs rows of whole stages, fs / 32 producers
        fs = -(-f // stage) // plan.splits * stage
        assert fs % stage == 0 and (plan.splits - 1) * fs < f
        ffn = sorted(r for s in range(plan.splits)
                     for r in range(s * fs, min(f, (s + 1) * fs)))
        assert ffn == list(range(f))
        owners = [min(p * cols // fs, plan.splits - 1)
                  for p in range(plan.producers)]
        assert [p * cols // fs for p in range(plan.producers)] == owners
        assert set(owners) == set(range(plan.splits))
        hcols = sorted(c for j in range(-(-h // cols))
                       for c in range(j * cols, min(h, (j + 1) * cols)))
        assert hcols == list(range(h))
    served = tmega.mlp_plan(768, 3072)
    assert served == (4, 96, 96, 192) and served.blocks >= 132
    # a consumer's w2 slice (f / splits x 32) matches a producer's w1 slice
    assert 3072 // served.splits * 32 == 768 * 32
    # two blocks share an SM, with the row tables of 64 lanes
    assert 2 * (tmega.MLP_RING + 4 * (64 + 1 + 64)) <= 232448


def test_quantizer_bit_equal_to_jitted_reference():
    """The port's KV quantizer against ``jax.jit`` of the reference mega
    kernels' ``_quantize_rows_f32``, on rows of every magnitude."""
    rng = np.random.RandomState(9)
    x = (rng.randn(64, 4, HD) * np.exp(rng.randn(64, 4, 1) * 3)
         ).astype(np.float32)
    x[0] = 0.0                                   # the 1e-8 floor
    q_j, s_j = jax.jit(jmega._quantize_rows_f32)(jnp.asarray(x.reshape(-1,
                                                                       HD)))
    q_t, s_t = tkv.quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy().reshape(-1, HD),
                                  np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().reshape(-1),
                                  np.asarray(s_j)[:, 0])


def test_validate_mega_config_rejections():
    """The reference's cases (``tests/test_mega_decode.py``)."""
    for wd, gs, hd, kw in ((None, -1, 16, {}), ("int8", -1, 16, {}),
                           ("int8", 16, 16, {}), ("int8", 8, 16, {}),
                           ("int8", 32, 16, {}), (None, -1, 16, {"mp": 2}),
                           ("int8", 16, 16, {"mp": 4})):
        tmega.validate_mega_config(wd, gs, hd, **kw)
        jmega.validate_mega_config(wd, gs, hd, **kw)
    for args, match in ((("int4", -1, 16), "int4"),
                        (("int8", 24, 16), "group")):
        for fn in (tmega.validate_mega_config, jmega.validate_mega_config):
            with pytest.raises(ValueError, match=match):
                fn(*args)
    for fn in (tmega.validate_mega_config, jmega.validate_mega_config):
        with pytest.raises(ValueError, match="dense-only"):
            fn(None, -1, 16, moe_experts=4)


def test_paged_write_packed_prequant_bit_equal():
    rng = np.random.RandomState(4)
    num_pages, nh = 5, 4
    pages = rng.randint(-127, 128, (num_pages, PAGE, nh, HD)).astype(np.int8)
    scales = rng.rand(num_pages, PAGE, nh).astype(np.float32)
    q_toks = rng.randint(-127, 128, (6, nh, HD)).astype(np.int8)
    s_toks = rng.rand(6, nh).astype(np.float32)
    pt = np.array([[3, 1], [0, -1]], np.int32)
    slot = np.array([0, 0, 1, -1, 1, 0], np.int32)
    pos = np.array([7, 8, 2, 0, 9, 15], np.int32)   # (1, 1): unallocated
    jp, js = jkv.paged_write_packed_prequant(
        *(jnp.asarray(a) for a in (pages, scales, q_toks, s_toks, pt, slot,
                                   pos)), PAGE)
    tp, ts = tkv.paged_write_packed_prequant(
        *(torch.from_numpy(a) for a in (pages, scales, q_toks, s_toks, pt,
                                        slot, pos)), PAGE)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tp.numpy() != pages).any()


def test_wrappers_run_the_twins_on_cpu():
    """A CPU tensor runs the plain version (no launch counted);
    ``use_kernel=True`` has no CPU kernel and raises."""
    rng = np.random.RandomState(2)
    _, p_t = _layer(rng)
    xb, (kp, vp, _, _), pt, ctx, qlens = _geometry(rng)
    before = (tmega.mega_attn_layer.launches, tmega.mega_mlp.launches)
    args = (_jt(xb), p_t, _jt(kp), _jt(vp), _jt(pt), _jt(ctx), _jt(qlens))
    got = tmega.mega_attn_layer(*args)
    want = tmega.mega_attn_layer(*args, use_kernel=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    y = torch.from_numpy(rng.randn(3, H).astype(np.float32))
    assert torch.equal(tmega.mega_mlp(y, y, p_t),
                       tmega.mega_mlp_reference(y, y, p_t))
    assert (tmega.mega_attn_layer.launches,
            tmega.mega_mlp.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tmega.mega_attn_layer(*args, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tmega.mega_mlp(y, y, p_t, use_kernel=True)


# ---------------------------------------------------------------------------
# the unified step and the predictor
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.5)


def _pair(seed=3, **over):
    named = random_state(tgpt.GPTConfig(**TINY), seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, **over))
    jm.eval()
    for name, t in _named_state(jm).items():
        t.set_value(named[name])
    tm = state_from_jax_numpy(named, tgpt.GPTConfig(**TINY, **over),
                              device="cpu")
    tm.eval()
    return jm, tm


def _step_args(lanes, b, t):
    """Packed step arrays for ``lanes``: slot -> (kv_len, tokens)."""
    tok_ids = np.zeros(t, np.int32)
    tok_slot = np.full(t, -1, np.int32)
    tok_pos = np.zeros(t, np.int32)
    q_lens = np.zeros(b, np.int32)
    kv_lens = np.zeros(b, np.int32)
    last_idx = np.full(b, t, np.int32)
    emit = np.zeros(b, np.int32)
    w = 0
    for slot, (kv_len, toks) in sorted(lanes.items()):
        n = len(toks)
        tok_ids[w:w + n] = toks
        tok_slot[w:w + n] = slot
        tok_pos[w:w + n] = np.arange(kv_len, kv_len + n)
        q_lens[slot], kv_lens[slot] = n, kv_len
        last_idx[slot] = w + n - 1
        emit[slot] = 1
        w += n
    return tok_ids, tok_slot, tok_pos, q_lens, kv_lens, last_idx, emit


@pytest.mark.parametrize("weight_dtype,group_size,kv_quant", [
    (None, -1, False), ("int8", 8, True)])
def test_unified_step_mega_matches_jax(weight_dtype, group_size, kv_quant):
    """Two mega steps: two prefill chunks, then a decode lane, a continuing
    chunk and a copy-on-write lane reading the copied page. Logits, fp
    pools and scale planes to 1e-5; int8 pools as in
    :func:`_assert_valid_rows`."""
    jm, _ = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    ps, chunk, b, t, num_pages = 4, 4, 3, 8, 6
    jparams = jgpt.serving_params(jm)
    if weight_dtype:
        from paddle_tpu.inference import quantize as jquantize
        jparams = jquantize.quantize_serving_params(jparams, weight_dtype,
                                                    group_size)
    tparams = _to_torch(jparams)
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads, cfg.head_dim)
    ext = (shape[0], num_pages + 1) + shape[2:]
    if kv_quant:
        jpools = [jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
                  jnp.zeros(shape[:4], jnp.float32),
                  jnp.zeros(shape[:4], jnp.float32)]
        tpools = [torch.zeros(ext, dtype=torch.int8),
                  torch.zeros(ext, dtype=torch.int8), torch.zeros(ext[:4]),
                  torch.zeros(ext[:4])]
    else:
        jpools = [jnp.zeros(shape, jnp.float32) for _ in range(2)]
        tpools = [torch.zeros(ext), torch.zeros(ext)]
    jstep = jgpt.build_unified_step(jgpt.GPTConfig(**TINY), ps, chunk,
                                    use_kernel=False, kv_quant=kv_quant,
                                    mega=True)
    tstep = tgpt.build_unified_step(cfg, ps, chunk, kv_quant=kv_quant,
                                    mega=True)
    zb, zt = np.zeros(b, np.int32), np.zeros(t, np.int32)
    rounds = [
        (np.array([[1, 3], [0, 2], [-1, -1]], np.int32),
         {0: (0, [5, 6, 7, 8]), 1: (0, [9, 10, 11])},
         np.full(b, num_pages, np.int32), np.full(b, num_pages, np.int32)),
        (np.array([[1, 3], [0, 2], [4, -1]], np.int32),
         {0: (4, [12]), 1: (3, [13, 14]), 2: (3, [15])},
         np.array([0, 0, 1], np.int32),
         np.array([num_pages, num_pages, 4], np.int32)),
    ]
    for pt, lanes, cow_src, cow_dst in rounds:
        ids, slot, pos, ql, kl, last, emit = _step_args(lanes, b, t)
        jout, jlog, *jpools = jstep(
            jparams, *(jnp.asarray(a) for a in
                       (ids, slot, pos, ql, kl, last, zt, zb, emit, zb)),
            *jpools, jnp.asarray(pt), jnp.asarray(cow_src),
            jnp.asarray(cow_dst), jnp.zeros((b, 2), jnp.uint32),
            jnp.zeros(b, jnp.float32), jnp.zeros(b, jnp.int32),
            jnp.ones(b, jnp.float32))
        tout, tlog, *tpools = tstep(
            tparams, *(torch.from_numpy(a) for a in
                       (ids, slot, pos, ql, kl, last, zt, zb, emit, zb)),
            *tpools, torch.from_numpy(pt), torch.from_numpy(cow_src),
            torch.from_numpy(cow_dst), torch.zeros(b, dtype=torch.int64),
            torch.zeros(b), torch.zeros(b, dtype=torch.int32), torch.ones(b))
        rows = sorted(lanes)
        np.testing.assert_allclose(tlog.numpy()[rows],
                                   np.asarray(jlog)[rows], **TOL)
        np.testing.assert_array_equal(tout.numpy()[rows],
                                      np.asarray(jout)[rows])
        for tpool, jpool in zip(tpools, jpools):
            got, want = tpool[:, :num_pages].numpy(), np.asarray(jpool)
            assert got.dtype == want.dtype
            if want.dtype == np.int8:      # as in _assert_valid_rows
                diff = np.abs(got.astype(np.int32) - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            else:
                np.testing.assert_allclose(got, want, **TOL)
    assert tpools[0][:, 4].abs().sum() > 0           # the CoW page landed


def test_mega_step_rows_past_q_lens_are_not_read():
    """The mega step hands ``mega_mlp`` its lanes' ``q_lens`` (rows past
    them come back zero); the step's logits equal those of the same step
    with the MLP computing every row, so nothing reads those rows."""
    jm, _ = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    ps, chunk, b, t, num_pages = 4, 4, 3, 8, 6
    tparams = _to_torch(jgpt.serving_params(jm))
    shape = (cfg.num_layers, num_pages + 1, ps, cfg.num_heads, cfg.head_dim)
    step = tgpt.build_unified_step(cfg, ps, chunk, mega=True)
    lanes = {0: (0, [5, 6, 7]), 2: (0, [9])}
    ids, slot, pos, ql, kl, last, emit = _step_args(lanes, b, t)
    pt = np.array([[1, -1], [-1, -1], [0, -1]], np.int32)
    zb, zt = np.zeros(b, np.int32), np.zeros(t, np.int32)
    seen = []
    real = tgpt.mega_mlp

    def run(mlp):
        pools = [torch.zeros(shape), torch.zeros(shape)]
        tgpt.mega_mlp = mlp
        try:
            return step(tparams, *(torch.from_numpy(a) for a in
                                   (ids, slot, pos, ql, kl, last, zt, zb,
                                    emit, zb)),
                        *pools, torch.from_numpy(pt),
                        torch.full((b,), num_pages, dtype=torch.int32),
                        torch.full((b,), num_pages, dtype=torch.int32),
                        torch.zeros(b, dtype=torch.int64), torch.zeros(b),
                        torch.zeros(b, dtype=torch.int32), torch.ones(b))
        finally:
            tgpt.mega_mlp = real

    def recording(y2, s_res, p, **kw):
        out = real(y2, s_res, p, **kw)
        seen.append((kw["q_lens"].tolist(), int((out != 0).any(-1).sum())))
        return out

    def dense(y2, s_res, p, **kw):
        kw.pop("q_lens")
        return real(y2, s_res, p, **kw)

    masked, full = run(recording), run(dense)
    assert seen == [(ql.tolist(), 4)] * cfg.num_layers
    rows = sorted(lanes)
    np.testing.assert_array_equal(masked[1].numpy()[rows],
                                  full[1].numpy()[rows])
    np.testing.assert_array_equal(masked[0].numpy()[rows],
                                  full[0].numpy()[rows])


def _churn():
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    return [p0,
            [int(x) for x in rng.randint(0, 97, 9)],
            [int(x) for x in rng.randint(0, 97, 17)],
            list(p0),                                  # duplicate: CoW
            p0[:20] + [int(x) for x in rng.randint(0, 97, 6)],  # shared
            [int(x) for x in rng.randint(0, 97, 3)]]


KW = dict(max_batch=3, page_size=8, chunk=8, num_pages=10)


@pytest.mark.parametrize("quant", [
    {}, dict(weight_dtype="int8", weight_quant_group_size=8,
             kv_cache_dtype="int8")])
def test_mega_predictor_matches_jax_and_per_op(quant):
    """Greedy churns (preemption, prefix hits, copy-on-write) through the
    mega step: token-identical to the JAX synchronous mega predictor and
    to the port's own per-op predictor; int8 pools stay int8."""
    jm, tm = _pair(**quant)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False,
                       mega_decode=True, **KW)
    tsp = ServingPredictor(tm, device="cpu", mega_decode=True, **KW)
    want = jsp.generate(_churn(), max_new_tokens=12)
    got = tsp.generate(_churn(), max_new_tokens=12)
    assert all(want) and len({t for s in want for t in s}) > 3
    assert got == want
    assert ServingPredictor(tm, device="cpu", **KW).generate(
        _churn(), max_new_tokens=12) == got
    jt, tt = jsp.telemetry(), tsp.telemetry()
    for key in ("serving_preemptions", "kv_cow_copies",
                "kv_prefix_hit_tokens", "serving_steps",
                "serving_tokens_emitted"):
        assert tt[key] == jt[key], key
    assert tt["serving_preemptions"] > 0 and tt["kv_cow_copies"] > 0
    int8_kv = quant.get("kv_cache_dtype") == "int8"
    assert (tsp.cache.k_pool.dtype == torch.int8) == int8_kv
    assert tsp.mega_decode and tsp._unified.mega


def test_mega_sampled_churn_matches_per_op():
    """Seeded sampling through the mega step equals the per-op step's
    (the lane uniforms are the port's own, so only within the port)."""
    _, tm = _pair()
    kw = dict(max_new_tokens=10, temperature=1.0, top_p=0.9, seed=3)
    mega = ServingPredictor(tm, device="cpu", mega_decode=True,
                            **KW).generate(_churn(), **kw)
    per_op = ServingPredictor(tm, device="cpu", **KW).generate(_churn(),
                                                               **kw)
    greedy = ServingPredictor(tm, device="cpu", **KW).generate(
        _churn(), max_new_tokens=10)
    assert mega == per_op and mega != greedy


def test_mega_unbuilt_head_dim_fails_at_construction(monkeypatch):
    """On a CUDA device a mega build refuses a head dim the mega kernels are
    not built for when it is built, naming the dim and the built ones; on
    the CPU (the plain versions) it builds, and every built head dim (32,
    64, 80, 96, 128: gpt3-tiny's to gpt3-2.7b's) builds on CUDA too. The
    predictor refuses before any weight moves."""
    cfg = tgpt.GPTConfig(**TINY)                       # head_dim 8
    with pytest.raises(NotImplementedError,
                       match=r"built for head_dim in \(32, 64, 80, 96, 128\),"
                             r" got 8 .*mega_decode=False"):
        tgpt.build_unified_step(cfg, 8, 4, mega=True, device="cuda")
    assert tgpt.build_unified_step(cfg, 8, 4, mega=True, device="cpu").mega
    assert tgpt.build_unified_step(cfg, 8, 4, device="cuda")       # per-op
    for d in tmega.HEAD_DIMS:
        built = tgpt.GPTConfig(**dict(TINY, hidden_size=2 * d, num_heads=2))
        assert built.head_dim == d
        assert tgpt.build_unified_step(built, 8, 4, mega=True,
                                       device="cuda").mega
    wide = tgpt.GPTConfig(**dict(TINY, hidden_size=512, num_heads=2))
    with pytest.raises(NotImplementedError, match="got 256"):
        tgpt.build_unified_step(wide, 8, 4, mega=True, device="cuda")
    _, tm = _pair(mega_decode=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="head_dim"):
        ServingPredictor(tm, device="cuda", **KW)


def test_mega_config_flag_and_int4_rejection():
    """``GPTConfig.mega_decode`` selects the mega step, the argument
    overrides it, and int4 weights raise at construction as in the
    reference."""
    _, tm = _pair(mega_decode=True)
    assert ServingPredictor(tm, device="cpu", **KW)._unified.mega
    assert not ServingPredictor(tm, device="cpu", mega_decode=False,
                                **KW)._unified.mega
    _, t4 = _pair(mega_decode=True, weight_dtype="int4")
    with pytest.raises(ValueError, match="int4"):
        ServingPredictor(t4, device="cpu", **KW)
    with pytest.raises(ValueError, match="int4"):
        tgpt.build_unified_step(tgpt.GPTConfig(**TINY, weight_dtype="int4"),
                                8, 4, mega=True)


# -- the attention kernel's split walk, written out in torch ----------------


def mega_split_twin(xb, p, kp, vp, pt, ctx, qlens, pages, ks=None, vs=None,
                    eps=1e-5):
    """The mega attention kernel's algorithm in torch (fp32): LN1 and Q /
    K / V of every new row (the producers' work), then per (lane, head) a
    causal split (the block over the lane's new rows, with int8 pools
    their quantize-dequantize image) and page splits of ``pages`` pages over the pool keys below the context
    (every new row sees all of them), each an online softmax over tiles of
    32 keys, merged in split order; then the heads' output projections
    summed in head order, the residual + bo and LN2. Returns (y2, s)."""
    from test_torch_paged_attention import _merge, _tile_walk

    b, chunk, h = xb.shape
    num_pages, ps, nh, hd = kp.shape
    pps = pt.shape[1]
    y1 = tmega._ln_f32(xb, p["ln1_g"], p["ln1_b"], eps)
    q4 = (tmega._mm(y1, p["wqkv"]) + p["bqkv"]).reshape(b, chunk, 3, nh, hd)
    q, kn, vn = q4[:, :, 0], q4[:, :, 1], q4[:, :, 2]
    if ks is not None:
        (kq, ksc), (vq, vsc) = (tkv.quantize_kv_rows(t) for t in (kn, vn))
        kn, vn = kq.float() * ksc[..., None], vq.float() * vsc[..., None]
    wo = p["wo"]
    if isinstance(wo, dict):
        wo = tmega.dequantize_weight(wo["q"], wo["s"])
    scale = 1.0 / np.sqrt(hd)
    y = torch.zeros(b, chunk, h)
    for i in range(b):
        ql, c = int(qlens[i]), min(int(ctx[i]), pps * ps)
        for n in range(nh):
            if ql == 0:
                continue
            qr = q[i, :ql, n]
            parts = [_tile_walk(qr, kn[i, :ql, n], vn[i, :ql, n], 0,
                                torch.arange(ql) + 1, scale)]
            for z in range(-(-pps // pages)):
                k0, k1 = z * pages * ps, min(c, (z + 1) * pages * ps)
                if k1 <= k0:
                    parts.append(None)
                    continue
                keys = torch.arange(k0, k1)
                page = pt[i, keys // ps].long().clamp(0, num_pages - 1)
                kk, vv = (t[page, keys % ps, n].float() for t in (kp, vp))
                if ks is not None:
                    kk = kk * ks[page, keys % ps, n][:, None]
                    vv = vv * vs[page, keys % ps, n][:, None]
                parts.append(_tile_walk(qr, kk, vv, k0,
                                        torch.full((ql,), c), scale))
            y[i, :ql] += _merge(parts) @ wo[n * hd:(n + 1) * hd]
    s = xb + y + p["bo"]
    return tmega._ln_f32(s, p["ln2_g"], p["ln2_b"], eps), s


@pytest.mark.parametrize("pages", [1, 2, 3])
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("d,quant,group", [(8, None, -1), (32, "int8", 16)])
def test_mega_split_twin_matches_jax_reference(d, quant, group, kv_quant,
                                               pages):
    """The kernel's split-and-merge walk (a causal split over the new
    rows, page splits in order, empty splits past the context, contexts
    ending mid-page, an idle lane, a first chunk on ctx 0) computes the
    reference's function: y2 and s at fp32 1e-5."""
    rng = np.random.RandomState(300 + pages + d)
    p_j, p_t = _layer(rng, quant, group, hd=d)
    geom = _geometry(rng, chunk=3, kv_quant=kv_quant, hd=d)
    ref, _ = _run_attn(p_j, p_t, geom)
    xb, (kp, vp, ks, vs), pt, ctx, qlens = geom
    got = mega_split_twin(_jt(xb), p_t, _jt(kp), _jt(vp), _jt(pt), ctx,
                          qlens, pages, _jt(ks), _jt(vs))
    for r, g in zip(ref[:2], got):
        _assert_valid_rows(g.numpy(), r, qlens)


def test_mega_plan_fills_the_card_at_a_decode_round():
    """GPT-125M's decode round (8 lanes, 12 heads, a 1,024-token table):
    the causal splits plus the page splits fill at least one wave of the
    H100's 132 SMs (one block a (lane, head) gave 96), every page is walked
    by one split, the QKV producers take lanes up to 16 rows (one lane of
    16, all 8 of one), and the plan reads shapes only."""
    for kv_elt in (4, 2, 1):
        for chunk, group in ((16, 1), (1, 8)):
            plan = tmega.mega_plan(8, 12, 16, 64, 64, chunk, kv_elt, 132)
            assert plan.splits > 1 and plan.group == group
            assert 8 * 12 * (1 + plan.splits) / 132 >= 1
            assert (plan.splits - 1) * plan.pages < 16 \
                <= plan.splits * plan.pages
            assert plan.blocks == 3 * (8 // group) * 12 \
                + 8 * 12 * (1 + plan.splits)
            assert plan == tmega.mega_plan(8, 12, 16, 64, 64, chunk, kv_elt,
                                           132)
    # producers take whole lanes, one at least, none past the batch
    assert tmega.mega_plan(3, 4, 8, 16, 64, 1, 4, 132).group == 3
    assert tmega.mega_plan(8, 4, 8, 16, 64, 4, 4, 132).group == 4
    assert tmega.mega_plan(8, 4, 8, 16, 64, 64, 4, 132).group == 1
