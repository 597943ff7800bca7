"""Port MoE (``paddle_tpu_torch/models/moe.py``, the MoE GPT and its
serving) against the JAX package on the CPU.

Tiny sizes: h 32, 2 layers, 4 heads, 4 experts top-2, ffn 128, page 8. The
reference runs ``use_kernel=False`` everywhere (its grouped-GEMM Pallas
kernels cannot trace on this jax), and every reference stream is checked
to be non-empty before it is compared. Tolerances: fp32 ``atol/rtol 1e-5``
on outputs (another summation order; the model weights use
``initializer_range 0.5``, so logits reach ~10 and are held at ``atol
1e-4``); parameter gradients, summed over every routed row, as the max abs
error over the tensor's max ``|grad|``, to ``1e-5``; routing decisions,
slot positions, capacities, quantized payloads and token streams are
compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import quantize as jquantize
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import moe as jmoe
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference import quantize as tquantize
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import moe as tmoe
from paddle_tpu_torch.models.convert import (random_state,
                                             serving_params_from_jax_numpy,
                                             state_from_jax_numpy)

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.5, intermediate_size=128,
            moe_experts=4, moe_top_k=2)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _ffn_weights(seed=0, d=32, f=128, e=4, n=24):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, d)).astype(np.float32),
            "gate_w": rng.standard_normal((d, e)).astype(np.float32),
            "w1": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
            "b1": (0.1 * rng.standard_normal((e, f))).astype(np.float32),
            "w2": (0.2 * rng.standard_normal((e, f, d))).astype(np.float32),
            "b2": (0.1 * rng.standard_normal((e, d))).astype(np.float32)}


def _args(w, lib):
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return [conv(w[k]) for k in ("x", "gate_w", "w1", "b1", "w2", "b2")]


def test_route_topk_ties_go_to_the_lowest_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.0],     # tie for the first choice
                       [2.0, 2.0, 2.0, 2.0],     # all tied
                       [0.0, 1.0, 5.0, 1.0],     # tie for the second
                       [-1.0, 4.0, 0.5, 2.0]], np.float32)
    jg, ji, jp, jm = jmoe.route_topk(jnp.asarray(logits), 2)
    tg, ti, tp, tm = tmoe.route_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(ti)[:3], [[1, 2], [0, 1], [2, 1]])
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **TOL)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # top-3 keeps the choices distinct under ties
    assert len(set(_np(tmoe.route_topk(torch.from_numpy(logits), 3)[1])[1])
               ) == 3


@pytest.mark.parametrize("with_valid", [False, True])
def test_capacity_positions_and_aux(with_valid):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((20, 4)).astype(np.float32)
    valid = rng.random(20) > 0.3
    jv = jnp.asarray(valid) if with_valid else None
    tv = torch.from_numpy(valid) if with_valid else None
    _, _, jp, jm = jmoe.route_topk(jnp.asarray(logits), 2)
    _, _, tp, tm = tmoe.route_topk(torch.from_numpy(logits), 2)
    for cap in (3, 6, 40):
        np.testing.assert_array_equal(
            _np(tmoe.capacity_positions(tm, cap, valid=tv)),
            np.asarray(jmoe.capacity_positions(jm, cap, valid=jv)))
    np.testing.assert_allclose(
        _np(tmoe.load_balance_aux(tp, tm[0], valid=tv)),
        np.asarray(jmoe.load_balance_aux(jp, jm[0], valid=jv)), **TOL)
    for n, e, k, cf in ((20, 4, 2, 1.25), (3, 8, 2, 0.5), (1000, 4, 2, 4.0),
                        (24, 4, 1, 0.5)):
        assert tmoe.moe_capacity(n, e, k, cf) == jmoe.moe_capacity(n, e, k,
                                                                   cf)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("with_valid", [False, True])
def test_moe_ffn_matches_jax(cf, with_valid):
    """``moe_ffn`` with drops (cf 0.5), the production factor and no drops,
    with and without padding rows: output, aux and stats."""
    w = _ffn_weights()
    valid = np.random.default_rng(4).random(24) > 0.25
    kw = dict(top_k=2, capacity_factor=cf, with_stats=True)
    jout, jaux, jst = jmoe.moe_ffn(
        *_args(w, "jax"), use_kernel=False,
        valid=jnp.asarray(valid) if with_valid else None, **kw)
    tout, taux, tst = tmoe.moe_ffn(
        *_args(w, "torch"),
        valid=torch.from_numpy(valid) if with_valid else None, **kw)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(taux), np.asarray(jaux), **TOL)
    np.testing.assert_allclose(_np(tst["load"]), np.asarray(jst["load"]),
                               **TOL)
    np.testing.assert_allclose(_np(tst["drop_rate"]),
                               np.asarray(jst["drop_rate"]), **TOL)
    assert tst["capacity"] == float(jst["capacity"])
    if cf == 0.5:
        assert float(tst["drop_rate"]) > 0
    if with_valid:
        assert not _np(tout)[~valid].any()       # padding rows output zero


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_einsum_spelling_equals_grouped(cf):
    w = _ffn_weights(seed=2)
    kw = dict(top_k=2, capacity_factor=cf)
    tout, taux = tmoe.moe_ffn(*_args(w, "torch"), **kw)
    eout, eaux = tmoe.moe_ffn_einsum(*_args(w, "torch"), **kw)
    np.testing.assert_allclose(_np(eout), _np(tout), **TOL)
    np.testing.assert_allclose(_np(eaux), _np(taux), **TOL)
    jout, jaux = jmoe.moe_ffn_einsum(*_args(w, "jax"), **kw)
    np.testing.assert_allclose(_np(eout), np.asarray(jout), **TOL)
    logits = w["x"] @ w["gate_w"]
    cap = tmoe.moe_capacity(24, 4, 2, cf)
    for got, want in zip(
            tmoe.topk_dispatch_combine(torch.from_numpy(logits), cap, 2),
            jmoe.topk_dispatch_combine(jnp.asarray(logits), cap, 2)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_active_params_frac_matches_jax():
    for over in ({}, dict(moe_experts=4), dict(moe_experts=8, moe_top_k=1)):
        cfg = {**TINY, "moe_experts": 0, **over}
        assert tmoe.active_params_frac(tgpt.GPTConfig(**cfg)) == \
            jmoe.active_params_frac(jgpt.GPTConfig(**cfg))


def test_gpt_moe_module_matches_jax():
    """GPTMoE forward, aux loss, router stats and every parameter gradient
    (of ``sum(out * r) + aux``) against the JAX module and ``jax.grad`` of
    the ``moe_ffn`` it runs."""
    cfg = dict(TINY, moe_capacity_factor=1.25)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    r = rng.standard_normal((2, 7, 32)).astype(np.float32)
    named = random_state(tgpt.GPTConfig(**cfg), 6)
    pre = "gpt.layers.0.mlp."
    names = ("gate_weight", "w1", "b1", "w2", "b2")
    vals = {n: named[pre + n] for n in names}
    vals["b1"] = rng.standard_normal(vals["b1"].shape).astype(np.float32)
    jlayer = jmoe.GPTMoE(jgpt.GPTConfig(**cfg))
    for n in names:
        getattr(jlayer, n).set_value(vals[n])
    jout = jlayer(paddle.to_tensor(x))
    tlayer = tmoe.GPTMoE(tgpt.GPTConfig(**cfg))
    with torch.no_grad():
        for n in names:
            getattr(tlayer, n).copy_(torch.from_numpy(vals[n]))
    tout = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tout), np.asarray(jout._data), **TOL)
    np.testing.assert_allclose(_np(tlayer.aux_loss),
                               np.asarray(jlayer.aux_loss._data), **TOL)
    for key in ("load", "drop_rate"):
        np.testing.assert_allclose(_np(tlayer.router_stats[key]), np.asarray(
            jlayer.router_stats[key]._data), **TOL)

    def loss(params):
        out, aux = jmoe.moe_ffn(jnp.asarray(x).reshape(-1, 32), *params,
                                top_k=2, capacity_factor=1.25,
                                use_kernel=False)
        return (out.reshape(x.shape) * r).sum() + aux

    jgrads = jax.grad(loss)([jnp.asarray(vals[n]) for n in names])
    ((tout * torch.from_numpy(r)).sum() + tlayer.aux_loss).backward()
    for n, jg in zip(names, jgrads):
        got, want = _np(getattr(tlayer, n).grad), np.asarray(jg)
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max(), n


def _pair(seed=3, **over):
    cfg = dict(TINY, **over)
    named = random_state(tgpt.GPTConfig(**cfg), seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg))
    jm.eval()
    for name, t in _named_state(jm).items():
        t.set_value(named[name])
    tm = state_from_jax_numpy(named, tgpt.GPTConfig(**cfg), device="cpu")
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_gpt_logits_match_jax(cf):
    jm, tm = _pair(moe_capacity_factor=cf)
    ids = np.random.default_rng(7).integers(0, 97, (2, 13))
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = _np(tm(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_moe_gpt_init_draws_every_expert_matrix():
    """The constructor's own init reaches the router and the expert stacks
    (their names do not end in ``.weight``), biases stay zero."""
    cfg = tgpt.GPTConfig(**dict(TINY, initializer_range=0.02))
    m = tgpt.GPTForCausalLM(cfg, device="cpu", seed=1)
    for layer in m.gpt.layers:
        for name in ("gate_weight", "w1", "w2"):
            p = getattr(layer.mlp, name)
            assert abs(float(p.detach().std()) - 0.02) < 0.004, name
        assert not layer.mlp.b1.any() and not layer.mlp.b2.any()
    assert sum(p.numel() for p in m.parameters()) == cfg.num_params()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_bits_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_bits_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, path
    assert str(got.dtype) == f"torch.{want.dtype.name}", path
    np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


@pytest.mark.parametrize("weight_dtype,group_size", [(None, -1),
                                                     ("int8", -1),
                                                     ("int4", 8)])
def test_moe_serving_params_bit_equal(weight_dtype, group_size):
    """The MoE serving params (the expert stacks ``[L, E, ...]`` in place
    of the dense MLP rows), quantized per expert, equal the reference's
    bit for bit; ``serving_params_from_jax_numpy`` carries them across
    unchanged; ``serving_weight_bytes`` counts them."""
    jm, tm = _pair()
    jp, tp = jgpt.serving_params(jm), tgpt.serving_params(tm)
    if weight_dtype:
        jp = jquantize.quantize_serving_params(jp, weight_dtype, group_size)
        tp = tquantize.quantize_serving_params(tp, weight_dtype, group_size)
        e, k, n = 4, 32, 128
        q, s = tp["layers"]["moe_w1"]["q"], tp["layers"]["moe_w1"]["s"]
        assert q.shape == (2, e, k // (2 if weight_dtype == "int4" else 1), n)
        assert s.shape == (2, e, 1 if group_size < 0 else k // group_size, n)
    assert not ({"w1", "b1", "w2", "b2"} & set(tp["layers"]))
    _assert_bits_equal(tp, _numpy_tree(jp))
    carried = serving_params_from_jax_numpy(_numpy_tree(jp), device="cpu")
    _assert_bits_equal(carried, _numpy_tree(jp))
    assert tquantize.serving_weight_bytes(tp) == sum(
        a.nbytes for a in jax.tree_util.tree_leaves(_numpy_tree(jp)))


def _step_args(lanes, b, t):
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


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_unified_step_matches_jax(cf):
    """Two steps of the MoE unified step (prefill chunks, then a decode
    lane and a continuing chunk, with padding rows in the budget) on the
    reference's own serving params, against its ``use_kernel=False``
    step."""
    jm, _ = _pair(seed=5, moe_capacity_factor=cf)
    cfg = tgpt.GPTConfig(**dict(TINY, moe_capacity_factor=cf))
    ps, chunk, b, t, num_pages = 4, 4, 3, 10, 6
    jparams = jgpt.serving_params(jm)
    tparams = serving_params_from_jax_numpy(_numpy_tree(jparams),
                                            device="cpu")
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads, cfg.head_dim)
    jpools = [jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)]
    ext = (shape[0], num_pages + 1) + shape[2:]
    tpools = [torch.zeros(ext), torch.zeros(ext)]
    jstep = jgpt.build_unified_step(jgpt.GPTConfig(**dict(
        TINY, moe_capacity_factor=cf)), ps, chunk, use_kernel=False)
    tstep = tgpt.build_unified_step(cfg, ps, chunk)
    zb, zt = np.zeros(b, np.int32), np.zeros(t, np.int32)
    nocow = np.full(b, num_pages, np.int32)
    rounds = [
        (np.array([[1, 3], [0, 2], [-1, -1]], np.int32),
         {0: (0, [5, 6, 7, 8]), 1: (0, [9, 10, 11])}),
        (np.array([[1, 3], [0, 2], [4, -1]], np.int32),
         {0: (4, [12]), 1: (3, [13, 14]), 2: (0, [15, 16, 17])}),
    ]
    for pt, lanes in rounds:
        ids, slot, pos, ql, kl, last, emit = _step_args(lanes, b, t)
        jout, jlog, *jpools = jstep(
            jparams, *(jnp.asarray(a) for a in
                       (ids, slot, pos, ql, kl, last, zt, zb, emit, zb)),
            *jpools, jnp.asarray(pt), jnp.asarray(nocow), jnp.asarray(nocow),
            jnp.zeros((b, 2), jnp.uint32), jnp.zeros(b, jnp.float32),
            jnp.zeros(b, jnp.int32), jnp.ones(b, jnp.float32))
        tout, tlog, *tpools = tstep(
            tparams, *(torch.from_numpy(a) for a in
                       (ids, slot, pos, ql, kl, last, zt, zb, emit, zb)),
            *tpools, torch.from_numpy(pt), torch.from_numpy(nocow),
            torch.from_numpy(nocow),
            torch.zeros(b, dtype=torch.int64), torch.zeros(b),
            torch.zeros(b, dtype=torch.int32), torch.ones(b))
        rows = sorted(lanes)
        np.testing.assert_allclose(_np(tlog)[rows], np.asarray(jlog)[rows],
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(_np(tout)[rows],
                                      np.asarray(jout)[rows])
        for tpool, jpool in zip(tpools, jpools):
            np.testing.assert_allclose(_np(tpool[:, :num_pages]),
                                       np.asarray(jpool), **TOL)


def _churn():
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    return [p0,
            [int(x) for x in rng.randint(0, 97, 9)],
            [int(x) for x in rng.randint(0, 97, 17)],
            list(p0),                                  # duplicate: CoW
            p0[:20] + [int(x) for x in rng.randint(0, 97, 6)],  # shared
            [int(x) for x in rng.randint(0, 97, 3)]]


@pytest.mark.parametrize("cf", [0.5, 4.0])
@pytest.mark.parametrize("quant", [{}, dict(weight_dtype="int8"),
                                   dict(weight_dtype="int4",
                                        weight_quant_group_size=8)])
def test_predictor_matches_jax_sync_engine(cf, quant):
    """Churn (preemption, copy-on-write, prefix hits) through the MoE
    predictor, fp and int8 / int4-g8 expert stacks, with drops (cf 0.5)
    and without (cf 4.0): token-identical to the reference's sync
    engine."""
    jm, tm = _pair(moe_capacity_factor=cf, **quant)
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False, **kw)
    tsp = ServingPredictor(tm, device="cpu", **kw)
    want = jsp.generate(_churn(), max_new_tokens=12)
    got = tsp.generate(_churn(), max_new_tokens=12)
    assert all(want) and len({t for s in want for t in s}) > 3
    assert got == want
    assert tsp.decode_trace_count == 1
    if quant:
        assert isinstance(tsp.params["layers"]["moe_w1"], dict)
    jt, tt = jsp.telemetry(), tsp.telemetry()
    for key in ("serving_preemptions", "kv_cow_copies", "serving_steps"):
        assert tt[key] == jt[key], key


def test_moe_rejected_where_the_reference_rejects_it():
    """mega stays dense-only and the legacy two-program path has no MoE
    FFN: both refuse a MoE config with a ``ValueError`` naming it."""
    _, tm = _pair()
    with pytest.raises(ValueError, match="dense-only"):
        ServingPredictor(tm, max_batch=2, mega_decode=True, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        ServingPredictor(tm, max_batch=2, unified=False, device="cpu")
