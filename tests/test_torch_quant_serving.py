"""Port quantized serving (weight-only int8 / int4 stacks, int8 KV pools)
against the JAX package on the CPU: the serving conversion bit for bit,
the unified step with ``kv_quant=True`` against ``build_unified_step(
kv_quant=True, use_kernel=False)``, and ``ServingPredictor`` churn streams
against ``ServingPredictor(use_kernel=False, async_engine=False)``.

Weights use ``initializer_range 0.5`` (see ``test_torch_serving.py``).
Logits are held at ``atol/rtol 1e-5`` (fp32, other summation orders); the
step's int8 KV pages may differ by one quantization step where the two
libraries' fp32 K/V differ in the last bit at a rounding boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import quantize as jquantize
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization import QuantConfig
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference import quantize as tquantize
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (random_state,
                                             serving_params_from_jax_numpy,
                                             state_from_jax_numpy)

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.5)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(seed=3, **quant):
    named = random_state(tgpt.GPTConfig(**TINY), seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**TINY, **quant))
    jm.eval()
    for name, t in _named_state(jm).items():
        t.set_value(named[name])
    tm = state_from_jax_numpy(named, tgpt.GPTConfig(**TINY, **quant),
                              device="cpu")
    tm.eval()
    return jm, tm


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_bits_equal(got, want, path="params"):
    """Every leaf of the port's params equals the reference's bit for bit
    (same keys, dtypes and shapes)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_bits_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, path
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=path)
    else:
        assert str(got.dtype) == f"torch.{want.dtype.name}", path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


@pytest.mark.parametrize("weight_dtype,group_size", [("int8", -1),
                                                     ("int8", 8),
                                                     ("int4", -1),
                                                     ("int4", 8)])
def test_quantize_serving_params_bit_equal(weight_dtype, group_size):
    jm, tm = _pair()
    jp = jquantize.quantize_serving_params(jgpt.serving_params(jm),
                                           weight_dtype, group_size)
    tp = tquantize.quantize_serving_params(tgpt.serving_params(tm),
                                           weight_dtype, group_size)
    _assert_bits_equal(tp, _numpy_tree(jp))
    assert tquantize.is_quantized_params(tp)
    assert not tquantize.is_quantized_params(tgpt.serving_params(tm))
    # the reference's pytree carries over bit for bit
    _assert_bits_equal(serving_params_from_jax_numpy(_numpy_tree(jp),
                                                     device="cpu"),
                       _numpy_tree(jp))
    for params in (jgpt.serving_params(jm), jp):
        port = serving_params_from_jax_numpy(_numpy_tree(params),
                                             device="cpu")
        assert (tquantize.serving_weight_bytes(port)
                == jquantize.serving_weight_bytes(params))


@pytest.mark.parametrize("weight_dtype,group_size", [("int8", -1),
                                                     ("int4", 8)])
def test_bf16_predictor_casts_then_quantizes_like_jax(weight_dtype,
                                                      group_size):
    """A bf16 predictor quantizes after the cast: bf16-rounded scales, and
    ``q`` rounded against the unrounded ones."""
    quant = dict(weight_dtype=weight_dtype,
                 weight_quant_group_size=group_size)
    jm, tm = _pair(**quant)
    jsp = JaxPredictor(jm, max_batch=2, page_size=8, dtype=jnp.bfloat16,
                       use_kernel=False, async_engine=False)
    tsp = ServingPredictor(tm, max_batch=2, page_size=8,
                           dtype=torch.bfloat16, device="cpu")
    _assert_bits_equal(tsp.params, _numpy_tree(jsp.params))
    assert tsp.params["layers"]["wo"]["s"].dtype == torch.float32


def test_quant_config_restricts_stacks():
    _, tm = _pair()
    cfg = QuantConfig()
    cfg.add_name_config(["wqkv", "w1"])
    tp = tquantize.quantize_serving_params(tgpt.serving_params(tm), "int8",
                                           config=cfg)
    assert sorted(k for k in tquantize.QUANT_LAYER_KEYS
                  if isinstance(tp["layers"][k], dict)) == ["w1", "wqkv"]
    bad = QuantConfig()
    bad.add_name_config("qkv_proj")
    with pytest.raises(ValueError, match="match no serving"):
        tquantize.quantize_serving_params(tgpt.serving_params(tm), "int8",
                                          config=bad)
    with pytest.raises(ValueError, match="weight_dtype"):
        tquantize.quantize_serving_params(tgpt.serving_params(tm), "fp8")
    # MoE expert stacks [L, E, K, N] quantize per expert, in the
    # reference's layout
    params = tgpt.serving_params(tm)
    params["layers"]["moe_w1"] = params["layers"]["w1"][:, None].repeat(
        1, 3, 1, 1)
    for wd, gs in (("int8", -1), ("int4", 8)):
        qp = tquantize.quantize_serving_params(params, wd, gs)["layers"]
        jq = jquantize._quantize_stack(
            jnp.asarray(params["layers"]["moe_w1"].numpy()), wd, gs)
        for part in ("q", "s"):
            np.testing.assert_array_equal(qp["moe_w1"][part].numpy(),
                                          np.asarray(jq[part]))
    only = QuantConfig()
    only.add_name_config(["moe_w1"])
    qp = tquantize.quantize_serving_params(params, "int8", config=only)
    assert [k for k, v in qp["layers"].items() if isinstance(v, dict)] == [
        "moe_w1"]


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


@pytest.mark.parametrize("weight_dtype,group_size", [(None, -1),
                                                     ("int8", -1),
                                                     ("int4", 8)])
def test_unified_step_kv_quant_matches_jax(weight_dtype, group_size):
    """Two steps with int8 pools: two prefill chunks, then a decode lane, a
    continuing chunk and a copy-on-write lane reading the copied page (its
    scales ride the same copy). The port runs on the reference's own
    (quantized) serving params."""
    jm, _ = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    ps, chunk, b, t, num_pages = 4, 4, 3, 8, 6
    jparams = jgpt.serving_params(jm)
    if weight_dtype:
        jparams = jquantize.quantize_serving_params(jparams, weight_dtype,
                                                    group_size)
    tparams = serving_params_from_jax_numpy(_numpy_tree(jparams),
                                            device="cpu")
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads, cfg.head_dim)
    jpools = [jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
              jnp.zeros(shape[:4], jnp.float32),
              jnp.zeros(shape[:4], jnp.float32)]
    ext = (shape[0], num_pages + 1) + shape[2:]
    tpools = [torch.zeros(ext, dtype=torch.int8),
              torch.zeros(ext, dtype=torch.int8), torch.zeros(ext[:4]),
              torch.zeros(ext[:4])]
    jstep = jgpt.build_unified_step(jgpt.GPTConfig(**TINY), ps, chunk,
                                    use_kernel=False, kv_quant=True)
    tstep = tgpt.build_unified_step(cfg, ps, chunk, kv_quant=True)
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
            if want.dtype == np.int8:
                diff = np.abs(got.astype(np.int32) - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            else:
                np.testing.assert_allclose(got, want, **TOL)
    assert tpools[0][:, 4].abs().sum() > 0           # the CoW page landed
    np.testing.assert_allclose(tpools[2][:, 4].numpy(),
                               np.asarray(jpools[2])[:, 4], **TOL)


def _churn():
    rng = np.random.RandomState(11)
    p0 = [int(x) for x in rng.randint(0, 97, 30)]
    return [p0,
            [int(x) for x in rng.randint(0, 97, 9)],
            [int(x) for x in rng.randint(0, 97, 17)],
            list(p0),                                  # duplicate: CoW
            p0[:20] + [int(x) for x in rng.randint(0, 97, 6)],  # shared
            [int(x) for x in rng.randint(0, 97, 3)]]


@pytest.mark.parametrize("quant", [
    dict(weight_dtype="int8", kv_cache_dtype="int8"),
    dict(weight_dtype="int4", weight_quant_group_size=8),
])
def test_quantized_predictor_matches_jax_sync_engine(quant):
    jm, tm = _pair(**quant)
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False, **kw)
    tsp = ServingPredictor(tm, device="cpu", **kw)
    want = jsp.generate(_churn(), max_new_tokens=12)
    got = tsp.generate(_churn(), max_new_tokens=12)
    assert all(want) and len({t for s in want for t in s}) > 3
    assert got == want
    jt, tt = jsp.telemetry(), tsp.telemetry()
    for key in ("serving_preemptions", "kv_cow_copies",
                "kv_prefix_hit_tokens", "serving_steps",
                "serving_tokens_emitted"):
        assert tt[key] == jt[key], key
    assert tt["serving_preemptions"] > 0 and tt["kv_cow_copies"] > 0
    int8_kv = quant.get("kv_cache_dtype") == "int8"
    assert tsp.cache.quantize_kv == int8_kv
    assert (tsp.cache.k_pool.dtype == torch.int8) == int8_kv
    assert len(tsp.cache.pools()) == (4 if int8_kv else 2)
    assert tsp.cache.available_page_count == tsp.cache.num_pages


def test_predictor_kv_cache_dtype_argument():
    """``kv_cache_dtype=`` overrides an unquantized config, as in the
    reference; an unsupported value raises."""
    _, tm = _pair()
    sp = ServingPredictor(tm, max_batch=2, page_size=8, kv_cache_dtype="int8",
                          device="cpu")
    assert sp.cache.k_pool.dtype == torch.int8
    assert sp.cache.k_scales.shape == (2, sp.cache.num_pages + 1, 8, 4)
    out = sp.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9]], max_new_tokens=3)
    assert len(out[0]) == 3
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingPredictor(tm, kv_cache_dtype="int4", device="cpu")
