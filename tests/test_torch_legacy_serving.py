"""Port legacy two-program serving (``build_prefill`` + ``build_decode_step``,
``ServingPredictor(unified=False)``) against the JAX package's
``build_prefill`` / ``build_decode_step(use_kernel=False)`` and its
``ServingPredictor(unified=False, use_kernel=False, async_engine=False)``.

Weights use ``initializer_range 0.5`` (see ``test_torch_serving.py``).
Logits are held at ``atol/rtol 1e-5`` (fp32, other summation orders);
pool pages at ``atol 2e-5, rtol 1e-5``: the second layer's K / V reach
magnitudes ~5 at this init, and one fp32 roundoff of the first layer's
other summation order moves an entry by up to ~1.2e-5 (2.5e-6 of the
pages' max). Greedy tokens and scheduler counts are held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.jit.api import _named_state
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference.serving import FAILED, FINISHED
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy
from paddle_tpu_torch.ops.paged_attention import paged_attention

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=96, initializer_range=0.5)
TOL = dict(atol=1e-5, rtol=1e-5)
PAGE_TOL = dict(atol=2e-5, rtol=1e-5)


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


def _draw(rng, n):
    return [int(x) for x in rng.randint(0, TINY["vocab_size"], n)]


# -- the two programs --------------------------------------------------------


def test_prefill_then_decode_steps_match_jax():
    """One prefill of two right-padded prompts into their pages, then three
    chained decode steps over three slots, the last slot empty."""
    jm, tm = _pair(seed=5)
    cfg = tgpt.GPTConfig(**TINY)
    ps, num_pages, pps = 4, 9, 4
    shape = (cfg.num_layers, num_pages, ps, cfg.num_heads, cfg.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk = torch.zeros((shape[0], num_pages + 1) + shape[2:])
    tv = torch.zeros_like(tk)
    jparams, tparams = jgpt.serving_params(jm), tgpt.serving_params(tm)
    jcfg = jgpt.GPTConfig(**TINY)
    rng = np.random.RandomState(2)
    lengths = np.array([11, 5], np.int32)
    ids = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = _draw(rng, n)
    pages = np.array([[3, 0, 7, -1], [5, 2, -1, -1]], np.int32)
    jout, jlog, jk, jv = jgpt.build_prefill(jcfg, ps)(
        jparams, jnp.asarray(ids), jnp.asarray(lengths), jk, jv,
        jnp.asarray(pages))
    prefill = tgpt.build_prefill(cfg, ps)
    tout, tlog, tk, tv = prefill(
        tparams, torch.from_numpy(ids), torch.from_numpy(lengths), tk, tv,
        torch.from_numpy(pages))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t[:, :num_pages].numpy(), np.asarray(j),
                                   **PAGE_TOL)
    assert not tk[:, [1, 4, 6, 8]].any()        # no slot owns these pages
    assert prefill.trace_count == 1
    # three decode steps: slots 0 and 1 continue their prompts, slot 2 is
    # empty; each step writes the incoming token at its length
    page_table = np.array([[3, 0, 7, 6], [5, 2, 4, -1], [-1] * 4], np.int32)
    lens = np.array([11, 5, 0], np.int32)
    toks = np.array([ids[0, 10], ids[1, 4], 0], np.int32)
    jstep = jgpt.build_decode_step(jcfg, ps, use_kernel=False)
    tstep = tgpt.build_decode_step(cfg, ps)
    for _ in range(3):
        jnext, jlog, jk, jv = jstep(jparams, jnp.asarray(toks),
                                    jnp.asarray(lens), jk, jv,
                                    jnp.asarray(page_table))
        tnext, tlog, tk, tv = tstep(tparams, torch.from_numpy(toks),
                                    torch.from_numpy(lens), tk, tv,
                                    torch.from_numpy(page_table))
        np.testing.assert_array_equal(tnext.numpy()[:2],
                                      np.asarray(jnext)[:2])
        np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2],
                                   **TOL)
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(t[:, :num_pages].numpy(),
                                       np.asarray(j), **PAGE_TOL)
        toks = np.where(lens > 0, tnext.numpy(), 0).astype(np.int32)
        lens = np.where(lens > 0, lens + 1, 0).astype(np.int32)
    assert tstep.trace_count == 1
    assert not tk[:, [1, 8]].any()              # the empty slot wrote nothing


# -- the predictor -----------------------------------------------------------


def _churn():
    """1-token prompts, a duplicate (no prefix cache on this path) and a
    spread of lengths."""
    rng = np.random.RandomState(11)
    p0 = _draw(rng, 30)
    return [p0, [7], _draw(rng, 9), _draw(rng, 17), list(p0), [42],
            _draw(rng, 3)]


# (predictor kwargs, prompts, max_new_tokens): preemption and 1-token
# contexts under a small pool; truncation at max_seq_len; and a pool so
# small that one prompt can never fit and one sequence cannot grow
CHURNS = {
    "preempt": (dict(max_batch=3, page_size=8, num_pages=10), _churn, 12),
    "truncate": (dict(max_batch=2, page_size=8, max_seq_len=24),
                 lambda: [_draw(np.random.RandomState(3), 20), [5],
                          _draw(np.random.RandomState(4), 6)], 12),
    "tiny_pool": (dict(max_batch=2, page_size=8, num_pages=3,
                       max_seq_len=40),
                  lambda: [_draw(np.random.RandomState(5), 30), [9],
                           _draw(np.random.RandomState(6), 20)], 8),
}


@pytest.mark.parametrize("case", sorted(CHURNS))
def test_legacy_predictor_matches_jax_sync_engine(case):
    kw, prompts, max_new = CHURNS[case]
    jm, tm = _pair()
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False,
                       unified=False, retry_backoff_s=0.0, **kw)
    tsp = ServingPredictor(tm, device="cpu", unified=False, **kw)
    jreqs = [jsp.add_request(p, max_new) for p in prompts()]
    treqs = [tsp.add_request(p, max_new) for p in prompts()]
    for sp, reqs in ((jsp, jreqs), (tsp, treqs)):
        for _ in range(500):
            if all(r.state in (FINISHED, FAILED) for r in reqs):
                break
            sp.step()
    got = [(r.state, list(r.output_ids), r.truncated,
            (r.error or {}).get("code")) for r in treqs]
    want = [(r.state, list(r.output_ids), r.truncated,
             (r.error or {}).get("code")) for r in jreqs]
    assert got == want
    assert sum(map(len, (g[1] for g in got))) > 0
    jt, tt = jsp.telemetry(), tsp.telemetry()
    for key in ("serving_preemptions", "serving_steps",
                "serving_tokens_emitted", "serving_requests_admitted",
                "serving_requests_failed"):
        assert tt[key] == jt[key], key
    assert tsp.cache.available_page_count == tsp.cache.num_pages
    assert tsp.decode_trace_count == 1 and tsp.prefill_trace_count >= 1
    seen = {"preempt": tt["serving_preemptions"] > 0,
            "truncate": any(g[2] for g in got),
            "tiny_pool": {"never_admittable", "pool_exhausted"}
            <= {g[3] for g in got}}
    assert seen[case], (case, got, tt)


def test_legacy_matches_unified_token_for_token():
    """The reference's own equivalence gate, on the port: the unified
    step reproduces the legacy path's greedy streams."""
    _, tm = _pair()
    rng = np.random.RandomState(0)
    prompts = [_draw(rng, n) for n in (3, 19, 7, 1, 12)]
    kw = dict(max_batch=3, max_seq_len=48, page_size=8, device="cpu")
    legacy = ServingPredictor(tm, unified=False, **kw)
    unified = ServingPredictor(tm, chunk=8, **kw)
    want = legacy.generate(prompts, max_new_tokens=6)
    assert unified.generate(prompts, max_new_tokens=6) == want
    assert all(len(s) == 6 for s in want)
    assert unified.decode_trace_count == 1
    assert unified.prefill_trace_count == 0
    assert legacy.decode_trace_count == 1
    assert legacy.prefill_trace_count >= 1


@pytest.mark.parametrize("quant", [dict(weight_dtype="int8"),
                                   dict(weight_dtype="int4",
                                        weight_quant_group_size=8)])
def test_quantized_legacy_predictor_matches_jax(quant):
    jm, tm = _pair(**quant)
    kw = dict(max_batch=3, page_size=8, num_pages=10)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=False,
                       unified=False, **kw)
    tsp = ServingPredictor(tm, device="cpu", unified=False, **kw)
    want = jsp.generate(_churn(), max_new_tokens=10)
    got = tsp.generate(_churn(), max_new_tokens=10)
    assert all(want) and len({t for s in want for t in s}) > 3
    assert got == want
    assert isinstance(tsp.params["layers"]["wqkv"], dict)
    unified = ServingPredictor(tm, device="cpu", chunk=8, **kw)
    assert unified.generate(_churn(), max_new_tokens=10) == got


def test_decode_step_runs_paged_attention_once_a_layer(monkeypatch):
    """Each decode step calls the paged decode entry once per layer (on
    the card, one kernel launch each), with the contexts at lengths + 1."""
    _, tm = _pair()
    calls = []
    real = tgpt.paged_attention

    def spy(q, kp, vp, pt, ctx):
        calls.append(ctx.tolist())
        return real(q, kp, vp, pt, ctx)

    monkeypatch.setattr(tgpt, "paged_attention", spy)
    before = paged_attention.launches
    sp = ServingPredictor(tm, device="cpu", unified=False, max_batch=2,
                          page_size=8)
    sp.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    assert len(calls) == sp.steps * TINY["num_layers"] > 0
    assert calls[0] == [3, 2]       # prefixes of 2 and 1 tokens, + 1
    assert paged_attention.launches == before    # CPU: the plain twin


def test_legacy_refusals():
    _, tm = _pair()
    with pytest.raises(ValueError, match="int8 KV cache"):
        ServingPredictor(tm, unified=False, kv_cache_dtype="int8",
                         device="cpu")
    with pytest.raises(ValueError, match="mega_decode rides"):
        ServingPredictor(tm, unified=False, mega_decode=True, device="cpu")
    spec = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY, spec_decode_k=2),
                               device="cpu")
    with pytest.raises(ValueError, match="speculative decoding rides"):
        ServingPredictor(spec, unified=False, device="cpu")
    moe = tgpt.GPTConfig(**TINY, moe_experts=4)
    for build in (tgpt.build_prefill, tgpt.build_decode_step):
        with pytest.raises(ValueError, match="no MoE FFN"):
            build(moe, 8)
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            build(tgpt.GPTConfig(**TINY), 8, mesh=object())


def test_predictor_options():
    """``max_seq_len`` caps at the config's; ``prefix_cache`` defaults to
    ``unified``; ``unified=None`` keeps meaning the unified step."""
    _, tm = _pair()
    legacy = ServingPredictor(tm, unified=False, max_seq_len=500,
                              device="cpu")
    assert legacy.max_seq_len == TINY["max_seq_len"]
    assert not legacy.cache.enable_prefix_cache
    assert ServingPredictor(tm, unified=False, prefix_cache=True,
                            device="cpu").cache.enable_prefix_cache
    default = ServingPredictor(tm, unified=None, max_seq_len=40,
                               device="cpu")
    assert default.unified and default.cache.enable_prefix_cache
    assert default.max_seq_len == 40 and default.prefill_trace_count == 0
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        default.add_request(list(range(41)))
