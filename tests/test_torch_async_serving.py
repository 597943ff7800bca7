"""The port's async dispatch-ahead engine on the CPU: against the JAX
package's async engine (``ServingPredictor(use_kernel=False,
async_engine=True)``) and against the port's own synchronous engine.

The sizes are the tiny config of ``tests/test_torch_serving.py``
(``initializer_range 0.5``, so streams are not constant); every stream
check is token for token, and every count check exact.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.inference.serving import FINISHED
from paddle_tpu_torch.inference.staging import DeviceBuffer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy

from test_torch_serving import TINY, _churn, _pair

V = TINY["vocab_size"]
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
SAMPLED = dict(temperature=0.8, top_k=12, top_p=0.9, seed=3)


def _model(seed=3, **over):
    cfg = tgpt.GPTConfig(**TINY, **over)
    return state_from_jax_numpy(random_state(cfg, seed), cfg,
                                device="cpu").eval()


def _prompts(n, max_len=20, seed=5):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, V, int(rng.randint(1, max_len)))]
            for _ in range(n)]


def _drive(sp, prompts, gen_len, **sampling):
    """Continuous arrival: keep the lanes full from ``prompts`` in order,
    step until everything finished, then flush. Returns the streams in
    arrival order."""
    queued, reqs = list(prompts), []
    steps = 0
    while queued or sp.has_work():
        while queued and sum(r.state != FINISHED
                             for r in reqs) < sp.max_batch:
            reqs.append(sp.add_request(queued.pop(0), gen_len, **sampling))
        sp.step()
        steps += 1
        assert steps < 5000, "churn stuck"
    sp.flush()
    return [list(r.output_ids) for r in reqs]


def _sync_async(model, prompts, gen_len, kw, **sampling):
    """(sync streams, async streams, the async predictor)."""
    want = _drive(ServingPredictor(model, device="cpu", async_engine=False,
                                   **kw), prompts, gen_len, **sampling)
    sp = ServingPredictor(model, device="cpu", async_engine=True, **kw)
    return want, _drive(sp, prompts, gen_len, **sampling), sp


def _forward_greedy(model, prompt, out):
    """Whether ``out`` is the full forward's greedy continuation of
    ``prompt`` (teacher-forced)."""
    with torch.no_grad():
        logits = model(torch.tensor([prompt + out[:-1]]))[0, len(prompt) - 1:]
    return logits.argmax(-1).tolist() == out


def test_async_engine_matches_jax_async_engine():
    """Churn with preemption, copy-on-write and prefix hits: the JAX async
    engine's greedy streams and its step, token, hard-sync, steady-hit,
    preemption, CoW and prefix-hit counts."""
    jm, tm = _pair()
    kw = dict(max_batch=3, page_size=8, chunk=8, num_pages=10)
    jsp = JaxPredictor(jm, use_kernel=False, async_engine=True, **kw)
    tsp = ServingPredictor(tm, device="cpu", async_engine=True, **kw)
    want = jsp.generate(_churn(), max_new_tokens=12)
    assert all(want) and len({t for s in want for t in s}) > 3
    got = tsp.generate(_churn(), max_new_tokens=12)
    assert got == want
    jt, tt = jsp.telemetry(), tsp.telemetry()
    for key in ("serving_steps", "serving_tokens_emitted",
                "serving_hard_syncs", "serving_steady_hits",
                "serving_preemptions", "kv_cow_copies",
                "kv_prefix_hit_tokens"):
        assert tt[key] == jt[key], key
    assert tt["serving_preemptions"] > 0 and tt["kv_cow_copies"] > 0
    assert tt["serving_steady_hits"] > 0
    assert 0 < tt["serving_hard_syncs"] < tt["serving_steps"]
    assert tsp.decode_trace_count == 1
    assert tsp.cache.available_page_count == tsp.cache.num_pages


@pytest.mark.parametrize("kind", ["greedy", "sampled", "eos"])
def test_async_matches_sync_over_a_churn(kind):
    """Continuous arrival over 24 prompts: the async streams are the sync
    engine's, greedy, seeded-sampled and with eos set (eos found one step
    behind the dispatch, the overhang dropped)."""
    model = _model()
    prompts = _prompts(24)
    kw = dict(max_batch=3, max_seq_len=48, page_size=8, chunk=8)
    sampling = {"greedy": {}, "sampled": SAMPLED, "eos": {}}[kind]
    if kind == "eos":
        greedy = _drive(ServingPredictor(model, device="cpu",
                                         async_engine=False, **kw),
                        prompts, 5)
        sampling = dict(eos_token_id=int(np.bincount(
            [t for s in greedy for t in s]).argmax()))
    want, got, sp = _sync_async(model, prompts, 5, kw, **sampling)
    assert got == want
    assert sp.decode_trace_count == 1
    if kind == "eos":
        assert any(len(s) < 5 for s in want)
    else:
        assert all(len(s) == 5 for s in want)


def test_no_completion_fast_path_defers_every_sync():
    """Steps that cannot finish a request (no eos, budget out of reach)
    never sync: 12 steps land nothing, the steady pack serves most of
    them, one flush lands them all; an eos-set request syncs
    behind-by-one instead."""
    model = _model()
    prompt = _prompts(1, seed=9)[0][:6] + [1, 2, 3]
    kw = dict(max_batch=1, max_seq_len=64, page_size=8, chunk=8)
    sp = ServingPredictor(model, device="cpu", max_inflight_steps=64, **kw)
    req = sp.add_request(prompt, max_new_tokens=30)
    for _ in range(12):
        sp.step()
    assert sp.hard_syncs == 0 and req.output_ids == []
    assert req._pending_n > 0 and sp.steady_hits >= 8
    sp.flush()
    assert sp.hard_syncs == 1 and req._pending_n == 0
    got_prefix = list(req.output_ids)
    while sp.has_work():
        sp.step()
    sp.flush()
    want = ServingPredictor(model, device="cpu", async_engine=False,
                            **kw).generate([prompt], max_new_tokens=30)[0]
    assert req.output_ids == want and want[:len(got_prefix)] == got_prefix
    assert sp.decode_trace_count == 1
    sp2 = ServingPredictor(model, device="cpu", max_inflight_steps=64, **kw)
    sp2.add_request(prompt, max_new_tokens=8, eos_token_id=want[0])
    sp2.step()
    syncs = sp2.hard_syncs
    for _ in range(3):
        sp2.step()
    assert sp2.hard_syncs > syncs


def test_preemption_replay_flushes_pending():
    """Page pressure preempts a request with tokens in flight; its replay
    waits for them (the value barrier), and every stream is still the
    full forward's greedy continuation."""
    model = _model()
    prompts = _prompts(3, max_len=7, seed=4)
    sp = ServingPredictor(model, device="cpu", max_batch=3, max_seq_len=24,
                          page_size=8, num_pages=5)
    reqs = [sp.add_request(p, max_new_tokens=10) for p in prompts]
    while sp.has_work():
        sp.step()
    sp.flush()
    assert sum(r.preempt_count for r in reqs) >= 1
    for p, r in zip(prompts, reqs):
        assert len(r.output_ids) == 10 and _forward_greedy(model, p,
                                                           r.output_ids)
    assert sp.decode_trace_count == 1


def test_tokens_come_back_one_step_behind_and_flush_drains():
    """``step()`` returns the tokens it landed, behind the dispatch; the
    union of every ``step()`` and the final ``flush()`` is each stream."""
    model = _model()
    sp = ServingPredictor(model, device="cpu", max_batch=2, max_seq_len=48,
                          page_size=8, chunk=8)
    collected, queued, reqs, behind = {}, _prompts(6, max_len=10), [], 0
    while queued or sp.has_work():
        while queued and sum(r.state != FINISHED
                             for r in reqs) < sp.max_batch:
            reqs.append(sp.add_request(queued.pop(0), 4))
        for rid, toks in sp.step().items():
            collected.setdefault(rid, []).extend(toks)
        behind += any(r._pending_n for r in reqs)
    for rid, toks in sp.flush().items():
        collected.setdefault(rid, []).extend(toks)
    assert behind > 0
    for r in reqs:
        assert len(r.output_ids) == 4
        assert collected.get(r.req_id, []) == r.output_ids


def test_async_is_the_default_and_legacy_refuses_it():
    model = _model()
    assert ServingPredictor(model, device="cpu").async_engine is True
    assert ServingPredictor(model, device="cpu",
                            async_engine=False).async_engine is False
    assert ServingPredictor(model, device="cpu",
                            unified=False).async_engine is False
    with pytest.raises(ValueError, match="async"):
        ServingPredictor(model, device="cpu", unified=False,
                         async_engine=True)
    prompts = _prompts(2, max_len=6)
    kw = dict(max_batch=2, max_seq_len=32, page_size=8)
    want = ServingPredictor(model, device="cpu", async_engine=False,
                            **kw).generate(prompts, max_new_tokens=6)
    assert ServingPredictor(model, device="cpu", **kw).generate(
        prompts, max_new_tokens=6) == want


@pytest.mark.parametrize("form", ["int8_int8kv", "mega", "moe"])
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_unified_forms_async_matches_sync(form, sampling):
    """int8 weights with an int8 KV cache, the mega step and MoE (4
    experts, top-2, drops at cf 1.25): async streams equal the sync
    engine's, greedy and seeded-sampled, over one churn."""
    over = {"int8_int8kv": dict(weight_dtype="int8", kv_cache_dtype="int8"),
            "mega": dict(mega_decode=True), "moe": MOE}[form]
    model = _model(**over)
    kw = dict(max_batch=3, max_seq_len=64, page_size=8, chunk=8)
    want, got, sp = _sync_async(model, _prompts(8, max_len=14), 6, kw,
                                **({} if sampling == "greedy" else SAMPLED))
    assert got == want and all(len(s) == 6 for s in want)
    assert sp.decode_trace_count == 1


def test_step_counts_geometries_on_the_cpu():
    """On the CPU ``trace_count`` counts the geometries that ran: none
    before the first call, one however many rounds, two once another token
    budget runs."""
    model = _model()
    kw = dict(max_batch=2, max_seq_len=32, page_size=8, device="cpu")
    sp = ServingPredictor(model, chunk=8, **kw)
    assert sp.decode_trace_count == 0
    sp.generate(_prompts(3, max_len=12), max_new_tokens=4)
    assert sp.decode_trace_count == 1
    other = ServingPredictor(model, chunk=4, **kw)
    other._unified = sp._unified
    other.generate(_prompts(2, max_len=12), max_new_tokens=2)
    assert sp.decode_trace_count == 2


def test_greedy_rows_of_the_sampling_epilogue_stay_in_range():
    """The epilogue runs for every lane: greedy rows (temperature 0) and
    extreme logits give finite work and in-range ids, and greedy picks the
    argmax."""
    logits = torch.tensor([[3e38, -3e38, 0.0, 1.0], [0.5, 2.0, -1.0, 2.0],
                           [-1e30, -1e30, -1e30, -1e30]])
    temp = torch.tensor([0.0, 0.0, 1e-9])
    u = torch.tensor([0.999, 0.0, 0.5], dtype=torch.float64)
    ids = tgpt._sample_epilogue(logits, u, temp, torch.zeros(3, dtype=torch.int32),
                                torch.ones(3))
    assert ((ids >= 0) & (ids < 4)).all()
    pick = torch.where(temp > 0, ids, logits.argmax(-1))
    assert pick[:2].tolist() == [0, 1]


def test_launch_counters_round_trip():
    """``ops.counters`` reads every wrapper's counters flat;
    ``set_counters`` sets them back and adds a difference, as a replay
    of a captured step does."""
    before = ops.counters()
    assert any(k[1] == "twin_routes" for k in before)
    key = ("ragged_paged_attention", "launches", None)
    qkey = next(k for k in before if k[0] == "quant_matmul_fwd"
                and k[1] == "launches")
    try:
        ops.set_counters({key: 12, qkey: 4}, add=True)
        now = ops.counters()
        assert now[key] == before[key] + 12 and now[qkey] == before[qkey] + 4
    finally:
        ops.set_counters(before)
    assert ops.counters() == before


def test_device_buffer_on_the_cpu_copies_at_once():
    buf = DeviceBuffer((4,), torch.int32, "cpu")
    t = buf.put(np.arange(4, dtype=np.int32))
    assert t is buf.tensor and t.tolist() == [0, 1, 2, 3]
    assert buf.put(np.full(4, 7, np.int32)) is t and t.tolist() == [7] * 4
