"""The port's fault injection (``inference/faults.py``) and the serving
engine's crash-consistent recovery, against the JAX package.

``FaultPlan`` fires the reference plan's pattern for the same seed, rates
and hit sequence; under the synchronous engine, the same plan gives the
port and the reference (``use_kernel=False``) the same streams, the same
error codes per request and the same page accounting. The predictor
cases are the reference suite's (``tests/test_faults.py``) on the port.
Tiny config of ``tests/test_torch_serving.py``; every check is exact.
"""
import functools

import numpy as np
import pytest

from paddle_tpu.inference import FaultPlan as JaxPlan
from paddle_tpu.inference import KVCacheManager as JaxManager
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu_torch.inference import (FaultPlan, InjectedFault,
                                        KVCacheManager, ServingPredictor)
from paddle_tpu_torch.inference.faults import SEAMS, active_plan, fault_point
from paddle_tpu_torch.inference.serving import (FAILED, FINISHED, RUNNING,
                                                WAITING)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import random_state, state_from_jax_numpy

from test_torch_serving import TINY, _pair

V = TINY["vocab_size"]
TERMINAL = (FINISHED, FAILED)


@functools.lru_cache(maxsize=None)
def pair():
    """The JAX and port models on the same numpy-seeded weights (built
    once a process)."""
    return _pair()


@functools.lru_cache(maxsize=None)
def port_model():
    cfg = tgpt.GPTConfig(**TINY)
    return state_from_jax_numpy(random_state(cfg, 3), cfg,
                                device="cpu").eval()


def prompts(rng, n, max_len=20):
    return [rng.randint(0, V, (int(rng.randint(1, max_len)),)).tolist()
            for _ in range(n)]


def drive(sp, pool, gen_len=5, eos=None, check=None, limit=5000):
    """Continuous arrival: keep the lanes full from ``pool`` in order,
    step until every request is terminal, flush. ``check(sp)`` runs after
    every step. Returns the requests in arrival order."""
    queued, reqs = list(pool), []
    steps = 0
    while queued or sp.has_work():
        while queued and sum(r.state not in TERMINAL
                             for r in reqs) < sp.max_batch:
            reqs.append(sp.add_request(queued.pop(0), max_new_tokens=gen_len,
                                       eos_token_id=eos))
        sp.step()
        steps += 1
        if check is not None:
            check(sp)
        assert steps < limit, "churn stuck"
    sp.flush()
    return reqs


def assert_accounting_exact(m):
    """Refcounts mirror the page tables; free, withheld, LRU and held
    pages partition the pool; no registered page is free or withheld."""
    refs = np.zeros((m.num_pages,), np.int64)
    for row in m._page_table:
        for pg in row:
            if pg >= 0:
                refs[int(pg)] += 1
    np.testing.assert_array_equal(refs, m._refcount)
    free, withheld, lru = set(m._free_pages), set(m._withheld), set(m._lru)
    held = {p for p in range(m.num_pages) if m._refcount[p] > 0}
    groups = [free, withheld, lru, held]
    for i, a in enumerate(groups):
        for b in groups[i + 1:]:
            assert not a & b
    assert sum(map(len, groups)) == m.num_pages
    assert not any(p in m._page_key for p in free | withheld)


# -- FaultPlan ----------------------------------------------------------------


def test_plan_validation_scoping_and_disarmed_path():
    with pytest.raises(ValueError, match="dispatch rate"):
        FaultPlan(dispatch=1.5)
    with pytest.raises(ValueError, match="pool rate"):
        FaultPlan(pool_squeeze=-0.1)
    with pytest.raises(ValueError, match="stall_ticks"):
        FaultPlan(replica_stall=0.5, stall_ticks=0)
    assert active_plan() is None
    for seam in SEAMS:
        assert fault_point(seam) is None      # disarmed: one check, None
    with FaultPlan(seed=1, dispatch=1.0) as plan:
        assert active_plan() is plan
        with pytest.raises(RuntimeError, match="already armed"):
            FaultPlan().__enter__()
        with pytest.raises(ValueError, match="unknown fault seam"):
            fault_point("warp_core")
        with pytest.raises(InjectedFault) as e:
            fault_point("dispatch")
        assert e.value.seam == "dispatch"
    assert active_plan() is None


@pytest.mark.parametrize("seed", [0, 7])
def test_fire_pattern_matches_the_jax_plan(seed):
    """One hit sequence over every seam kind (raising, sleeping, squeeze,
    returning) from the same seed and rates: the port's plan fires
    exactly where the reference's does, its squeezes withhold the same
    pages of a manager, and its counts match."""
    rates = dict(dispatch=0.3, h2d=0.2, reconcile=0.25, slow_step=0.3,
                 slow_step_s=0.0, pool_squeeze=0.4, squeeze_pages=2,
                 squeeze_steps=2, replica_crash=0.2, replica_stall=0.3,
                 stall_ticks=3, transfer_drop=0.3, transfer_corrupt=0.2,
                 host_spill_drop=0.5, tier_restore_corrupt=0.5)
    seq = np.random.RandomState(seed + 100).choice(list(SEAMS), 300)
    mk = dict(num_layers=1, num_kv_heads=2, head_dim=8, num_pages=8,
              max_batch=2, max_seq_len=32, page_size=4)

    def run(plan_cls, mgr):
        out = []
        with plan_cls(seed=seed, **rates) as plan:
            for seam in seq:
                try:
                    got = fault_point_of(plan_cls)(
                        seam, cache=mgr if seam == "pool" else None)
                    out.append(("ret", got))
                except Exception as exc:   # InjectedFault of either
                    out.append(("raise", type(exc).__name__, exc.seam))
                out.append(("withheld", mgr.withheld_page_count,
                            list(mgr._free_pages)))
        return out, dict(plan.fired)

    want, want_fired = run(JaxPlan, JaxManager(**mk))
    got, fired = run(FaultPlan, KVCacheManager(**mk, device="cpu"))
    assert got == want
    assert fired == want_fired
    assert all(fired[s] for s in SEAMS)


def fault_point_of(plan_cls):
    if plan_cls is FaultPlan:
        return fault_point
    from paddle_tpu.inference.faults import fault_point as jax_point
    return jax_point


def test_withhold_never_touches_referenced_pages():
    for mgr in (KVCacheManager(num_layers=1, num_kv_heads=2, head_dim=8,
                               num_pages=4, max_batch=2, max_seq_len=32,
                               page_size=4, device="cpu"),
                JaxManager(num_layers=1, num_kv_heads=2, head_dim=8,
                           num_pages=4, max_batch=2, max_seq_len=32,
                           page_size=4)):
        slot = mgr.admit(6)                  # claims 2 pages
        assert mgr.withhold_pages(99) == 2   # only the strictly-free ones
        assert mgr.withheld_page_count == 2 and mgr.seq_len(slot) == 6
        assert mgr.available_page_count == 0
        assert mgr.restore_withheld() == 2
        assert mgr._free_pages == [3, 2]


# -- the sync engine under one plan, port against the reference --------------


@pytest.mark.parametrize("case", ["crash", "squeeze"])
def test_sync_engine_under_a_plan_matches_jax(case):
    """A continuous-arrival churn under a seeded plan on both synchronous
    engines: per request the same state, stream and error code; after
    every step the same pool and slot counts; at the end the same
    counters (failures by seam, retries, preemptions, finished, failed)
    and the plan fired the same seams the same number of times."""
    jm, tm = pair()
    kw = dict(max_batch=3, max_seq_len=48, page_size=8, chunk=8,
              num_pages=12, async_engine=False, max_step_retries=1,
              retry_backoff_s=0.0)
    rates = dict(crash=dict(dispatch=0.12, h2d=0.08, reconcile=0.12,
                            slow_step=0.1, slow_step_s=0.0),
                 squeeze=dict(dispatch=0.05, pool_squeeze=0.3,
                              squeeze_pages=4, squeeze_steps=3))[case]
    pool = prompts(np.random.RandomState(5), 24)

    def run(predictor, plan_cls, **extra):
        sp = predictor(**extra, **kw)
        trail = []
        with plan_cls(seed=3, **rates) as plan:
            reqs = drive(sp, pool, check=lambda sp: trail.append((
                sp.cache.free_page_count, sp.cache.available_page_count,
                sp.cache.withheld_page_count, sp.cache.free_slot_count,
                len(sp.waiting), len(sp.running))))
        outs = [(r.state, list(r.output_ids),
                 r.error["code"] if r.error else None) for r in reqs]
        return sp, outs, trail, dict(plan.fired)

    jsp, want, want_trail, want_fired = run(
        lambda **k: JaxPredictor(jm, use_kernel=False, **k), JaxPlan)
    tsp, got, trail, fired = run(
        lambda **k: ServingPredictor(tm, device="cpu", **k), FaultPlan)
    assert any(s for _, s, _ in want), "the reference streams are empty"
    assert got == want
    assert trail == want_trail
    assert fired == want_fired
    jt, tt = jsp.telemetry(), tsp.telemetry()
    keys = [k for k in jt if k.startswith((
        "serving_step_failures", "serving_faults_injected",
        "serving_step_retries", "serving_requests_", "serving_fail_reasons",
        "serving_preemptions", "serving_tokens_emitted", "kv_pages_"))]
    assert {k: tt.get(k) for k in keys} == {k: jt[k] for k in keys}
    assert tt["serving_step_failures"] > 0 or case == "squeeze"
    assert tt["serving_requests_failed"] > 0 if case == "crash" else True
    assert sorted(tsp.cache._free_pages) == sorted(jsp.cache._free_pages)
    assert tsp.cache.available_page_count == tsp.cache.num_pages


# -- the recovery cases of the reference suite ---------------------------------


def fault_free(model, pool, gen_len, **kw):
    sp = ServingPredictor(model, device="cpu", **kw)
    reqs = [sp.add_request(p, max_new_tokens=gen_len) for p in pool]
    while sp.has_work():
        sp.step()
    sp.flush()
    assert all(r.state == FINISHED for r in reqs)
    return [list(r.output_ids) for r in reqs]


def test_transient_dispatch_fault_replays_bit_identical():
    rng = np.random.RandomState(0)
    model = port_model()
    kw = dict(max_batch=2, max_seq_len=48, page_size=8, retry_backoff_s=0.0)
    pool = prompts(rng, 4, 10)
    want = fault_free(model, pool, 4, **kw)
    sp = ServingPredictor(model, device="cpu", **kw)
    reqs = [sp.add_request(p, max_new_tokens=4) for p in pool]
    sp.step()
    with FaultPlan(seed=0, dispatch=1.0) as plan:
        sp.step()                             # crashes, rolls back
    assert plan.fired["dispatch"] == 1
    while sp.has_work():
        sp.step()
    sp.flush()
    assert [list(r.output_ids) for r in reqs] == want
    flat = sp.telemetry()
    assert flat["serving_step_failures"] == 1
    assert flat["serving_faults_injected{seam=dispatch}"] == 1
    assert flat["serving_step_retries"] >= 1
    assert flat["serving_requests_failed"] == 0


def test_transient_reconcile_fault_replays_bit_identical():
    """A reconcile crash on the async engine drops the ring, takes back
    the tokens it charged and replays: the streams are the fault-free
    ones, and the feedback carry was reset."""
    rng = np.random.RandomState(1)
    model = port_model()
    kw = dict(max_batch=2, max_seq_len=48, page_size=8, async_engine=True,
              retry_backoff_s=0.0)
    pool = prompts(rng, 3, 6)
    want = fault_free(model, pool, 5, **kw)
    sp = ServingPredictor(model, device="cpu", **kw)
    reqs = [sp.add_request(p, max_new_tokens=5) for p in pool]
    for _ in range(3):
        sp.step()
    assert sp._inflight
    with FaultPlan(seed=0, reconcile=1.0) as plan:
        sp.flush()
    assert plan.fired["reconcile"] >= 1
    assert not sp._inflight and sp._steady is None
    assert not sp._prev.any()
    assert all(r._pending_n == 0 for r in reqs)
    while sp.has_work():
        sp.step()
    sp.flush()
    assert [list(r.output_ids) for r in reqs] == want
    assert sp.telemetry()["serving_requests_failed"] == 0


def test_eos_request_counted_when_its_overhang_entry_drops():
    rng = np.random.RandomState(2)
    model = port_model()
    prompt = rng.randint(0, V, (5,)).tolist()
    probe = ServingPredictor(model, device="cpu", max_batch=1,
                             max_seq_len=48, page_size=8)
    stream = probe.generate([prompt], max_new_tokens=6)[0]
    eos = int(stream[2])
    want = stream[:stream.index(eos) + 1]
    sp = ServingPredictor(model, device="cpu", max_batch=1, max_seq_len=48,
                          page_size=8, async_engine=True, retry_backoff_s=0.0)
    req = sp.add_request(prompt, max_new_tokens=6, eos_token_id=eos)
    for _ in range(30):
        sp.step()
        if req.done and req.state == RUNNING and sp._inflight:
            break
    else:
        pytest.fail("never reached the eos-landed, overhang-in-flight state")
    with FaultPlan(seed=0, reconcile=1.0) as plan:
        sp.step()
    assert plan.fired["reconcile"] == 1
    while sp.has_work():
        sp.step()
    sp.flush()
    assert req.state == FINISHED and req.output_ids == want
    flat = sp.telemetry()
    assert flat["serving_requests_finished"] == 1
    assert flat["serving_requests_failed"] == 0


def test_retry_exhaustion_fails_the_request_not_the_predictor():
    rng = np.random.RandomState(3)
    sp = ServingPredictor(port_model(), device="cpu", max_batch=1,
                          max_seq_len=48, page_size=8, max_step_retries=2,
                          retry_backoff_s=0.0)
    req = sp.add_request(rng.randint(0, V, (4,)).tolist(), max_new_tokens=4)
    with FaultPlan(seed=0, dispatch=1.0):
        for _ in range(8):
            sp.step()
            if req.state == FAILED:
                break
    assert req.state == FAILED
    assert req.error["code"] == "step_retry_exhausted"
    assert req.retry_count == 3
    assert sp.cache.available_page_count == sp.cache.num_pages
    assert sp.cache.free_slot_count == sp.max_batch
    ok = sp.add_request(rng.randint(0, V, (4,)).tolist(), max_new_tokens=2)
    while sp.has_work():
        sp.step()
    sp.flush()
    assert ok.state == FINISHED and len(ok.output_ids) == 2


def test_single_sequence_pool_exhaustion_fails_individually():
    rng = np.random.RandomState(4)
    sp = ServingPredictor(port_model(), device="cpu", max_batch=1,
                          max_seq_len=96, page_size=4, num_pages=2,
                          max_step_retries=0, retry_backoff_s=0.0)
    big = sp.add_request(rng.randint(0, V, (7,)).tolist(), max_new_tokens=8)
    while sp.has_work():
        sp.step()
    sp.flush()
    assert big.state == FAILED and big.error["code"] == "pool_exhausted"
    assert "cannot grow" in big.error["message"]
    assert sp.cache.available_page_count == sp.cache.num_pages
    small = sp.add_request(rng.randint(0, V, (3,)).tolist(),
                           max_new_tokens=2)
    while sp.has_work():
        sp.step()
    sp.flush()
    assert small.state == FINISHED and len(small.output_ids) == 2


def test_pool_squeeze_expires_with_no_running_lanes():
    rng = np.random.RandomState(5)
    sp = ServingPredictor(port_model(), device="cpu", max_batch=1,
                          max_seq_len=32, page_size=4, num_pages=4,
                          retry_backoff_s=0.0)
    with FaultPlan(seed=0, pool_squeeze=1.0, squeeze_pages=3,
                   squeeze_steps=2) as plan:
        sp.step()
        assert plan.fired["pool"] == 1
        assert sp.cache.withheld_page_count == 3
        assert sp.healthz()["withheld_pages"] == 3
        req = sp.add_request(rng.randint(0, V, (10,)).tolist(),
                             max_new_tokens=2)
        for _ in range(20):
            sp.step()
            if req.state == FINISHED:
                break
        sp.flush()
        assert req.state == FINISHED and len(req.output_ids) == 2
    assert sp.cache.withheld_page_count == 0


def test_other_exceptions_propagate():
    """Only injected faults and CUDA out-of-memory errors are recovered:
    anything else (a CUDA error that poisons the context, a host bug)
    propagates out of step()."""
    sp = ServingPredictor(port_model(), device="cpu", max_batch=1,
                          max_seq_len=32, page_size=8)
    sp.add_request([1, 2, 3], max_new_tokens=2)

    def boom(*args):
        raise RuntimeError("CUDA error: an illegal memory access")

    sp._unified = boom
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sp.step()
    assert sp.telemetry()["serving_step_failures"] == 0
