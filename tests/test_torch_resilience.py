"""The serving engine's resilience layer on the port: deadlines, SLO
shedding, ``healthz()`` and the chaos churn, against the JAX package.

``healthz()`` has the reference's keys and, over the same scripted run
(shed, deadline, an injected crash), its values, timing fields excepted.
The chaos churn is the reference suite's 1k-step gate cut to ~150 steps,
on the synchronous and the async engine: every request ends terminal,
accounting stays exact after every step, every FINISHED stream equals
the fault-free run's and the drained pool is whole.
"""
import time

import numpy as np
import pytest

from paddle_tpu.inference import FaultPlan as JaxPlan
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import SLOConfig as JaxSLO
from paddle_tpu_torch.inference import FaultPlan, ServingPredictor, SLOConfig
from paddle_tpu_torch.inference.serving import FAILED, FINISHED, WAITING
from paddle_tpu_torch.observability import MetricsRegistry

from test_torch_faults import (TERMINAL, V, assert_accounting_exact, drive,
                               pair, port_model, prompts)

TIMING = ("snapshot_age_s", "ttft_p99_ema_ms")


def predictor(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("page_size", 8)
    return ServingPredictor(port_model(), device="cpu", **kw)


def finish(sp):
    while sp.has_work():
        sp.step()
    sp.flush()


# -- deadlines ----------------------------------------------------------------


def test_deadline_validation_and_waiting_ttl():
    rng = np.random.RandomState(0)
    sp = predictor()
    with pytest.raises(ValueError, match="deadline_s"):
        sp.add_request([1, 2, 3], deadline_s=-1.0)
    assert not sp._deadlines_armed
    ok = sp.add_request(rng.randint(0, V, (4,)).tolist(), max_new_tokens=3)
    doomed = sp.add_request(rng.randint(0, V, (4,)).tolist(),
                            max_new_tokens=3, deadline_s=0.0)
    finish(sp)
    assert doomed.state == FAILED and doomed.output_ids == []
    assert doomed.error["code"] == "deadline_exceeded"
    assert ok.state == FINISHED and len(ok.output_ids) == 3
    flat = sp.telemetry()
    assert flat["serving_deadline_misses"] == 1
    assert flat["serving_fail_reasons{reason=deadline_exceeded}"] == 1


@pytest.mark.parametrize("async_engine", [False, True])
def test_running_request_past_deadline_retires(async_engine):
    rng = np.random.RandomState(1)
    sp = predictor(async_engine=async_engine)
    req = sp.add_request(rng.randint(0, V, (4,)).tolist(), max_new_tokens=64,
                         deadline_s=0.05)
    sp.step()
    assert req.state not in TERMINAL
    time.sleep(0.06)
    for _ in range(4):
        sp.step()
        if req.state == FAILED:
            break
    sp.flush()
    assert req.state == FAILED and "running" in req.error["message"]
    n = len(req.output_ids)
    assert sp.cache.free_slot_count == sp.max_batch
    assert sp.cache.available_page_count == sp.cache.num_pages
    ok = sp.add_request(rng.randint(0, V, (4,)).tolist(), max_new_tokens=2)
    finish(sp)
    assert ok.state == FINISHED and len(ok.output_ids) == 2
    assert len(req.output_ids) == n          # late emissions discarded


def test_readmission_keeps_the_absolute_deadline():
    rng = np.random.RandomState(2)
    sp = predictor()
    req = sp.add_request(rng.randint(0, V, (4,)).tolist(), max_new_tokens=8,
                         deadline_s=30.0)
    sp.step()
    anchor = req.submit_time
    sp._preempt_youngest()
    assert req.submit_time == anchor
    finish(sp)
    assert req.state == FINISHED
    stale = sp.add_request(rng.randint(0, V, (4,)).tolist(),
                           max_new_tokens=8, deadline_s=0.0)
    assert stale.past_deadline()
    finish(sp)
    assert stale.state == FAILED and stale.output_ids == []


# -- SLO shedding --------------------------------------------------------------


def test_slo_config_validation():
    with pytest.raises(ValueError, match="max_waiting"):
        SLOConfig(max_waiting=0)
    with pytest.raises(ValueError, match="ema_alpha"):
        SLOConfig(ema_alpha=0.0)
    with pytest.raises(ValueError, match="fraction"):
        SLOConfig(max_pool_occupancy=95)
    with pytest.raises(ValueError, match="max_inflight_depth"):
        SLOConfig(max_inflight_depth=-1)
    with pytest.raises(ValueError, match="ttft_p99_slo_ms"):
        SLOConfig(ttft_p99_slo_ms=0.0)
    with pytest.raises(ValueError, match="SLOConfig"):
        predictor(slo={"max_waiting": 3})
    with pytest.raises(ValueError, match="disabled"):
        predictor(metrics=MetricsRegistry(enabled=False))
    with pytest.raises(ValueError, match="role"):
        predictor(role="router")
    with pytest.raises(ValueError, match="max_step_retries"):
        predictor(max_step_retries=-1)


def test_bounded_queue_and_pool_pressure_shed():
    rng = np.random.RandomState(3)
    sp = predictor(max_batch=1, slo=SLOConfig(max_waiting=2))
    ps = [rng.randint(0, V, (4,)).tolist() for _ in range(3)]
    a = sp.add_request(ps[0], max_new_tokens=2)
    b = sp.add_request(ps[1], max_new_tokens=2)
    assert sp.admission_verdict() == "queue_full"
    shed = sp.add_request(ps[2], max_new_tokens=2)
    assert shed.state == FAILED and shed.error["code"] == "shed_queue_full"
    assert shed not in sp.waiting
    finish(sp)
    assert [a.state, b.state] == [FINISHED] * 2
    assert sp.admission_verdict() is None
    assert sp.add_request(ps[2], max_new_tokens=2).state == WAITING
    assert sp.telemetry()["serving_requests_shed"] == 1

    sp = predictor(max_batch=1, slo=SLOConfig(max_waiting=64,
                                              max_pool_occupancy=0.01))
    p = rng.randint(0, V, (8,)).tolist()
    sp.add_request(p, max_new_tokens=8)
    sp.step()
    assert sp.pool_occupancy > 0.01
    assert sp.admission_verdict() is None       # no backlog: admit
    sp.add_request(p, max_new_tokens=8)
    assert sp.admission_verdict() == "pool_pressure"
    assert sp.add_request(p, max_new_tokens=8).error["code"] \
        == "shed_pool_pressure"
    off = predictor(max_batch=1)
    assert all(off.add_request(p, max_new_tokens=2).state == WAITING
               for _ in range(8))
    assert off.admission_verdict() is None


def test_generate_step_budget_overflow_fails_stragglers(monkeypatch):
    sp = predictor()
    monkeypatch.setattr(sp, "step", lambda: {})
    with pytest.raises(RuntimeError, match="scheduler stuck"):
        sp.generate([[1, 2, 3, 4]], max_new_tokens=3)
    flat = sp.telemetry()
    assert flat["serving_fail_reasons{reason=scheduler_stuck}"] == 1
    assert not sp.has_work()
    assert sp.cache.free_slot_count == sp.max_batch
    assert sp.cache.available_page_count == sp.cache.num_pages


# -- healthz against the reference ---------------------------------------------


def test_healthz_keys_and_values_match_jax():
    """The same scripted run on both packages (a shed at the bounded
    queue, a request past its deadline, one injected dispatch crash):
    the same healthz keys at every point, and the same values but the
    timing fields."""
    jm, tm = pair()
    kw = dict(max_batch=1, page_size=8, max_seq_len=64, retry_backoff_s=0.0,
              replica_id=3, role="decode", async_engine=False)
    p = np.random.RandomState(4).randint(0, V, (6,)).tolist()

    def script(sp, slo_cls, plan_cls):
        snaps = [sp.healthz()]
        sp.add_request(p, max_new_tokens=3)
        sp.add_request(p, max_new_tokens=3)
        snaps.append(sp.healthz())
        shed = sp.add_request(p, max_new_tokens=3)
        sp.step()
        expired = sp.add_request([1, 2], max_new_tokens=2, deadline_s=0.0)
        sp.step()
        snaps.append(sp.healthz())
        with plan_cls(seed=0, dispatch=1.0):
            sp.step()
        snaps.append(sp.healthz())
        while sp.has_work():
            sp.step()
        sp.flush()
        snaps.append(sp.healthz())
        return snaps, (shed.error["code"], expired.error["code"])

    want, wcodes = script(JaxPredictor(jm, use_kernel=False,
                                       slo=JaxSLO(max_waiting=2), **kw),
                          JaxSLO, JaxPlan)
    got, codes = script(ServingPredictor(tm, device="cpu",
                                         slo=SLOConfig(max_waiting=2), **kw),
                        SLOConfig, FaultPlan)
    assert codes == wcodes == ("shed_queue_full", "deadline_exceeded")
    assert want[-1]["tokens_emitted"] > 0
    for w, g in zip(want, got):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k not in TIMING} \
            == {k: v for k, v in w.items() if k not in TIMING}
        assert all(isinstance(g[k], float) for k in TIMING)
    assert got[1]["status"] == "shedding"
    assert got[-1]["step_failures"] == 1 and got[-1]["requests_shed"] == 1


# -- the chaos churn -------------------------------------------------------------


@pytest.mark.parametrize("async_engine", [False, True])
def test_chaos_churn_under_seeded_faults(async_engine):
    """~150 scheduler rounds of continuous arrival under every serving
    seam (dispatch / h2d / reconcile crashes, stragglers, pool
    squeezes): step() never raises, accounting is exact after every
    step, every request ends terminal with the finished and failed
    counters partitioning them, every FINISHED stream is the fault-free
    run's, every raised fault is counted by seam, and the drained pool
    is whole with nothing recaptured."""
    model = port_model()
    kw = dict(max_batch=3, max_seq_len=48, page_size=8, chunk=8,
              num_pages=14, async_engine=async_engine, max_step_retries=6,
              retry_backoff_s=0.0)
    pool = prompts(np.random.RandomState(7), 50)

    def run(plan=None):
        sp = ServingPredictor(model, device="cpu", **kw)
        steps = [0]

        def check(sp):
            steps[0] += 1
            assert_accounting_exact(sp.cache)

        if plan is None:
            reqs = drive(sp, pool, check=check)
        else:
            with plan:
                reqs = drive(sp, pool, check=check)
        assert_accounting_exact(sp.cache)
        flat = sp.telemetry()
        assert (flat["serving_requests_finished"]
                + flat["serving_requests_failed"] == len(reqs))
        return sp, reqs, steps[0]

    base, want_reqs, _ = run()
    want = [list(r.output_ids) for r in want_reqs]
    plan = FaultPlan(seed=11, dispatch=0.06, h2d=0.05, reconcile=0.06,
                     slow_step=0.05, slow_step_s=1e-4, pool_squeeze=0.1,
                     squeeze_pages=3, squeeze_steps=2)
    sp, reqs, steps = run(plan)
    assert steps >= 140
    for seam in ("dispatch", "h2d", "reconcile", "slow_step", "pool"):
        assert plan.fired[seam] > 0, seam
    assert all(r.state in TERMINAL for r in reqs)
    finished = [i for i, r in enumerate(reqs) if r.state == FINISHED]
    assert len(finished) > len(reqs) // 2
    for i in finished:
        assert list(reqs[i].output_ids) == want[i], f"request {i}"
    assert all(r.error and r.error["code"] for r in reqs
               if r.state == FAILED)
    cache = sp.cache
    assert cache.available_page_count == cache.num_pages
    assert cache.free_slot_count == cache.max_batch
    assert cache.withheld_page_count == 0
    assert sp.decode_trace_count == base.decode_trace_count
    flat = sp.telemetry()
    raised = plan.fired["dispatch"] + plan.fired["h2d"] \
        + plan.fired["reconcile"]
    assert flat["serving_step_failures"] == raised
    for seam in ("dispatch", "h2d", "reconcile"):
        assert flat[f"serving_faults_injected{{seam={seam}}}"] \
            == plan.fired[seam]
