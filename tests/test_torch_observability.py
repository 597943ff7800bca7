"""The port's observability layer (``observability/metrics.py`` and
``observability/tracing.py``) against the JAX package.

The registry gives the reference's snapshots for the same operations
(enabled and disabled paths, reset, labels, histograms); spans and lanes
cost one flag check with no window open; and a served run records, for
each request, the reference's lane events in the reference's order
(admit, prefill chunks, decode rounds, preemption, retry, first token,
eos), with the scheduler spans and the in-flight counter track.
"""
import math

import numpy as np
import pytest

from paddle_tpu.inference import FaultPlan as JaxPlan
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.profiler.record import recorder as jax_recorder
from paddle_tpu_torch.inference import FaultPlan, ServingPredictor
from paddle_tpu_torch.observability import (MetricsRegistry, counter_event,
                                            default_registry,
                                            device_annotation,
                                            disable_metrics, enable_metrics,
                                            merge_snapshots, metrics_enabled,
                                            monotonic, request_begin, span,
                                            tracing_active)
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.profiler.record import recorder

from test_torch_faults import TERMINAL, drive, pair, port_model, prompts


def exercise(reg):
    """One fixed sequence of instrument calls; returns the snapshots it
    passes through."""
    c = reg.counter("reqs", "requests", labels=("kind",))
    g = reg.gauge("depth", "ring depth")
    h = reg.histogram("ttft_ms", "ttft", buckets=(1, 5, 10, 50))
    u = reg.counter("steps", "steps")
    out = []
    c.labels(kind="a").inc()
    c.labels(kind="b").inc(2.5)
    g.set(3)
    g.inc(2)
    g.dec()
    u.inc(4)
    for v in (0.5, 3, 7, 7, 20, 80):
        h.observe(v)
    out.append((reg.snapshot(), reg.snapshot_flat("p_")))
    reg.disable()
    c.labels(kind="a").inc(10)
    g.set(99)
    h.observe(1)
    with pytest.raises(ValueError, match="only go up"):
        u.inc(-1)                       # validated with the registry off
    out.append(reg.snapshot_flat())
    reg.enable()
    reg.reset()
    u.inc()
    out.append(reg.snapshot_flat())
    return out


def test_registry_matches_jax_snapshots():
    assert exercise(MetricsRegistry()) == exercise(jmetrics.MetricsRegistry())
    reg = MetricsRegistry()
    fam = reg.counter("steps", "scheduler rounds")
    assert fam.help == "scheduler rounds"
    assert reg.counter("steps") is fam           # idempotent by name
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("steps")
    with pytest.raises(ValueError, match="declares no labels"):
        fam.labels(kind="x")
    lab = reg.counter("by", labels=("k",))
    with pytest.raises(ValueError, match="missing label"):
        lab.labels(j=1)
    with pytest.raises(ValueError, match="call .labels"):
        lab.inc()
    assert not hasattr(lab, "value")
    reg.histogram("bad").observe(math.nan)
    with pytest.raises(ValueError, match="non-finite"):
        reg.snapshot_flat()


def test_merge_and_the_default_registry():
    a, b = {"x": 1.0, "y": 2.0}, {"y": 2.0, "z": 3.0}
    assert merge_snapshots(a, b) == jmetrics.merge_snapshots(a, b)
    with pytest.raises(ValueError, match="conflicting"):
        merge_snapshots(a, {"x": 5.0})
    assert not default_registry.enabled and not metrics_enabled()
    enable_metrics()
    try:
        assert metrics_enabled()
    finally:
        disable_metrics()
    assert not metrics_enabled()


def test_spans_and_lanes_cost_one_flag_check_when_off():
    recorder.clear()          # a closed window leaves its events behind
    assert not tracing_active()
    s = span("pack_dispatch")
    assert s is span("reconcile") is device_annotation("x")   # shared no-op
    with s:
        pass
    assert request_begin(1) is False
    counter_event("inflight_steps", 1)
    assert not recorder.events and not recorder.aux
    assert monotonic is tracing.monotonic
    recorder.clear()
    recorder.enabled = True
    try:
        with span("pack_dispatch"):
            t0 = monotonic()
        assert request_begin(7, args={"req_id": 7})
        counter_event("inflight_steps", 2)
    finally:
        recorder.enabled = False
    (ev,) = recorder.events
    assert ev.name == "pack_dispatch" and ev.category == "serving"
    assert ev.start_ns <= t0 * 1e9 <= ev.end_ns
    assert [(e.ph, e.name, e.id) for e in recorder.aux] == [
        ("b", "request", 7), ("C", "inflight_steps", None)]
    recorder.clear()


def lanes(aux, reqs):
    """Per request (arrival order), its lane's (phase, name) events."""
    index = {r.req_id: i for i, r in enumerate(reqs)}
    out = [[] for _ in reqs]
    for e in aux:
        if e.id is not None and e.id in index:
            out[index[e.id]].append((e.ph, e.name))
    return out


@pytest.mark.parametrize("async_engine", [False, True])
def test_request_lanes_match_jax(async_engine):
    """A churn with preemption (a tight pool), copy-on-write, an injected
    dispatch crash (retries) and eos: each request's lane holds the
    reference's events in the reference's order, opened once and closed
    once; the scheduler spans and the in-flight counter track ride along
    and the streams are the untraced ones."""
    jm, tm = pair()
    kw = dict(max_batch=3, max_seq_len=48, page_size=8, chunk=8,
              num_pages=7, async_engine=async_engine, retry_backoff_s=0.0)
    pool = prompts(np.random.RandomState(12), 10, 30)
    pool += [list(pool[0]), pool[0][:10] + [5, 6]]

    def traced(sp, rec, plan_cls):
        rec.clear()
        rec.enabled = True
        try:
            with plan_cls(seed=2, dispatch=0.08):
                reqs = drive(sp, pool, gen_len=6, eos=11)
        finally:
            rec.enabled = False
        aux, events = list(rec.aux), list(rec.events)
        rec.clear()
        return reqs, aux, events

    jreqs, jaux, _ = traced(JaxPredictor(jm, use_kernel=False, **kw),
                            jax_recorder, JaxPlan)
    sp = ServingPredictor(tm, device="cpu", **kw)
    treqs, taux, tevents = traced(sp, recorder, FaultPlan)
    assert any(r.output_ids for r in jreqs)
    assert [list(r.output_ids) for r in treqs] == \
        [list(r.output_ids) for r in jreqs]
    want, got = lanes(jaux, jreqs), lanes(taux, treqs)
    assert got == want
    names = {n for lane in got for _, n in lane}
    assert {"admit", "prefill_chunk", "decode", "first_token", "eos",
            "retry"} <= names
    for lane in got:
        assert lane[0] == ("b", "request") and lane[-1] == ("e", "request")
        assert [p for p, _ in lane].count("b") == 1
    assert sp.telemetry()["serving_preemptions"] > 0
    assert {"pack_dispatch", "dispatch", "reconcile"} <= {
        e.name for e in tevents}
    track = [e.args["value"] for e in taux if e.ph == "C"]
    assert track and track[-1] == 0.0
    with FaultPlan(seed=2, dispatch=0.08):
        untraced = drive(ServingPredictor(tm, device="cpu", **kw), pool,
                         gen_len=6, eos=11)
    assert all(r.state in TERMINAL for r in untraced)
    assert [(r.state, r.output_ids) for r in untraced] == \
        [(r.state, r.output_ids) for r in treqs]


def test_midstream_window_has_no_orphan_lane_phases():
    sp = ServingPredictor(port_model(), device="cpu", max_batch=2,
                          page_size=8, max_seq_len=64)
    for p in prompts(np.random.RandomState(13), 2, 10):
        sp.add_request(p, max_new_tokens=6)
    recorder.clear()
    recorder.enabled = True
    try:
        sp.step()
        sp.step()
        recorder.clear()                 # window 1's begins are gone
        while sp.has_work():
            sp.step()
        sp.flush()
    finally:
        recorder.enabled = False
    begins = {e.id for e in recorder.aux if e.ph == "b"}
    laned = {e.id for e in recorder.aux if e.ph in ("n", "e")}
    ends = {e.id for e in recorder.aux if e.ph == "e"}
    assert laned and laned <= begins and ends == begins
    recorder.clear()
