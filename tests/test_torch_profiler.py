"""The port's profiler (``paddle_tpu_torch/profiler/``) against the JAX
package's: the scheduler's states, the window life cycle, the summary
tables and the throughput timer give the reference's results for the
same inputs, and a served run under a ``Profiler`` window exports the
reference's trace (the same spans, lanes and counter track). The GPU
target's device capture runs on the card (``chip_smoke.py`` phase 17).
"""
import json
import os

import numpy as np
import pytest

from paddle_tpu import profiler as jprof
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.profiler import profiler_statistic as jstat
from paddle_tpu.profiler.record import HostEvent as JaxEvent
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.inference import ServingPredictor
from paddle_tpu_torch.profiler import profiler_statistic as tstat
from paddle_tpu_torch.profiler.record import HostEvent, recorder

from test_torch_faults import drive, pair, prompts


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2),
    dict(closed=0, ready=0, record=1, repeat=2),
    dict(closed=2, ready=1, record=3, repeat=1, skip_first=3)])
def test_scheduler_states_match_jax(kw):
    got = tprof.make_scheduler(**kw)
    want = jprof.make_scheduler(**kw)
    assert [got(i).name for i in range(30)] == [want(i).name
                                                 for i in range(30)]
    with pytest.raises(ValueError, match="record"):
        tprof.make_scheduler(closed=0, ready=0, record=0)


def test_windows_record_and_export_like_jax(tmp_path):
    """A (start, end) step range over RecordEvent ranges: the same
    windows open and close, each exports one trace, and outside a window
    nothing records."""
    def run(pkg, out):
        states = []
        p = pkg.Profiler(scheduler=(2, 5),
                         on_trace_ready=pkg.export_chrome_tracing(out, "w"))
        p.start()
        for i in range(8):
            states.append(p.current_state.name)
            with pkg.RecordEvent(f"it{i}"):
                pass
            p.step()
        p.stop()
        files = sorted(os.listdir(out))
        names = [[e["name"] for e in pkg.load_profiler_result(
            os.path.join(out, f))] for f in files]
        return states, files, names

    want = run(jprof, str(tmp_path / "jax"))
    got = run(tprof, str(tmp_path / "port"))
    assert got == want
    assert got[2] == [["it2", "it3", "it4"]]
    assert not recorder.enabled and not tprof.in_profiler_mode()


def test_summary_tables_and_timer_match_jax(capsys):
    spans = [("pack", 0, 50, "serving"), ("pack", 60, 200, "serving"),
             ("fwd", 10, 990, "user"), ("io", 5, 6, "op")]
    for key in tstat.SortedKeys:
        got = tstat.gen_summary_tables(
            [HostEvent(n, a, b, 1, c) for n, a, b, c in spans], "us",
            sorted_by=key)
        want = jstat.gen_summary_tables(
            [JaxEvent(n, a, b, 1, c) for n, a, b, c in spans], "us",
            sorted_by=jstat.SortedKeys[key.name])
        assert got == want
    assert tstat.gen_summary_tables([]) == jstat.gen_summary_tables([])
    for pkg in (tprof, jprof):
        b = pkg.Benchmark()
        b.begin()
        for n in (4, 8):
            b.before_reader()
            b.after_reader()
            b.step(n)
        info = b.step_info("tokens")
        b.end()
        assert "avg_batch_cost" in info and "tokens/sec" in info
        assert b.num_steps == 2 and b.speed() == 0.0
    with pytest.raises(RuntimeError, match="is_available"):
        tprof.Profiler(targets=[tprof.ProfilerTarget.GPU])
    for kw in (dict(targets=[tprof.ProfilerTarget.TPU]),
               dict(record_shapes=True), dict(profile_memory=True),
               dict(with_flops=True), dict(emit_nvtx=True),
               dict(custom_device_types=["npu"])):
        with pytest.raises(NotImplementedError, match="not ported"):
            tprof.Profiler(**kw)


def test_served_trace_matches_jax(tmp_path):
    """A served churn inside one Profiler window on both packages: the
    exported traces hold the same host span names, the same lanes (by
    request, in order) with complete b/e pairs, admit and eos instants,
    and the in-flight counter track; the protobuf exporter writes the
    same events."""
    jm, tm = pair()
    kw = dict(max_batch=2, page_size=8, max_seq_len=64)
    pool = prompts(np.random.RandomState(21), 4, 12)

    def traced(pkg, sp, out, exporter):
        p = pkg.Profiler(on_trace_ready=exporter(out, "serve"))
        p.start()
        reqs = drive(sp, pool, gen_len=4)
        p.stop()
        events = pkg.load_profiler_result(p._last_export)
        index = {str(r.req_id): i for i, r in enumerate(reqs)}
        lanes = [[] for _ in reqs]
        for e in events:
            if "id" in e:
                lanes[index[e["id"]]].append((e["ph"], e["name"]))
        spans = sorted({e["name"] for e in events if e["ph"] == "X"})
        track = [e["args"]["value"] for e in events if e["ph"] == "C"]
        return p, spans, lanes, track, [r.output_ids for r in reqs]

    _, *want = traced(jprof, JaxPredictor(jm, use_kernel=False, **kw),
                      str(tmp_path / "jax"), jprof.export_chrome_tracing)
    p, *got = traced(tprof, ServingPredictor(tm, device="cpu", **kw),
                     str(tmp_path / "port"), tprof.export_chrome_tracing)
    assert got == want
    spans, lanes, track, outs = got
    assert all(outs)
    assert {"pack_dispatch", "dispatch", "reconcile", "flush"} <= set(spans)
    for lane in lanes:
        # matched: a lane the async engine closed by count before its
        # last tokens landed reopens for them, as the reference's does
        assert lane[0] == ("b", "request") and ("e", "request") in lane
        assert ("n", "admit") in lane and ("n", "eos") in lane
    assert track and track[-1] == 0.0
    assert p.device_events == []          # the CPU target: host side only
    out = str(tmp_path / "pb")
    tprof.export_protobuf(out, "serve")(p)
    assert p._last_export.endswith(".pb.json")
    with open(p._last_export) as f:
        assert json.load(f)["traceEvents"]
