"""Profiler facade — port of ``paddle_tpu/profiler/profiler.py``.

The scheduler state machine (``make_scheduler``: CLOSED / READY / RECORD /
RECORD_AND_RETURN), :class:`Profiler` with ``start`` / ``stop`` / ``step``
and the ``on_trace_ready`` exporters (``export_chrome_tracing``,
``export_protobuf``). A RECORD window turns the host recorder on
(``record.py``): ``RecordEvent`` ranges, the observability spans, the
serving engine's request lanes and counter tracks.

The device side: where the reference starts a ``jax.profiler`` capture,
the ``ProfilerTarget.GPU`` target runs ``torch.profiler`` with CUDA
activity over the window, and the observability spans open a
``torch.profiler.record_function`` range each (``set_device_tracing``),
so host ranges line up with the kernels they launched. The exported
Chrome trace is ONE file: the recorder's host ranges (``X``), its lane
and counter events (``b`` / ``n`` / ``e`` / ``C``), and the window's device
activity (kernels, copies, fills; category from the activity type) under
the process name ``device``, moved onto the recorder's clock. The span
ranges ``record_function`` mirrors on the device timeline are left out of
the device events: they are not device work. The ``CPU`` target records
the host side only.
"""
from __future__ import annotations

import json
import os
import time
from enum import Enum

from .record import now_ns, recorder
from .timer import benchmark as _benchmark


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # record, and hand the result over


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0):
    """``fn(step) -> ProfilerState`` cycling CLOSED^closed READY^ready
    RECORD^(record-1) RECORD_AND_RETURN, ``repeat`` times (0: forever),
    after ``skip_first`` skipped steps."""
    if record < 1:
        raise ValueError(f"record must be >= 1, got {record}")
    if closed < 0 or ready < 0 or skip_first < 0 or repeat < 0:
        raise ValueError("closed/ready/skip_first/repeat must be >= 0")
    num_cycle = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        assert step >= 0
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat > 0 and step // num_cycle >= repeat:
            return ProfilerState.CLOSED
        pos = step % num_cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos < num_cycle - 1:
            return ProfilerState.RECORD
        return ProfilerState.RECORD_AND_RETURN

    return scheduler


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: str | None = None):
    """``on_trace_ready`` callback writing one Chrome trace JSON a window
    (``<worker>_step<n>.json``)."""

    def handle(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_step{prof.step_num}.json")
        prof._export_chrome(path)
        prof._last_export = path

    return handle


def export_protobuf(dir_name: str, worker_name: str | None = None):
    """The same events as :func:`export_chrome_tracing`, written as JSON
    with a ``.pb.json`` suffix (the interchange format is the Chrome
    JSON)."""

    def handle(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_step{prof.step_num}.pb.json")
        prof._export_chrome(path)
        prof._last_export = path

    return handle


def is_annotation(ev) -> bool:
    """Whether a kineto event is an annotation range (``record_function``,
    the spans under a device capture) mirrored onto the device timeline:
    not device work."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None and "annotation" in str(kind()).lower():
        return True
    ann = getattr(ev, "is_user_annotation", None)
    return ann is not None and ann()


def is_device_work(ev) -> bool:
    """Whether a kineto event of a ``torch.profiler`` trace is device work
    (a kernel, copy or fill): device-side, of non-zero duration, and not
    an annotation range (:func:`is_annotation`)."""
    from torch.autograd import DeviceType

    return (ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0
            and not is_annotation(ev))


def _activity(ev) -> str:
    """A device event's kind (``kernel``, ``gpu_memcpy``, ...); by name
    where the trace does not say."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind())
    name = ev.name().lower()
    return "gpu_memcpy" if "memcpy" in name else (
        "gpu_memset" if "memset" in name else "kernel")


def _device_events(prof, offset_ns: int) -> list[dict]:
    """The device activity of a stopped ``torch.profiler`` run as
    Chrome ``X`` events on the recorder's clock (kineto stamps wall-clock
    nanoseconds; ``offset_ns`` is wall minus recorder clock)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if not is_device_work(ev):
            continue
        out.append({"name": ev.name(), "ph": "X",
                    "ts": (ev.start_ns() - offset_ns) / 1e3,
                    "dur": ev.duration_ns() / 1e3,
                    "cat": _activity(ev),
                    "tid": int(ev.device_resource_id()) % 2**31,
                    "args": {"device": int(ev.device_index()),
                             "correlation": int(ev.correlation_id())}})
    return out


class Profiler:
    """Host (and, with ``ProfilerTarget.GPU``, device) tracing over the
    windows ``scheduler`` marks; ``on_trace_ready`` runs at the end of
    each RECORD window. ``scheduler`` is a ``fn(step) -> ProfilerState``
    (see :func:`make_scheduler`), a ``(start, end)`` step range, or
    ``None`` (record from ``start()`` to ``stop()``). The reference's
    other targets and its ``record_shapes`` / ``profile_memory`` /
    ``with_flops`` / ``emit_nvtx`` / ``custom_device_types`` options are
    not ported: a non-default value raises ``NotImplementedError``."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False,
                 emit_nvtx: bool = False, custom_device_types=None):
        self.targets = list(targets or [ProfilerTarget.CPU])
        other = [t for t in self.targets
                 if t not in (ProfilerTarget.CPU, ProfilerTarget.GPU)]
        unused = [name for name, on in (
            ("record_shapes", record_shapes),
            ("profile_memory", profile_memory), ("with_flops", with_flops),
            ("emit_nvtx", emit_nvtx),
            ("custom_device_types", custom_device_types)) if on]
        if other or unused:
            raise NotImplementedError(
                f"not ported: targets {[t.name for t in other]}, options "
                f"{unused}; the port traces ProfilerTarget.CPU and .GPU "
                "with the default options")
        self._device_target = ProfilerTarget.GPU in self.targets
        if self._device_target:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ProfilerTarget.GPU traces a CUDA device and "
                    "torch.cuda.is_available() is False")
        if isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            if end <= start or start < 0:
                raise ValueError(
                    f"scheduler ({start}, {end}) needs 0 <= start < end")
            self._scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=1 if start > 0 else 0,
                record=end - start, repeat=1)
        else:
            self._scheduler = scheduler or _default_state_scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._collected: list = []
        self._collected_aux: list = []
        self._last_export = None
        self._torch_prof = None
        self._clock_offset_ns = 0
        #: the last closed window's device activity (Chrome event dicts)
        self.device_events: list[dict] = []

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        _benchmark().begin()
        if self.timer_only:
            return
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._enable()

    def stop(self):
        _benchmark().end()
        if self.timer_only:
            return
        if recorder.enabled:
            self._disable()
            if self.current_state in (ProfilerState.RECORD_AND_RETURN,
                                      ProfilerState.RECORD):
                if self.on_trace_ready:
                    self.on_trace_ready(self)
            self._collected = list(recorder.events)   # kept for summary()
            self._collected_aux = list(recorder.aux)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: int | None = None):
        """Advance the scheduler one step (once a train or serving
        iteration)."""
        _benchmark().step(num_samples)
        if self.timer_only:
            self.step_num += 1
            return
        prev = self.current_state
        self.step_num += 1
        new = self._scheduler(self.step_num)
        if prev in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            if prev == ProfilerState.RECORD_AND_RETURN or \
                    new == ProfilerState.CLOSED:
                self._disable()
                if self.on_trace_ready:
                    self.on_trace_ready(self)
                self._collected = list(recorder.events)
                self._collected_aux = list(recorder.aux)
                recorder.clear()
        if new in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN) \
                and not recorder.enabled:
            self._enable()
        self.current_state = new

    def step_info(self, unit=None):
        return _benchmark().step_info(unit)

    def _enable(self):
        recorder.clear()   # a new window inherits no old events
        if self._device_target:
            from torch.profiler import ProfilerActivity, profile

            from ..observability.tracing import set_device_tracing

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            self._torch_prof = prof
            self._clock_offset_ns = time.time_ns() - now_ns()
            set_device_tracing(True)
        recorder.enabled = True

    def _disable(self):
        recorder.enabled = False
        prof, self._torch_prof = self._torch_prof, None
        if prof is not None:
            from ..observability.tracing import set_device_tracing

            set_device_tracing(False)
            prof.stop()
            self.device_events = _device_events(prof, self._clock_offset_ns)

    # -- export / summary --------------------------------------------------
    def _export_chrome(self, path: str):
        events = []
        pid = os.getpid()
        # the live buffers while a window is open, else the last closed
        # window's (decided once for both: an empty live aux buffer is a
        # window without lanes, not a reason to fall back)
        live = bool(recorder.events or recorder.aux)
        host_events = recorder.events if live else self._collected
        aux_events = recorder.aux if live else self._collected_aux
        for ev in host_events:
            events.append({
                "name": ev.name, "ph": "X", "pid": pid,
                "tid": ev.tid % 2**31, "ts": ev.start_ns / 1e3,
                "dur": (ev.end_ns - ev.start_ns) / 1e3,
                "cat": ev.category,
            })
        for ev in aux_events:
            rec = {
                "name": ev.name, "ph": ev.ph, "pid": pid,
                "tid": ev.tid % 2**31, "ts": ev.ts_ns / 1e3,
                "cat": ev.category,
            }
            if ev.id is not None:
                rec["id"] = str(ev.id)
            if ev.args is not None:
                rec["args"] = ev.args
            events.append(rec)
        if self.device_events:
            events.append({"name": "process_name", "ph": "M",
                           "pid": "device", "args": {"name": "device"}})
            events += [dict(ev, pid="device") for ev in self.device_events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def export(self, path: str, format: str = "json"):
        self._export_chrome(path)

    def summary(self, sorted_by=None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms"):
        from .profiler_statistic import gen_summary_tables

        events = recorder.events or self._collected
        print(gen_summary_tables(events, time_unit=time_unit,
                                 sorted_by=sorted_by))
