"""Host event recording core — port of ``paddle_tpu/profiler/record.py``.

The one in-process event buffer every host surface feeds: ``RecordEvent``
ranges, the observability spans (``observability/tracing.py``) and the
per-request async lanes and counter tracks of the serving engine. A plain
list is enough: the GIL serializes the appends, and a lock guards the
swap on :meth:`EventRecorder.clear`.

(The reference also hooks its autograd facade's per-op dispatch here; the
port has no such facade yet, so there is no op hook.)
"""
from __future__ import annotations

import threading
import time


class HostEvent:
    """A finished host range (a Chrome ``X`` event)."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "category")

    def __init__(self, name, start_ns, end_ns, tid, category):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid
        self.category = category


class TraceEvent:
    """A raw non-duration Chrome trace event: async-span begin / instant /
    end (``ph`` ``b`` / ``n`` / ``e``, matched by ``(category, id,
    name)``: the serving engine's per-request lanes) and counter samples
    (``ph == "C"``, the series in ``args``). Kept on their own buffer
    (``recorder.aux``), so the summary tables see duration events only."""

    __slots__ = ("name", "ph", "ts_ns", "id", "tid", "category", "args")

    def __init__(self, name, ph, ts_ns, id, tid, category, args):
        self.name = name
        self.ph = ph
        self.ts_ns = ts_ns
        self.id = id
        self.tid = tid
        self.category = category
        self.args = args


class EventRecorder:
    """The event buffers and the enabled flag every instrument checks
    first: recording is off until a profiler window opens."""

    def __init__(self):
        self.events: list[HostEvent] = []
        self.aux: list[TraceEvent] = []
        self.enabled = False
        #: bumped by every clear(): a lane 'b' recorded in an earlier
        #: generation is gone from the buffer, so lane owners (the serving
        #: engine's per-request spans) key their open lanes on it
        self.generation = 0
        self._lock = threading.Lock()

    def clear(self):
        with self._lock:
            self.events = []
            self.aux = []
            self.generation += 1

    def record(self, name, start_ns, end_ns, category="op"):
        if not self.enabled:
            return
        ev = HostEvent(name, start_ns, end_ns, threading.get_ident(),
                       category)
        with self._lock:
            self.events.append(ev)

    def record_raw(self, name, ph, *, ts_ns=None, id=None, category="trace",
                   args=None):
        """Append one non-duration event (see :class:`TraceEvent`); a
        no-op while disabled, like :meth:`record`."""
        if not self.enabled:
            return
        ev = TraceEvent(name, ph, now_ns() if ts_ns is None else ts_ns,
                        id, threading.get_ident(), category, args)
        with self._lock:
            self.aux.append(ev)


recorder = EventRecorder()


def now_ns() -> int:
    """The recorder's clock (``time.perf_counter_ns``), shared with
    ``observability.monotonic``."""
    return time.perf_counter_ns()


__all__ = ["HostEvent", "TraceEvent", "EventRecorder", "recorder", "now_ns"]
