"""Host spans, per-request async lanes and counter tracks — port of
``paddle_tpu/observability/tracing.py``.

Thin wrappers over the profiler's one event buffer
(``profiler/record.py``), cheap on the hot path:

- :func:`span` — a named host range (``with span("pack_dispatch"): ...``),
  recorded as a Chrome ``X`` event while a profiler window records, and
  opening a ``torch.profiler.record_function`` range while a device
  capture is live (``set_device_tracing``), so the host range lines up
  with the kernels it launched. With no window open the call returns a
  shared no-op context manager: one flag check, no allocation.
- :func:`request_begin` / :func:`request_event` / :func:`request_end` —
  per-request async lanes (Chrome ``b`` / ``n`` / ``e`` matched by
  ``(category, id, name)``): one lane a request, admit to eos, across the
  scheduler rounds that interleave it.
- :func:`counter_event` — a Chrome counter track (``C``): the async
  engine's in-flight ring depth.
- :func:`monotonic` / :func:`monotonic_ns` — the timing clock of
  ``inference/`` (``time.perf_counter``, the recorder's clock), so the
  engine's durations, deadlines and TTFT and the trace share one clock.

``profiler.Profiler`` windows turn the recorder on, and
``export_chrome_tracing`` writes the spans, the lanes, the counter track
and (with the GPU target) the device kernels in one trace.
"""
from __future__ import annotations

import contextlib
import time

from ..profiler.record import now_ns, recorder

__all__ = [
    "span", "request_begin", "request_event", "request_end",
    "counter_event", "tracing_active", "monotonic", "monotonic_ns",
    "device_annotation", "set_device_tracing", "REQUEST_SPAN",
]

monotonic = time.perf_counter
monotonic_ns = time.perf_counter_ns


def tracing_active() -> bool:
    """True while a profiler window records (spans are recorded)."""
    return recorder.enabled


#: the shared no-op context manager of the disabled path (re-enterable)
_NULL = contextlib.nullcontext()

#: set by the profiler facade while a ``torch.profiler`` device capture
#: is live: spans pay for a ``record_function`` range only when a device
#: trace can use it
_DEVICE_TRACING = [False]


def set_device_tracing(active: bool) -> None:
    _DEVICE_TRACING[0] = bool(active)


def device_annotation(name: str):
    """A ``torch.profiler.record_function`` range while a device capture
    is live (the host range then sits over its kernels in the trace); the
    shared no-op otherwise."""
    if not _DEVICE_TRACING[0]:
        return _NULL
    import torch

    return torch.profiler.record_function(name)


class _Span:
    __slots__ = ("name", "category", "_start", "_ann")

    def __init__(self, name, category):
        self.name = name
        self.category = category
        self._start = None
        self._ann = None

    def __enter__(self):
        self._ann = device_annotation(self.name)
        self._ann.__enter__()
        self._start = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        if self._start is not None:
            recorder.record(self.name, self._start, end,
                            category=self.category)
            self._start = None
        ann, self._ann = self._ann, None
        if ann is not None:
            ann.__exit__(*exc)
        return False


def span(name: str, category: str = "serving"):
    """A named host range: one flag check and the shared no-op when no
    profiler window is open; a recorded ``X`` event (and, under a device
    capture, a ``record_function`` range) when one is."""
    if not recorder.enabled:
        return _NULL
    return _Span(name, category)


# -- per-request async lanes -------------------------------------------------

#: the async lane name every request span shares; Chrome matches b / n / e
#: on (category, id, name), so the id (req_id) keys the lane
REQUEST_SPAN = "request"
_REQ_CAT = "request"


def request_begin(req_id, args=None) -> bool:
    """Open one request's lane. Returns whether the begin was recorded:
    the caller gates the matching :func:`request_end` on it (an ``e``
    without its ``b`` renders as an unmatched phase)."""
    if not recorder.enabled:
        return False
    recorder.record_raw(REQUEST_SPAN, "b", id=req_id, category=_REQ_CAT,
                        args=args)
    return True


def request_event(req_id, name: str, args=None) -> None:
    """An instant on one request's lane (admit / prefill_chunk / decode /
    preempt / retry / spec_accept / first_token / eos ...)."""
    if not recorder.enabled:
        return
    recorder.record_raw(name, "n", id=req_id, category=_REQ_CAT, args=args)


def request_end(req_id, args=None) -> None:
    if not recorder.enabled:
        return
    recorder.record_raw(REQUEST_SPAN, "e", id=req_id, category=_REQ_CAT,
                        args=args)


def counter_event(name: str, value) -> None:
    """One sample on a Chrome counter track (``C``)."""
    if not recorder.enabled:
        return
    recorder.record_raw(name, "C", category="counter",
                        args={"value": float(value)})
