"""``RecordEvent`` host ranges — port of ``paddle_tpu/profiler/utils.py``."""
from __future__ import annotations

import functools
import json

from .record import now_ns, recorder

__all__ = ["RecordEvent", "load_profiler_result", "in_profiler_mode"]


def in_profiler_mode() -> bool:
    """True while a profiler window records."""
    return recorder.enabled


class RecordEvent:
    """A named host range: ``with RecordEvent("stage"): ...``, explicit
    ``begin()`` / ``end()``, or a decorator."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self.event_type = event_type
        self._start = None

    def begin(self):
        self._start = now_ns()

    def end(self):
        if self._start is not None:
            recorder.record(self.name, self._start, now_ns(), category="user")
            self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name or func.__name__):
                return func(*args, **kwargs)

        return wrapper


def load_profiler_result(filename: str):
    """An exported Chrome trace, back as its list of event dicts."""
    with open(filename) as f:
        data = json.load(f)
    return data.get("traceEvents", data)
