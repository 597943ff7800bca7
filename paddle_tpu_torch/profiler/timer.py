"""Throughput timer — port of ``paddle_tpu/profiler/timer.py``.

Per-step wall time split into ``reader_cost`` (data loading) and
``batch_cost`` (the whole step), with window averages and ``ips`` (items
a second). A train or serving loop drives it through
``benchmark().begin()`` / ``step()`` / ``end()``; the profiler facade
begins and ends it with its windows.
"""
from __future__ import annotations

import time


class _Averager:
    """Running mean over the current logging window (timer.py:51)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0

    def record(self, v: float, num: int = 1):
        self._total += v
        self._count += num

    def get_average(self) -> float:
        if self._count == 0:
            return 0.0
        return self._total / self._count

    @property
    def total(self) -> float:
        return self._total


class TimeAverager(_Averager):
    pass


class Benchmark:
    """reader_cost / batch_cost / ips accounting (timer.py:62-148).

    ``begin()`` starts a window; ``step(num_samples)`` closes one iteration;
    ``step_info()`` formats the averages and resets the window (the reference
    resets per log interval).
    """

    def __init__(self):
        self.reader = TimeAverager()
        self.batch = TimeAverager()
        self.ips = TimeAverager()
        self._begin_t = None
        self._reader_t = None
        self._step_t = None
        self.num_steps = 0
        self.running = False

    # -- lifecycle --
    def begin(self):
        self.running = True
        now = time.perf_counter()
        self._begin_t = now
        self._step_t = now
        self._reader_t = now

    def before_reader(self):
        self._reader_t = time.perf_counter()

    def after_reader(self):
        if self._reader_t is not None and self.running:
            self.reader.record(time.perf_counter() - self._reader_t)

    def step(self, num_samples: int | None = None):
        if not self.running:
            return
        now = time.perf_counter()
        cost = now - self._step_t
        self.batch.record(cost)
        if num_samples:
            self.ips.record(num_samples, 1)
        self.num_steps += 1
        self._step_t = now
        self._reader_t = now

    def end(self):
        self.running = False

    # -- reporting --
    def speed(self) -> float:
        """items/sec over the current window (0 if no samples recorded)."""
        bt = self.batch.total
        if bt <= 0:
            return 0.0
        return self.ips.total / bt

    def step_info(self, unit=None) -> str:
        reader_avg = self.reader.get_average()
        batch_avg = self.batch.get_average()
        msg = f" avg_reader_cost: {reader_avg:.5f} sec, avg_batch_cost: {batch_avg:.5f} sec"
        if self.ips.total > 0:
            unit = unit or "samples"
            msg += f", avg_ips: {self.speed():.5f} {unit}/sec"
        self.reader.reset()
        self.batch.reset()
        self.ips.reset()
        return msg


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    """The global benchmark timer (reference: paddle.utils hooked Benchmark)."""
    return _benchmark
