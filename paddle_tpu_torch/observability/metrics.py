"""Structured metrics registry — labeled Counter / Gauge / Histogram.

The port's own copy of the ``Counter`` / ``Gauge`` / ``Histogram`` /
``MetricsRegistry`` parts of ``paddle_tpu/observability/metrics.py`` that
the KV cache manager and the serving predictor feed: an instrument family
is created once per registry (idempotent by name) with a label schema;
``labels(**kv)`` returns the cached child; children mutate under the
registry lock. ``snapshot_flat`` exports ``{key: finite number}``. (The
reference's disabled-registry mode is not copied: every port registry
is on.)
"""
from __future__ import annotations

import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class _Child:
    __slots__ = ("_lock",)

    def __init__(self, lock):
        self._lock = lock


class Counter(_Child):
    """Monotonically-increasing value (float-valued: duration counters
    accumulate seconds)."""

    __slots__ = ("_value",)

    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Child):
    """Point-in-time value (pool occupancy, running lanes)."""

    __slots__ = ("_value",)

    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Child):
    """Bounded-bucket histogram (one bucket per observation, plus count and
    sum) with a bucket-interpolated quantile estimate."""

    __slots__ = ("_bounds", "_counts", "_count", "_sum")

    def __init__(self, lock, bounds):
        super().__init__(lock)
        self._bounds = tuple(float(b) for b in bounds)
        if list(self._bounds) != sorted(self._bounds) or not self._bounds:
            raise ValueError(f"bucket bounds must be sorted, non-empty: "
                             f"{bounds}")
        self._counts = [0] * (len(self._bounds) + 1)   # +inf overflow
        self._count = 0
        self._sum = 0.0

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for b in self._bounds:
                if v <= b:
                    break
                i += 1
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 when empty)."""
        if not self._count:
            return 0.0
        rank = min(max(float(q), 0.0), 1.0) * self._count
        seen = 0
        lo = 0.0
        for i, b in enumerate(self._bounds):
            nxt = seen + self._counts[i]
            if nxt >= rank and self._counts[i]:
                return lo + (rank - seen) / self._counts[i] * (b - lo)
            seen = nxt
            lo = b
        return self._bounds[-1]


class _Family:
    """One named instrument family; an unlabeled family proxies its single
    child (``reg.counter("steps").inc()``)."""

    def __init__(self, registry, name, kind, labelnames, make):
        self.name = name
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._registry = registry
        self._make = make
        self._children: dict[tuple, _Child] = {}
        self._default = None if self.labelnames else self._bind(())

    def _bind(self, key):
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
        return child

    def labels(self, **kv) -> _Child:
        if not self.labelnames:
            raise ValueError(f"{self.name} declares no labels")
        try:
            key = tuple(kv[name] for name in self.labelnames)
        except KeyError as e:
            raise ValueError(f"missing label {e.args[0]!r}; schema is "
                             f"{self.labelnames}") from e
        return self._bind(key)

    def _only(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call .labels()")
        return self._default

    def inc(self, n=1):
        self._only().inc(n)

    def set(self, v):
        self._only().set(v)

    def observe(self, v):
        self._only().observe(v)

    def quantile(self, q):
        return self._only().quantile(q)

    @property
    def value(self):
        return self._only().value

    def items(self):
        """(label suffix, child) pairs; '' for the unlabeled child."""
        with self._registry._lock:
            children = sorted(self._children.items())
        for key, child in children:
            suffix = ("{" + ",".join(f"{n}={v}" for n, v in
                                     zip(self.labelnames, key)) + "}"
                      if self.labelnames else "")
            yield suffix, child


class MetricsRegistry:
    """Owns instrument families and the lock their children share."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _family(self, name, kind, labels, make):
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            fam = _Family(self, name, kind, labels, make)
            with self._lock:
                fam = self._families.setdefault(name, fam)
        if fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}"
                f"{fam.labelnames}, not {kind}{tuple(labels)}")
        return fam

    def counter(self, name, help="", labels=()) -> _Family:
        return self._family(name, "counter", labels,
                            lambda: Counter(self._lock))

    def gauge(self, name, help="", labels=()) -> _Family:
        return self._family(name, "gauge", labels,
                            lambda: Gauge(self._lock))

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> _Family:
        return self._family(name, "histogram", labels,
                            lambda: Histogram(self._lock, buckets))

    def snapshot_flat(self) -> dict[str, float]:
        """Flat ``{key: finite number}`` export; histograms expand to
        ``_count`` / ``_sum`` / ``_p50`` / ``_p99``."""
        flat: dict[str, float] = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            for suffix, child in fam.items():
                key = name + suffix
                if fam.kind == "histogram":
                    flat[key + "_count"] = child.count
                    flat[key + "_sum"] = child.sum
                    flat[key + "_p50"] = child.quantile(0.5)
                    flat[key + "_p99"] = child.quantile(0.99)
                else:
                    flat[key] = child.value
        for k, v in flat.items():
            if not math.isfinite(v):
                raise ValueError(f"non-finite telemetry value {k}={v!r}")
        return flat
