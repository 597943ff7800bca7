"""Structured metrics registry — labeled Counter / Gauge / Histogram;
port of ``paddle_tpu/observability/metrics.py``.

The small instrument registry the serving stack feeds
(``inference/serving.py`` step, sync, TTFT and resilience accounting,
``inference/kv_cache.py`` pool and host-tier occupancy) and the training
step (``models/gpt_spmd.py``):

- an **instrument family** is created once per registry (idempotent by
  name) with a label schema and help text; ``labels(**kv)`` returns the
  cached child for one label assignment;
- a **child** mutates under the registry lock (the predictor and a poller
  thread may touch one counter);
- the **disabled path** is one shared-flag check and a return: no lock, no
  allocation. ``ServingPredictor`` and ``KVCacheManager`` refuse a
  disabled registry (their counters back their read surface); the
  library-wide :data:`default_registry` (the training step's
  ``train_steps`` / ``train_dispatch_seconds``) is OFF by default and
  turned on by :func:`enable_metrics`;
- ``snapshot()`` / ``snapshot_flat(prefix)`` export the values; the flat
  form rejects non-finite numbers, and :func:`merge_snapshots` joins flat
  snapshots whose shared keys agree.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "enable_metrics", "disable_metrics", "metrics_enabled",
    "merge_snapshots",
]

#: default histogram bucket upper bounds (seconds-ish scale; callers
#: measuring ms pass their own)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


def _label_key(schema, kv):
    """The child cache key for one label assignment, schema order."""
    try:
        return tuple(kv[name] for name in schema)
    except KeyError as e:
        raise ValueError(
            f"missing label {e.args[0]!r}; schema is {tuple(schema)}") from e


class _Child:
    """Base of one instrument child: shares the registry's enabled flag
    (a one-element list, so enable/disable flips every instrument without
    touching them) and its mutation lock."""

    __slots__ = ("_on", "_lock")

    def __init__(self, on, lock):
        self._on = on
        self._lock = lock


class Counter(_Child):
    """Monotonically-increasing value (float-valued: duration counters
    accumulate seconds)."""

    __slots__ = ("_value",)

    def __init__(self, on, lock):
        super().__init__(on, lock)
        self._value = 0.0

    def inc(self, n=1) -> None:
        # validate BEFORE the enabled check: a negative-delta bug must
        # surface in CI (registry off) too, not first in production
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        if not self._on[0]:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Child):
    """Point-in-time value (pool occupancy, ring depth)."""

    __slots__ = ("_value",)

    def __init__(self, on, lock):
        super().__init__(on, lock)
        self._value = 0.0

    def set(self, v) -> None:
        if not self._on[0]:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n=1) -> None:
        if not self._on[0]:
            return
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Child):
    """Bounded-bucket histogram: ``observe(v)`` increments the ONE
    bucket whose range contains v (per-bucket storage, NOT Prometheus
    cumulative le-buckets — an exporter would have to prefix-sum), plus
    count/sum. Quantile estimates interpolate across the buckets — good
    enough for the bench trend lines this feeds (exact percentiles stay
    the benchmark's job)."""

    __slots__ = ("_bounds", "_counts", "_count", "_sum")

    def __init__(self, on, lock, bounds):
        super().__init__(on, lock)
        self._bounds = tuple(float(b) for b in bounds)
        if list(self._bounds) != sorted(self._bounds) or not self._bounds:
            raise ValueError(f"bucket bounds must be sorted, non-empty: "
                             f"{bounds}")
        self._counts = [0] * (len(self._bounds) + 1)   # +inf overflow
        self._count = 0
        self._sum = 0.0

    def observe(self, v) -> None:
        if not self._on[0]:
            return
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
        q = min(max(float(q), 0.0), 1.0)
        rank = q * self._count
        seen = 0
        lo = 0.0
        for i, b in enumerate(self._bounds):
            nxt = seen + self._counts[i]
            if nxt >= rank and self._counts[i]:
                frac = (rank - seen) / self._counts[i]
                return lo + frac * (b - lo)
            seen = nxt
            lo = b
        return self._bounds[-1]     # overflow bucket: clamp to last bound


class _Family:
    """One named instrument family with a label schema; ``labels(**kv)``
    returns (and caches) the child for a concrete assignment. A family
    declared with no labels proxies straight to its single default child,
    so ``reg.counter("steps").inc()`` works without a ``labels()`` hop."""

    def __init__(self, registry, name, kind, help, labelnames, make):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._registry = registry
        self._make = make
        self._children: dict[tuple, _Child] = {}
        self._default = None if self.labelnames else self._bind(())

    def _bind(self, key):
        child = self._children.get(key)
        if child is None:
            with self._registry._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make()
                    self._children[key] = child
        return child

    def labels(self, **kv) -> _Child:
        if not self.labelnames:
            raise ValueError(f"{self.name} declares no labels")
        return self._bind(_label_key(self.labelnames, kv))

    # -- no-label proxying --------------------------------------------------
    def _only(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call .labels()")
        return self._default

    def inc(self, n=1):
        self._only().inc(n)

    def set(self, v):
        self._only().set(v)

    def dec(self, n=1):
        self._only().dec(n)

    def observe(self, v):
        self._only().observe(v)

    #: child reads that pass through an unlabeled family
    _CHILD_ATTRS = ("value", "count", "sum", "quantile")

    def __getattr__(self, attr):
        # only the known child reads delegate, and only for unlabeled
        # families; everything else is a plain AttributeError so
        # hasattr()/getattr(..., default) keep their protocol (dunder
        # guard: __getattr__ must not touch self during __init__)
        if not attr.startswith("_") and attr in self._CHILD_ATTRS \
                and self._default is not None:
            return getattr(self._default, attr)
        raise AttributeError(
            f"family {self.name!r} has no attribute {attr!r}"
            + (f" (labeled {self.labelnames}; call .labels())"
               if attr in self._CHILD_ATTRS else ""))

    def items(self):
        """(label_suffix, child) pairs; '' for the unlabeled default.
        Snapshots the child table under the registry lock — a concurrent
        first-seen ``labels()`` insert (a poller thread) must not
        blow up a snapshot iteration."""
        with self._registry._lock:
            children = sorted(self._children.items())
        for key, child in children:
            if self.labelnames:
                suffix = "{" + ",".join(
                    f"{n}={v}" for n, v in zip(self.labelnames, key)) + "}"
            else:
                suffix = ""
            yield suffix, child


class MetricsRegistry:
    """Owns instrument families + the shared enabled flag and lock.

    ``enabled=False`` builds the registry in the near-zero-cost disabled
    state: instruments exist (callers keep unconditional references) but
    every mutation is one flag check. ``enable()``/``disable()`` flip all
    of them at once.
    """

    def __init__(self, enabled: bool = True):
        self._on = [bool(enabled)]
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -- lifecycle ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._on[0]

    def enable(self) -> None:
        self._on[0] = True

    def disable(self) -> None:
        self._on[0] = False

    def reset(self) -> None:
        """Zero every child in place (references stay valid). The lock is
        taken per snapshot/mutation, never held across ``items()`` (which
        locks internally)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for _, child in fam.items():
                with self._lock:
                    if isinstance(child, Histogram):
                        child._counts = [0] * (len(child._bounds) + 1)
                        child._count = 0
                        child._sum = 0.0
                    else:
                        child._value = 0.0

    # -- families -----------------------------------------------------------
    def _family(self, name, kind, help, labels, make):
        fam = self._families.get(name)
        if fam is None:
            # construct OUTSIDE the lock (an unlabeled family binds its
            # default child, which takes the registry lock) and publish
            # with setdefault — a racing thread's duplicate is dropped
            fam = _Family(self, name, kind, help, labels, make)
            with self._lock:
                fam = self._families.setdefault(name, fam)
        if fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}"
                f"{fam.labelnames}, not {kind}{tuple(labels)}")
        return fam

    def counter(self, name, help="", labels=()) -> _Family:
        return self._family(name, "counter", help, labels,
                            lambda: Counter(self._on, self._lock))

    def gauge(self, name, help="", labels=()) -> _Family:
        return self._family(name, "gauge", help, labels,
                            lambda: Gauge(self._on, self._lock))

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> _Family:
        return self._family(
            name, "histogram", help, labels,
            lambda: Histogram(self._on, self._lock, buckets))

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured export: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {"count", "sum", "p50", "p99"}}}`` with
        labeled children keyed ``name{a=b}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        # snapshot the family table under the lock — a poller thread must
        # not crash on a concurrent first-seen registration (lazy
        # counter() calls)
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            for suffix, child in fam.items():
                key = name + suffix
                if fam.kind == "counter":
                    out["counters"][key] = child.value
                elif fam.kind == "gauge":
                    out["gauges"][key] = child.value
                else:
                    out["histograms"][key] = {
                        "count": child.count, "sum": child.sum,
                        "p50": child.quantile(0.5),
                        "p99": child.quantile(0.99),
                    }
        return out

    def snapshot_flat(self, prefix: str = "") -> dict[str, float]:
        """Flat ``{key: finite number}`` export, each key led by
        ``prefix`` (histograms expand to ``_count`` / ``_sum`` / ``_p50`` /
        ``_p99``); a non-finite value raises."""
        flat: dict[str, float] = {}
        snap = self.snapshot()
        for key, v in snap["counters"].items():
            flat[prefix + key] = v
        for key, v in snap["gauges"].items():
            flat[prefix + key] = v
        for key, h in snap["histograms"].items():
            flat[prefix + key + "_count"] = h["count"]
            flat[prefix + key + "_sum"] = h["sum"]
            flat[prefix + key + "_p50"] = h["p50"]
            flat[prefix + key + "_p99"] = h["p99"]
        # the schema contract is finite numbers; a NaN observed into a
        # histogram sum must fail HERE, not two rounds later in a diff
        for k, v in flat.items():
            if not math.isfinite(v):
                raise ValueError(f"non-finite telemetry value {k}={v!r}")
        return flat


def merge_snapshots(*flats: dict) -> dict[str, float]:
    """Merge flat snapshots; duplicate keys must agree (two registries
    exporting the same key with different values is a wiring bug)."""
    out: dict[str, float] = {}
    for flat in flats:
        for k, v in flat.items():
            if k in out and out[k] != v:
                raise ValueError(f"conflicting telemetry key {k!r}: "
                                 f"{out[k]!r} vs {v!r}")
            out[k] = v
    return out


#: library-wide instruments (the train step) feed this
#: registry; OFF by default so an uninstrumented run pays one flag check
default_registry = MetricsRegistry(enabled=False)


def enable_metrics() -> None:
    default_registry.enable()


def disable_metrics() -> None:
    default_registry.disable()


def metrics_enabled() -> bool:
    return default_registry.enabled
