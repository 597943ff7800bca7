"""Runtime telemetry of the port — ``paddle_tpu/observability`` ported.

- :mod:`.metrics` — labeled Counter / Gauge / Histogram families with a
  near-zero-cost disabled path and ``snapshot()`` / ``snapshot_flat()``
  export (the serving predictor's ``telemetry()``).
- :mod:`.tracing` — host spans, per-request async lanes and counter
  tracks recorded into the profiler's event buffer and exported by
  ``profiler.export_chrome_tracing``; ``monotonic()`` / ``monotonic_ns()``
  are the timing clock of ``inference/``.

With no profiler window open and ``default_registry`` off, every
instrument call is one flag check and a return. (The fleet router's
instruments, ``FleetInstruments``, come with the fleet slice.)
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry, disable_metrics, enable_metrics,
                      merge_snapshots, metrics_enabled)
from .tracing import (REQUEST_SPAN, counter_event, device_annotation,
                      monotonic, monotonic_ns, request_begin, request_end,
                      request_event, set_device_tracing, span,
                      tracing_active)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "enable_metrics", "disable_metrics", "metrics_enabled",
    "merge_snapshots", "span", "request_begin", "request_event",
    "request_end", "counter_event", "tracing_active", "monotonic",
    "monotonic_ns", "device_annotation", "set_device_tracing",
    "REQUEST_SPAN",
]
