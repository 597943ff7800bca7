from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]
