"""Prometheus-compatible metrics (`weed/stats/metrics.go:33-400`) plus
request tracing / kernel profiling (stats.trace)."""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    parse_exposition,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "default_registry",
    "parse_exposition",
]
