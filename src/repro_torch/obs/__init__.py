"""Observability: the span tracer and the metrics registry.

  obs.trace     - ring-buffered span tracer, Chrome trace-event JSON export
                  (opens in Perfetto); request-lifecycle spans, decode-round
                  pipeline spans, COW/evict/preempt instant events
  obs.metrics   - named counters/gauges/histograms, JSON + Prometheus text
                  export, and the one percentile/latency_report
                  implementation every layer shares

``REPRO_TELEMETRY=0`` turns both into module-level null objects with no
per-call branching on hot paths.
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (
    NULL_REGISTRY,
    MetricsRegistry,
    default_registry,
    latency_report,
    new_registry,
    percentile,
)
from repro_torch.obs.trace import NULL_TRACER, Tracer, get_tracer

__all__ = [
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NULL_TRACER",
    "Tracer",
    "default_registry",
    "enabled",
    "get_tracer",
    "latency_report",
    "metrics",
    "new_registry",
    "percentile",
    "reset",
    "set_enabled",
    "trace",
]


def enabled() -> bool:
    """True when BOTH the tracer and the registry are live."""
    return trace.enabled() and metrics.metrics_enabled()


def set_enabled(on: bool) -> None:
    """Flip tracing and metrics together (the runtime analogue of
    ``REPRO_TELEMETRY``; `core.autotune.set_telemetry` is the third,
    independent switch for the depth-feedback store)."""
    trace.set_tracing(on)
    metrics.set_metrics(on)


def reset() -> None:
    """Re-resolve both subsystems from the environment with empty state."""
    trace.reset()
    metrics.reset()
