"""Metrics registry: named counters, gauges, and fixed-bucket histograms.

The other half of the observability layer (`obs/trace.py` is the
span side): one `MetricsRegistry` holds every named metric a component
reports, exports a JSON `snapshot()` and a Prometheus text exposition
(`prometheus_text()`), and hosts read-only *views* — callables folded into
the snapshot at read time (e.g. `core.autotune.telemetry_summary` appears
under the default registry's ``autotune`` view, so one snapshot covers both
the engine's counters and the kernel feedback loop).

This module is also the single home of percentile math: `percentile()` and
`latency_report()` replace the copies that used to live in
`core.autotune._percentile` and `serve.engine.latency_report` — every
p50/p99 the package reports comes from here.

Disabled path: like the tracer, ``REPRO_TELEMETRY=0`` swaps the default
registry for `NULL_REGISTRY`, and `new_registry()` hands out the same null
object — its counters/gauges/histograms are shared no-op singletons, so an
instrumented hot loop costs a method call that immediately returns, with no
per-call branching and no sample storage.

Histograms keep (a) fixed-bucket counts for the Prometheus export and
(b) a bounded sample ring (`max_samples`, default 4096 — same spirit as
`core.autotune.MAX_SAMPLES_PER_KERNEL`) from which exact-rank percentiles
are computed, so `p50/p99` match what the old ad-hoc lists reported instead
of being bucket-quantised.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "default_registry",
    "latency_report",
    "metrics_enabled",
    "new_registry",
    "percentile",
    "reset",
    "set_metrics",
]

TELEMETRY_ENV = "REPRO_TELEMETRY"

# powers-of-~3 from 100us to 3s: wide enough for interpret-mode rounds and
# tight enough that on-device token latencies land in distinct buckets
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0)

MAX_SAMPLES = 4096


# ------------------------------------------------------------- percentiles


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over raw samples (0 on empty input) — the
    ONE implementation every p50/p99 in the repo routes through."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(int(q * len(ys)), len(ys) - 1)]


def latency_report(samples_s: Sequence[float]) -> Dict[str, float]:
    """The one latency-stats dict every serving path reports: p50/p99/mean
    of a per-token latency sample list, in milliseconds. Shared by the
    paged engine (`stats`) and both engines in `launch.serve`."""
    if not samples_s:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
    return {
        "p50_ms": round(percentile(samples_s, 0.50) * 1e3, 3),
        "p99_ms": round(percentile(samples_s, 0.99) * 1e3, 3),
        "mean_ms": round(sum(samples_s) / len(samples_s) * 1e3, 3),
    }


# ----------------------------------------------------------------- metrics


class Counter:
    """Monotonically increasing value (float so second-accumulators fit)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram plus a bounded raw-sample ring.

    `samples` is a plain list callers may read (and clear — the fairness
    test in tests/test_prefix_cache.py does); bucket counts and
    `count`/`sum` are cumulative and survive such clears.
    """

    __slots__ = ("name", "buckets", "bucket_counts", "count", "sum",
                 "samples", "max_samples")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                 max_samples: int = MAX_SAMPLES):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.samples: List[float] = []
        self.max_samples = int(max_samples)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        i = 0
        for i, edge in enumerate(self.buckets):
            if x <= edge:
                break
        else:
            i = len(self.buckets)
        self.bucket_counts[i] += 1
        xs = self.samples
        xs.append(x)
        if len(xs) > self.max_samples:
            del xs[: len(xs) - self.max_samples]

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def report(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "p50": round(self.percentile(0.50), 6),
            "p99": round(self.percentile(0.99), 6),
        }


class MetricsRegistry:
    """Named metrics + read-time views, with JSON and Prometheus export."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._views: Dict[str, Callable[[], Any]] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  ) -> Histogram:
        return self._get(name, Histogram, buckets)

    def view(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a callable whose result is folded into `snapshot()`
        under `name` at read time (a registry *view*, not a stored value)."""
        self._views[name] = fn

    # ------------------------------------------------------------ export

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.report()
        for name, fn in sorted(self._views.items()):
            out[name] = fn()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (metric names '.'->'_')."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            pname = name.replace(".", "_").replace("-", "_")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value:g}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                acc = 0
                for edge, n in zip(m.buckets, m.bucket_counts):
                    acc += n
                    lines.append(f'{pname}_bucket{{le="{edge:g}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.sum:g}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        self._metrics.clear()
        self._views.clear()


# --------------------------------------------------------------- null path


class _NullCounter:
    __slots__ = ()
    name = "null"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = "null"
    value = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = "null"
    buckets: tuple = ()
    bucket_counts: list = []
    count = 0
    sum = 0.0
    samples: list = []          # shared; observe() never appends

    def observe(self, x: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def report(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "p50": 0.0, "p99": 0.0}


class NullRegistry:
    """No-op registry: shared metric singletons, empty exports."""

    __slots__ = ()

    _COUNTER = _NullCounter()
    _GAUGE = _NullGauge()
    _HISTOGRAM = _NullHistogram()

    def counter(self, name: str) -> _NullCounter:
        return self._COUNTER

    def gauge(self, name: str) -> _NullGauge:
        return self._GAUGE

    def histogram(self, name: str, buckets: Sequence[float] = (),
                  ) -> _NullHistogram:
        return self._HISTOGRAM

    def view(self, name: str, fn: Callable[[], Any]) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def prometheus_text(self) -> str:
        return ""

    def clear(self) -> None:
        pass


NULL_REGISTRY = NullRegistry()


def _env_enabled() -> bool:
    return os.environ.get(TELEMETRY_ENV, "1") not in ("0", "off")


def _autotune_view() -> Dict[str, Any]:
    from repro_torch.core import autotune  # local: autotune imports this module

    return autotune.telemetry_summary()


def _substrate_view() -> Dict[str, Any]:
    from repro_torch.core import guard  # local: guard imports this module

    return guard.stats()


def _make_default() -> Any:
    if not _env_enabled():
        return NULL_REGISTRY
    reg = MetricsRegistry()
    reg.view("autotune", _autotune_view)
    reg.view("substrate", _substrate_view)
    return reg


_default: Any = _make_default()
_enabled: bool = _env_enabled()


def default_registry():
    """The process-wide registry (kernel_bench's `--json` metrics snapshot
    reads it; the autotune telemetry view lives here)."""
    return _default


def new_registry(enabled: Optional[bool] = None):
    """A fresh registry for a component instance (one per serving engine,
    so two engines in one process never mix counters) — or the shared
    `NULL_REGISTRY` when metrics are off."""
    on = _enabled if enabled is None else enabled
    return MetricsRegistry() if on else NULL_REGISTRY


def metrics_enabled() -> bool:
    return _enabled


def set_metrics(on: bool) -> None:
    """Process-wide switch; turning on installs a fresh default registry."""
    global _default, _enabled
    _enabled = bool(on)
    if on:
        if _default is NULL_REGISTRY:
            reg = MetricsRegistry()
            reg.view("autotune", _autotune_view)
            reg.view("substrate", _substrate_view)
            _default = reg
    else:
        _default = NULL_REGISTRY


def reset() -> None:
    """Re-resolve from ``REPRO_TELEMETRY`` with empty state (test isolation)."""
    global _default, _enabled
    _default = _make_default()
    _enabled = _env_enabled()
