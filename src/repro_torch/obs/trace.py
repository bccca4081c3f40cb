"""Span tracer: ring-buffered structured tracing with Perfetto-ready export.

Every layer of the stack feeds one process-wide tracer (`get_tracer()`):
the serving engine emits request-lifecycle spans (admit -> prefix lookup ->
prefill chunks -> decode rounds -> finish, with instant events for COW
forks, cache evictions, and preemptions), the engine emits one
span per launched pipeline carrying depth / n_tiles / context-bytes
attributes, and the dense drive loop in `launch.serve` emits per-step round
spans. `export(path)` writes Chrome trace-event JSON that opens directly in
Perfetto (https://ui.perfetto.dev) or chrome://tracing.

Design constraints:

* zero dependencies - events are plain dicts in a `collections.deque` ring
  (default 65536 events; the oldest fall off, `dropped` counts them), so a
  long-lived serving process never grows without bound.
* true no-op when disabled - ``REPRO_TELEMETRY=0`` (the same switch
  `core.autotune` honours) swaps the module-level singleton for
  `NULL_TRACER`, whose methods do nothing and whose `span()` returns one
  shared context-manager instance. Hot loops fetch the tracer once and call
  through it unconditionally: the disabled path has no per-call branching
  and allocates no event objects (asserted in tests/test_obs.py).

Event vocabulary (Chrome trace-event phases):

  "X" complete span   - span(name, ...) context manager / complete(...)
  "i" instant event   - instant(name, ...); thread-scoped ("s": "t").
                        The serving failure model emits its own
                        vocabulary here: "shed", "cancel", "stall",
                        "step_fault", "quarantine", "latency_spike", and
                        "run_stalled", alongside the original "admit" /
                        "cow_fork" / "cache_evict" / "preempt" events.
  "b"/"e" async pair  - begin_async/end_async(name, id): spans that outlive
                        one call frame (a request's whole lifetime)

Tracks: `pid` is always 1 (one process); `tid` picks the Perfetto track —
`TID_ENGINE` (0) for scheduler/engine rounds, `TID_KERNEL` (1) for
coroutine pipelines, `TID_REQUEST_BASE + rid` for per-request lifecycle
spans so each request renders as its own row.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional

__all__ = [
    "NULL_TRACER",
    "TID_ENGINE",
    "TID_KERNEL",
    "TID_REQUEST_BASE",
    "Tracer",
    "enabled",
    "get_tracer",
    "reset",
    "set_tracing",
]

TELEMETRY_ENV = "REPRO_TELEMETRY"
DEFAULT_CAPACITY = 65536
PID = 1

TID_ENGINE = 0        # scheduler rounds, decode rounds, prefill chunks
TID_KERNEL = 1        # coroutine pipelines (engine decode rounds)
TID_REQUEST_BASE = 64  # request rid r renders on track TID_REQUEST_BASE + r


class _Span:
    """Context manager emitting one "X" complete event on exit."""

    __slots__ = ("_tracer", "_name", "_tid", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc) -> None:
        t = self._tracer
        t._emit({"name": self._name, "cat": "repro", "ph": "X",
                 "ts": self._t0, "dur": t.now_us() - self._t0,
                 "pid": PID, "tid": self._tid,
                 "args": self._args or {}})


class Tracer:
    """Ring-buffered event collector with Chrome trace-event export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------------- clock

    def now_us(self) -> float:
        """Microseconds since this tracer's epoch (Chrome `ts` unit)."""
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    # ------------------------------------------------------------ record

    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def span(self, name: str, tid: int = TID_ENGINE, **args) -> _Span:
        """``with tracer.span("decode_round", width=8): ...`` — one "X"
        complete event covering the block, attributes in `args`."""
        return _Span(self, name, tid, args or None)

    def complete(self, name: str, start_us: float, dur_us: float,
                 tid: int = TID_ENGINE, **args) -> None:
        """Emit an "X" span with explicit timing (for already-measured
        intervals: the decode-round wall clock the engine observed)."""
        self._emit({"name": name, "cat": "repro", "ph": "X",
                    "ts": start_us, "dur": max(dur_us, 0.0),
                    "pid": PID, "tid": tid, "args": args})

    def instant(self, name: str, tid: int = TID_ENGINE, **args) -> None:
        """Thread-scoped instant event (COW fork, eviction, preemption)."""
        self._emit({"name": name, "cat": "repro", "ph": "i", "s": "t",
                    "ts": self.now_us(), "pid": PID, "tid": tid,
                    "args": args})

    def begin_async(self, name: str, aid: int, tid: int = TID_ENGINE,
                    **args) -> None:
        """Open an async span (paired by (`name`, `aid`) with end_async)."""
        self._emit({"name": name, "cat": "repro", "ph": "b", "id": int(aid),
                    "ts": self.now_us(), "pid": PID, "tid": tid,
                    "args": args})

    def end_async(self, name: str, aid: int, tid: int = TID_ENGINE,
                  **args) -> None:
        self._emit({"name": name, "cat": "repro", "ph": "e", "id": int(aid),
                    "ts": self.now_us(), "pid": PID, "tid": tid,
                    "args": args})

    # ------------------------------------------------------------ export

    def to_dict(self) -> Dict[str, Any]:
        """The Chrome trace-event container Perfetto opens directly."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace",
                              "dropped_events": self.dropped}}

    def export(self, path: str) -> str:
        """Write the trace as JSON; returns `path`."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0


class _NullSpan:
    """The one shared do-nothing context manager the null tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


class NullTracer:
    """API-compatible no-op: every method returns immediately, `span()`
    returns one module-lifetime `_NullSpan`, and there is no event storage
    at all — the ``REPRO_TELEMETRY=0`` fast path."""

    __slots__ = ()

    events: tuple = ()
    dropped: int = 0

    _SPAN = _NullSpan()

    def now_us(self) -> float:
        return 0.0

    def span(self, name: str, tid: int = TID_ENGINE, **args) -> _NullSpan:
        return self._SPAN

    def complete(self, name: str, start_us: float, dur_us: float,
                 tid: int = TID_ENGINE, **args) -> None:
        pass

    def instant(self, name: str, tid: int = TID_ENGINE, **args) -> None:
        pass

    def begin_async(self, name: str, aid: int, tid: int = TID_ENGINE,
                    **args) -> None:
        pass

    def end_async(self, name: str, aid: int, tid: int = TID_ENGINE,
                  **args) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace",
                              "dropped_events": 0}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()


def _env_enabled() -> bool:
    return os.environ.get(TELEMETRY_ENV, "1") not in ("0", "off")


_tracer: Any = Tracer() if _env_enabled() else NULL_TRACER


def get_tracer():
    """The process-wide tracer (or `NULL_TRACER` when tracing is off).
    Fetch once per scope and call through it — no enabled() checks needed
    on the hot path."""
    return _tracer


def enabled() -> bool:
    return _tracer is not NULL_TRACER


def set_tracing(on: bool) -> None:
    """Process-wide switch. Turning tracing on installs a FRESH ring (the
    previous tracer's events are gone); turning it off installs the null
    singleton so in-flight references degrade to no-ops on their next call."""
    global _tracer
    if on:
        if _tracer is NULL_TRACER:
            _tracer = Tracer()
    else:
        _tracer = NULL_TRACER


def reset() -> None:
    """Re-resolve from ``REPRO_TELEMETRY`` with an empty ring (the test
    fixture's isolation hook)."""
    global _tracer
    _tracer = Tracer() if _env_enabled() else NULL_TRACER
