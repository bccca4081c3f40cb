"""Fault tolerance: restart supervision and straggler detection (the
reference package's ``runtime/fault_tolerance.py``).

Scale-out posture (DESIGN.md §3.1): at 1000+ nodes the unit of recovery is
the *job step*, not the process — the data pipeline is a pure function of the
step counter and checkpoints are atomic, so any failure maps to "restore the
last checkpoint, continue".

  * run_with_restarts  — supervisor: retries the step loop after transient
    failures, restoring state via the caller's restore_fn. Kernel-substrate
    failures (`core.guard.SubstrateError`, DESIGN.md §2.7) are retriable by
    construction — they subclass RuntimeError — and their kernel context
    (kernel / machine / depth) is recorded in `RestartReport.failures` so a
    post-mortem can tell a dying node from a bad kernel config. Note the
    supervisor is the *outer* ring: inside a step, `guarded_call` already
    walked its depth ladder; a SubstrateError reaching here means strict
    mode or a failure at depth 1.
  * StragglerMonitor   — per-step latency tracker flagging outliers
    (> threshold x running median); the launcher logs and, in a real
    deployment, triggers hot-spare swap / re-shard for persistent offenders.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Deque, List, Tuple

from repro_torch.core.guard import SubstrateError


@dataclasses.dataclass
class RestartReport:
    restarts: int
    failures: List[str]
    completed: bool


def _describe_failure(e: BaseException) -> str:
    """One log line per failure; SubstrateError carries kernel context."""
    if isinstance(e, SubstrateError):
        ctx = f"kernel={e.kernel} machine={e.machine}"
        if e.depth is not None:
            ctx += f" depth={e.depth}"
        return f"{type(e).__name__}[{ctx}]: {e}"
    return f"{type(e).__name__}: {e}"


def run_with_restarts(step_loop: Callable[[], None], *,
                      restore_fn: Callable[[], None],
                      max_restarts: int = 3,
                      retriable=(RuntimeError, OSError)) -> RestartReport:
    """Supervise `step_loop`; on retriable failure, restore and re-enter."""
    failures: List[str] = []
    for attempt in range(max_restarts + 1):
        try:
            step_loop()
            return RestartReport(attempt, failures, True)
        except retriable as e:  # noqa: PERF203
            failures.append(_describe_failure(e))
            if attempt == max_restarts:
                break
            restore_fn()
    return RestartReport(max_restarts, failures, False)


class StragglerMonitor:
    """Flags steps (or, fed per-host timings, hosts) slower than
    `threshold` x running median — the paper's variable-latency concern at
    cluster scale; the mitigation hook is pluggable."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.samples: Deque[float] = collections.deque(maxlen=window)
        self.flagged: List[Tuple[int, float]] = []
        self._step = 0

    def record(self, duration_s: float) -> bool:
        """Returns True if this sample is a straggler."""
        self._step += 1
        is_straggler = False
        if len(self.samples) >= max(self.window // 4, 4):
            med = statistics.median(self.samples)
            if duration_s > self.threshold * med:
                self.flagged.append((self._step, duration_s))
                is_straggler = True
        self.samples.append(duration_s)
        return is_straggler

    def timed(self):
        return _Timer(self)


class _Timer:
    def __init__(self, mon: StragglerMonitor):
        self.mon = mon

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        self.straggler = self.mon.record(self.elapsed)
        return False
