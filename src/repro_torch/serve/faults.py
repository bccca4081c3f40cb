"""Deterministic fault injection for the paged serving engine.

Disaggregated memory produces exactly the conditions a tidy benchmark never
does — pool exhaustion under bursty admission, reclaim that frees nothing
because every cold page is pinned, latency spikes on the far tier, and
mid-flight step failures. The robustness layer
makes every one of those survivable, and this module makes them
*reproducible*: a seeded `FaultInjector` whose hooks sit behind no-op
singletons in `KVPager`, `ContinuousBatchingScheduler`, and the engine's
round loop, so a chaos run replays the same fault schedule bit-for-bit.

Sites (each hook names one):

  pool_exhausted  - `KVPager._pop_free` raises `PoolExhausted` even though
                    a free block exists (a burst racing us to the pool)
  reclaim_refuse  - the engine's prefix-cache reclaim hook reports 0 pages
                    freed (every cold page pinned elsewhere)
  preempt_refuse  - `_preempt_one` declines to evict a victim (the victim
                    is mid-DMA / unpreemptable), so pressure propagates
  decode          - the batched decode round raises `InjectedFault`
  prefill         - one prefill chunk raises `InjectedFault`
  latency         - the round loop sleeps a spike before doing work
  kernel_compile  - a kernel-substrate attempt fails like a Mosaic compile
                    error (`core.guard` raises `KernelCompileError`)
  kernel_oom      - a kernel-substrate attempt fails RESOURCE_EXHAUSTED
                    (`KernelResourceError`) — exercises the depth ladder
  kernel_nan      - a successful attempt's output is poisoned non-finite so
                    the always-on scan must catch it (`KernelNumericsError`)

Determinism: every site draws from its **own** `numpy` Generator seeded by
``(seed, site_index)``, so whether one site fires never perturbs another —
the n-th decision at a site depends only on the seed and n. Two runs of the
same workload with the same injector config see the same schedule.

On a device mesh every rank runs its own engine and injector
(`serve/engine.py`). A site that fires on one rank and not another makes
the ranks plan different rounds, so each rank takes an injector of the
same seed and rates, except that the latency site may differ: a spike
only sleeps, and the one decision a rank's clock would take (a deadline)
the mesh takes from rank 0's clock. Its draws come from its own stream,
so the other sites fire alike whatever it does; but its fires count
towards `max_faults`, so with a cap the latency site must be alike too.

The default `NULL_INJECTOR` is inert: `fire` returns False without drawing,
`check` does nothing, `latency_spike` returns 0.0 — production paths pay
one method call, no branching at the call sites.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "DEFAULT_RATES",
    "FaultInjector",
    "InjectedFault",
    "NULL_INJECTOR",
    "SITES",
]

SITES: Tuple[str, ...] = (
    "pool_exhausted",
    "reclaim_refuse",
    "preempt_refuse",
    "decode",
    "prefill",
    "latency",
    # kernel-site streams: fired by the engine's pre-call
    # `guard.check_injected` hooks. Appended AFTER the older sites so the
    # (seed, site_index) rng streams of those sites — and therefore the
    # bit-for-bit replayability of older chaos schedules — survive.
    "kernel_compile",
    "kernel_oom",
    "kernel_nan",
)

# per-round / per-call firing probabilities of the stock chaos schedule —
# high enough that a 50-round smoke exercises every path, low enough that
# the workload still mostly completes (graceful degradation, not a wall)
DEFAULT_RATES: Dict[str, float] = {
    "pool_exhausted": 0.05,
    "reclaim_refuse": 0.10,
    "preempt_refuse": 0.05,
    "decode": 0.03,
    "prefill": 0.03,
    "latency": 0.05,
    "kernel_compile": 0.03,
    "kernel_oom": 0.02,
    "kernel_nan": 0.02,
}

LOG_CAPACITY = 1024


class InjectedFault(RuntimeError):
    """An exception the injector raised on purpose (site in the message)."""


class FaultInjector:
    """Seeded per-site fault schedule. One instance per engine/chaos run."""

    def __init__(self, seed: int = 0, *,
                 rates: Optional[Dict[str, float]] = None,
                 latency_spike_s: float = 2e-3,
                 max_faults: Optional[int] = None):
        unknown = set(rates or ()) - set(SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; "
                             f"valid: {SITES}")
        self.seed = int(seed)
        self.rates = dict(DEFAULT_RATES if rates is None else rates)
        self.latency_spike_s = float(latency_spike_s)
        self.max_faults = max_faults
        self.injected = 0
        self.by_site: Dict[str, int] = {}
        self.log: Deque[Tuple[str, Dict[str, Any]]] = deque(maxlen=LOG_CAPACITY)
        self._rngs = {s: np.random.default_rng([self.seed, i])
                      for i, s in enumerate(SITES)}

    @property
    def enabled(self) -> bool:
        return True

    def fire(self, site: str, **ctx) -> bool:
        """One deterministic draw at `site`; True means inject here."""
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        if self.max_faults is not None and self.injected >= self.max_faults:
            return False
        if self._rngs[site].random() >= rate:
            return False
        self.injected += 1
        self.by_site[site] = self.by_site.get(site, 0) + 1
        self.log.append((site, dict(ctx)))
        return True

    def check(self, site: str, **ctx) -> None:
        """Raise `InjectedFault` when the site fires (step-exception sites)."""
        if self.fire(site, **ctx):
            raise InjectedFault(
                f"injected fault at {site!r} (#{self.injected}, "
                f"seed={self.seed}, ctx={ctx})")

    def latency_spike(self, site: str = "latency") -> float:
        """Seconds to stall when the site fires, else 0.0. The magnitude is
        drawn from the same per-site stream (0.5x..1.5x the nominal)."""
        if not self.fire(site):
            return 0.0
        return self.latency_spike_s * (0.5 + self._rngs[site].random())

    def stats(self) -> Dict[str, Any]:
        return {"seed": self.seed, "injected": self.injected,
                "by_site": dict(self.by_site)}


class _NullInjector:
    """Inert stand-in: the always-on hooks cost one returning method call."""

    seed = None
    injected = 0
    by_site: Dict[str, int] = {}
    log: Tuple = ()
    enabled = False

    def fire(self, site: str, **ctx) -> bool:
        return False

    def check(self, site: str, **ctx) -> None:
        return None

    def latency_spike(self, site: str = "latency") -> float:
        return 0.0

    def stats(self) -> Dict[str, Any]:
        return {"seed": None, "injected": 0, "by_site": {}}


NULL_INJECTOR = _NullInjector()
