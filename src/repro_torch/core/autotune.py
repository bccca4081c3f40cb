"""Latency-aware depth autotuning for the coroutine kernels (CoroAMU §III-D).

This module is the glue between the depth solver (`core.schedule`) and the
kernel entry points (`kernels/*/ops.py`): every kernel family describes one
in-flight tile as a `TileProfile` (bytes DMA'd, flops after resumption, and
the VMEM its slot occupies), and `choose_depth` turns that profile into the
pipeline depth — the software analogue of the paper's Return-Block dynamic
scheduler picking how many coroutines to keep in flight.

Two paths:

* static solve — `choose_depth(profile)` with no recorded samples returns
  exactly `schedule.solve_depth(profile)` for the ACTIVE machine profile
  (`core.machine`): the smallest depth that hides the modelled latency,
  capped by the VMEM budget and the profile's request slots. Kernel entry
  points call this when invoked with ``depth=None``.
* run-time feedback — `record_transfer(kernel, seconds)` accumulates
  measured per-tile transfer latencies; once samples exist for a kernel,
  `choose_depth` re-solves from the observed tail latency via
  `schedule.adaptive_depth`, adapting the schedule to the latency actually
  seen instead of the data-sheet constant.

The feedback store is keyed by **(machine, kernel)**: switching the active
profile (`machine.set_machine`, `REPRO_MACHINE`) never reuses another
profile's latency samples — the paper's latency dial re-solves from scratch.

Always-on telemetry: the serving engine feeds every decode round and every
prefill chunk to `observe_pipeline(kernel, wall_s, n_tiles)`, and the GUPS
and kernel-bench launchers feed the device time (CUDA events) of each
kernel call they make; a kernel wrapper itself never synchronizes to time
its launch. The first observation of a
(machine, kernel, n_tiles) triple is treated as compile warmup and dropped;
every later one lands in `record_transfer` as wall-clock / tiles — so ANY
workload tightens the schedule, not just the benchmark harness.
`telemetry_summary()` exposes per-kernel sample count, p50/p99 observed
per-tile latency, and the static-vs-adaptive depth each kernel last ran.

`last_choice(kernel)` exposes the most recent decision so benchmarks and
tests can report/assert the depth a ``depth=None`` call actually used.

API stability note: `TileProfile` is defined in `core.schedule` and
re-exported here. Kernel wrappers derive their profile from the
declarative `CoroSpec` (``spec.profile()``) and pass
``vars=spec.all_vars()`` so the VMEM cap comes from the classified context
bytes; the ``profile_*`` helpers below remain the standalone traffic/flops
models used by the benchmarks and the modelled-latency figures.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core import context as ctx_mod
from repro_torch.core.machine import MachineModel, get_machine
from repro_torch.core.schedule import (
    TileProfile,
    adaptive_depth,
    solve_depth,
)
from repro_torch.obs.metrics import percentile

__all__ = [
    "TileProfile",
    "choose_depth",
    "clear_samples",
    "last_choice",
    "observe_pipeline",
    "profile_decode",
    "profile_row_gather",
    "profile_scatter_add",
    "profile_span_gather",
    "profile_triad",
    "record_choice",
    "record_transfer",
    "set_telemetry",
    "telemetry_enabled",
    "telemetry_summary",
    "transfer_samples",
]

TELEMETRY_ENV = "REPRO_TELEMETRY"
# bound the always-on store: a serving process records forever
MAX_SAMPLES_PER_KERNEL = 512

_lock = threading.Lock()
# all the stores are keyed (machine_name, kernel): a profile switch never
# reuses stale samples or reports another machine's decisions
_transfer_samples: Dict[Tuple[str, str], List[float]] = {}
_last_choice: Dict[Tuple[str, str], int] = {}
_last_mode: Dict[Tuple[str, str], str] = {}       # "static" | "adaptive"
_warmed: Set[Tuple[str, str, int]] = set()        # (machine, kernel, n_tiles)
_telemetry_on: bool = os.environ.get(TELEMETRY_ENV, "1") not in ("0", "off")


def _key(kernel: str, machine: Optional[MachineModel] = None) -> Tuple[str, str]:
    return ((machine or get_machine()).name, kernel)


# ------------------------------------------------------- per-kernel profiles


#
# flops_per_tile models the post-resumption work per element: pure data
# movement counts ~1 op/element (gather/triad).


def profile_row_gather(rows_per_tile: int, d: int, itemsize: int) -> TileProfile:
    """One tile = `rows_per_tile` single-row copies (an aset group)."""
    return TileProfile(
        tile_bytes=rows_per_tile * d * itemsize,
        flops_per_tile=float(rows_per_tile * d),
    )


def profile_span_gather(span: int, d: int, itemsize: int) -> TileProfile:
    """One tile = one coarse-grained span copy (paper §III-C case 1)."""
    return TileProfile(
        tile_bytes=span * d * itemsize,
        flops_per_tile=float(span * d),
    )


def profile_scatter_add(rows_per_tile: int, d: int, itemsize: int) -> TileProfile:
    """RMW tile: rows are loaded AND stored (2x bytes), and each slot holds
    separate in/out buffers — tile_bytes doubles as both the traffic and the
    per-slot footprint."""
    return TileProfile(
        tile_bytes=2 * rows_per_tile * d * itemsize,
        flops_per_tile=float(2 * rows_per_tile * d),
    )


def profile_triad(rows: int, d: int, itemsize: int) -> TileProfile:
    """STREAM tile: two loads plus one store per slot (three slot buffers)."""
    return TileProfile(
        tile_bytes=3 * rows * d * itemsize,
        flops_per_tile=float(2 * rows * d),  # fma per element
    )


def profile_decode(blk: int, kh: int, g: int, d: int, itemsize: int) -> TileProfile:
    """KV block tile: k+v DMAs per slot; accumulators are depth-independent."""
    h = kh * g
    return TileProfile(
        tile_bytes=2 * blk * kh * d * itemsize,
        flops_per_tile=float(4 * blk * h * d),  # qk + pv per block
        shared_bytes=4 * (kh * g * (d + 2) + h * d),  # acc/m/l + q (f32)
    )


# ------------------------------------------------------- run-time feedback


def record_transfer(kernel: str, seconds: float) -> None:
    """Feed one measured per-tile transfer latency into the feedback loop
    (stored under the active machine profile)."""
    with _lock:
        xs = _transfer_samples.setdefault(_key(kernel), [])
        xs.append(float(seconds))
        if len(xs) > MAX_SAMPLES_PER_KERNEL:
            del xs[: len(xs) - MAX_SAMPLES_PER_KERNEL]


def transfer_samples(kernel: str) -> List[float]:
    with _lock:
        return list(_transfer_samples.get(_key(kernel), ()))


def clear_samples(kernel: Optional[str] = None) -> None:
    """Drop recorded samples — and the depth decisions derived from them —
    for one kernel (active machine) or for everything (all machines)."""
    with _lock:
        if kernel is None:
            _transfer_samples.clear()
            _last_choice.clear()
            _last_mode.clear()
            _warmed.clear()
        else:
            k = _key(kernel)
            _transfer_samples.pop(k, None)
            _last_choice.pop(k, None)
            _last_mode.pop(k, None)
            _warmed.difference_update(
                {w for w in _warmed if w[:2] == k})


def last_choice(kernel: str) -> Optional[int]:
    """Depth chosen by the most recent ``depth=None`` call for `kernel`
    under the active machine profile."""
    with _lock:
        return _last_choice.get(_key(kernel))


def record_choice(kernel: str, depth: int) -> None:
    """Record the depth a kernel call actually ran with.

    A kernel wrapper overwrites the solver's raw answer with the value it
    launched after clamping to the tile count, so `last_choice` reports an
    allocated depth, never an unreachable one.
    """
    with _lock:
        _last_choice[_key(kernel)] = int(depth)


# ----------------------------------------------------- always-on telemetry


def telemetry_enabled() -> bool:
    return _telemetry_on


def set_telemetry(on: bool) -> None:
    """Process-wide switch for the automatic pipeline timing hook
    (seeded from ``REPRO_TELEMETRY``; "0"/"off" disables)."""
    global _telemetry_on
    _telemetry_on = bool(on)


def observe_pipeline(kernel: str, wall_s: float, n_tiles: int) -> None:
    """One launched pipeline's wall clock -> the feedback store.

    Called by the serving engine after every decode round and prefill
    chunk, so `record_transfer` is
    fed from real runs without any caller wiring. The FIRST observation of
    a (machine, kernel, n_tiles) triple is dropped as compile warmup —
    kernel builds and first launches would otherwise dominate the tail and
    the adaptive re-solve would chase compilation, not transfer.
    """
    if not _telemetry_on or n_tiles <= 0 or wall_s < 0:
        return
    wkey = (*_key(kernel), int(n_tiles))
    with _lock:
        if wkey not in _warmed:
            _warmed.add(wkey)
            return
    record_transfer(kernel, wall_s / n_tiles)


def telemetry_summary() -> Dict[str, Any]:
    """Per-kernel feedback-loop state under the active machine profile.

    Returns ``{"machine": name, "kernels": {kernel: {samples, p50_us,
    p99_us, depth, mode}}}`` where `depth` is the depth the kernel last ran
    (`last_choice`) and `mode` says whether that decision came from the
    static data-sheet solve or the adaptive re-solve over observed samples.
    Percentiles route through `obs.metrics.percentile`. The ``substrate``
    section folds in `core.guard.stats()`.
    """
    m = get_machine()
    with _lock:
        kernels = sorted({k for mk, k in _transfer_samples if mk == m.name}
                         | {k for mk, k in _last_choice if mk == m.name})
        out: Dict[str, Any] = {"machine": m.name, "kernels": {}}
        for kernel in kernels:
            key = (m.name, kernel)
            xs = _transfer_samples.get(key, [])
            entry: Dict[str, Any] = {
                "samples": len(xs),
                "depth": _last_choice.get(key),
                "mode": _last_mode.get(key, "static"),
            }
            if xs:
                p50_s = percentile(xs, 0.50)
                entry["p50_us"] = round(p50_s * 1e6, 3)
                entry["p99_us"] = round(percentile(xs, 0.99) * 1e6, 3)
            out["kernels"][kernel] = entry
    from repro_torch.core import guard  # local: guard imports obs metrics
    out["substrate"] = guard.stats()
    return out


# ------------------------------------------------------------- the decision


def choose_depth(
    profile: TileProfile,
    *,
    kernel: Optional[str] = None,
    machine: Optional[MachineModel] = None,
    latency_s: Optional[float] = None,
    vmem_budget: Optional[int] = None,
    vars: Optional[Iterable[ctx_mod.VarSpec]] = None,
) -> int:
    """Solve the pipeline depth for one kernel call.

    `machine` defaults to the active `core.machine` profile and supplies
    the latency / VMEM budget / request-slot bounds (`latency_s` /
    `vmem_budget` override individually). With no recorded samples for
    (machine, kernel) this is exactly ``schedule.solve_depth`` — latency
    covered, VMEM capped, floor of 2. With samples (see `record_transfer`,
    `observe_pipeline`) it re-solves from the observed tail latency instead
    (`schedule.adaptive_depth`).

    When `vars` is given (the `CoroSpec` path: ``spec.all_vars()``) the VMEM
    cap is `context.max_depth(vars, vmem_budget)` — the §III-B classified
    context bytes (private x depth, shared/sequential x 1) — instead of the
    profile's hand-filled byte counts, with the machine's request slots as
    the hard cap. A shared accumulator therefore permits a deeper pipeline
    than the all-private baseline would.
    """
    m = machine or get_machine()
    budget = m.vmem_bytes if vmem_budget is None else vmem_budget
    vmem_cap = None
    if vars is not None:
        vmem_cap = ctx_mod.max_depth(list(vars), budget, cap=m.request_slots)
    if kernel:
        with _lock:
            samples = list(_transfer_samples.get((m.name, kernel), ()))
    else:
        samples = []
    if samples:
        mode = "adaptive"
        depth = adaptive_depth(profile, samples, machine=m,
                               vmem_budget=budget, vmem_cap=vmem_cap)
    else:
        mode = "static"
        depth = solve_depth(profile, machine=m, latency_s=latency_s,
                            vmem_budget=budget, vmem_cap=vmem_cap)
    if kernel is not None:
        key = (m.name, kernel)
        with _lock:
            _last_choice[key] = depth
            _last_mode[key] = mode
    return depth
