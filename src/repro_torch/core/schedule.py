"""Scheduling policies and the latency-aware depth solver (CoroAMU §III-D).

The paper contrasts:
  static   - fixed launch order tuned for ONE latency; degrades when latency
             varies (prefetch-distance mismatch) and is capped by MSHRs.
  dynamic  - resume whichever coroutine's data arrived (getfin/bafin);
             adapts to variable latency, capped only by SPM request slots.

Accelerator adaptation: the copy-completion oracle exists at issue time, so the dynamic scheduler collapses to a rotation whose DEPTH must cover
the worst-case latency — adaptivity moves into `solve_depth`, which takes the
latency bound as an input instead of polling at run time. `adaptive_depth`
re-solves from observed latency samples (the run-time feedback loop the
paper's Return Block implements in hardware).

Every hardware constant lives in `core.machine` (one `MachineModel`, many
profiles — the paper's latency dial as `REPRO_MACHINE=v5e-far-800ns`). The
solver reads the ACTIVE profile by default and takes `machine=` to solve
for another one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.machine import MachineModel, get_machine


@dataclasses.dataclass(frozen=True)
class TileProfile:
    """One coroutine's footprint and work."""

    tile_bytes: int              # bytes DMA'd per tile (the context data)
    flops_per_tile: float        # compute after resumption
    private_bytes: int = 0       # extra per-slot context (core.context)
    shared_bytes: int = 0        # depth-independent VMEM residents


def tile_compute_s(p: TileProfile, *,
                   machine: Optional[MachineModel] = None) -> float:
    m = machine or get_machine()
    return p.flops_per_tile / m.peak_flops


def tile_transfer_s(p: TileProfile, *,
                    machine: Optional[MachineModel] = None) -> float:
    m = machine or get_machine()
    return p.tile_bytes / m.hbm_bw


def solve_depth(p: TileProfile, *, machine: Optional[MachineModel] = None,
                latency_s: Optional[float] = None,
                vmem_budget: Optional[int] = None,
                slot_limit: Optional[int] = None,
                vmem_cap: Optional[int] = None) -> int:
    """Smallest depth that hides the latency, capped by VMEM and slot count.

    `machine` defaults to the active `core.machine` profile; `latency_s` /
    `vmem_budget` / `slot_limit` default to that model's fields and override
    them individually when given (the latency dial, a tighter budget).

    Hiding condition (paper §II insight, adapted): while one tile's DMA is in
    flight (latency + transfer), the other depth-1 slots must keep the
    machine busy. A slot's steady-state service time is bounded below by its
    compute AND by its own transfer (in-flight DMAs overlap, so transfer
    time is supplied concurrently — the paper's MLP argument), giving

        (depth-1) * max(t_compute, t_transfer) >= latency + t_transfer.

    For compute-rich tiles this reduces to the classic compute-hiding bound;
    for pure data movement it solves to the MLP that saturates HBM bandwidth
    at the given latency instead of diverging. `slot_limit` is the SPM
    request-slot bound the paper's dynamic scheduler is capped by (unlike
    the static baseline's MSHR cap it is a property of the pipeline's own
    context arena, not the core) — it also bounds the unrolled warmup code.

    `vmem_cap` overrides the profile-derived capacity cap with an externally
    classified one: `core.autotune.choose_depth` passes
    `context.max_depth(spec.vars, vmem_budget)` here so the VMEM bound comes
    from the §III-B classification (private x depth, shared x 1) instead of
    the hand-filled profile byte counts.
    """
    m = machine or get_machine()
    latency_s = m.hbm_latency_s if latency_s is None else latency_s
    vmem_budget = m.vmem_bytes if vmem_budget is None else vmem_budget
    slot_limit = m.request_slots if slot_limit is None else slot_limit
    tc = max(tile_compute_s(p, machine=m), 1e-12)
    tt = tile_transfer_s(p, machine=m)
    service = max(tc, tt)
    need = math.ceil((latency_s + tt) / service) + 1
    if vmem_cap is not None:
        cap = vmem_cap
    else:
        per_slot = p.tile_bytes + p.private_bytes
        cap = max((vmem_budget - p.shared_bytes) // max(per_slot, 1), 1)
    return int(max(2, min(need, cap, slot_limit)))


def achieved_bandwidth(p: TileProfile, depth: int,
                       *, machine: Optional[MachineModel] = None,
                       latency_s: Optional[float] = None) -> float:
    """Steady-state HBM bytes/s of the pipeline at a given depth.

    Each slot cycles through issue -> in-flight(latency+transfer) -> compute.
    With `depth` slots, a tile completes every
    max(t_compute, (latency + t_transfer + t_compute)/depth).
    """
    m = machine or get_machine()
    latency_s = m.hbm_latency_s if latency_s is None else latency_s
    tc = tile_compute_s(p, machine=m)
    tt = tile_transfer_s(p, machine=m)
    period = max(tc, (latency_s + tt + tc) / depth, tt)
    return p.tile_bytes / period


def adaptive_depth(p: TileProfile, latency_samples_s: Sequence[float],
                   *, quantile: float = 0.95,
                   machine: Optional[MachineModel] = None,
                   vmem_budget: Optional[int] = None,
                   slot_limit: Optional[int] = None,
                   vmem_cap: Optional[int] = None) -> int:
    """Dynamic-scheduler analogue: re-solve depth from observed latencies."""
    if not latency_samples_s:
        return solve_depth(p, machine=machine, vmem_budget=vmem_budget,
                           slot_limit=slot_limit, vmem_cap=vmem_cap)
    xs = sorted(latency_samples_s)
    q = xs[min(int(quantile * len(xs)), len(xs) - 1)]
    return solve_depth(p, machine=machine, latency_s=q,
                       vmem_budget=vmem_budget, slot_limit=slot_limit,
                       vmem_cap=vmem_cap)
