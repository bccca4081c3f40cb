"""Stall-breakdown reporter: runtime reproduction of the paper's Fig. 14.

CoroAMU's evaluation attributes execution time to compute vs. decoupled
memory access vs. scheduling overhead (Fig. 14);
`launch/figures/fig14_breakdown` reproduces that figure from the cycle
simulator. This module produces the
same *shape* of report for the live system: for each kernel the always-on
telemetry has samples for, it combines the `core.machine.MachineModel`
schedule solve with the observed per-tile wall time to say where the cycles
went.

Methodology: for a kernel with tile profile `p` running at
pipeline depth `d` on machine `m`, the model gives

  t_compute  = p.flops_per_tile / m.peak_flops
  t_transfer = p.tile_bytes / m.hbm_bw
  t_model    = max(t_compute, t_transfer,
                   (m.hbm_latency_s + t_transfer + t_compute) / d)

(`t_model` is `schedule.achieved_bandwidth`'s steady-state period: the
third term is the latency the pipeline failed to hide at depth `d`).
Observed per-tile wall time `w` (p50 of `core.autotune`'s transfer samples)
is then attributed greedily:

  compute  = min(t_compute, w)                     # the SMs' share
  transfer = min(max(t_model - t_compute, 0),      # modelled EXPOSED memory
                 w - compute)                      #   time (not hidden
                                                   #   under compute)
  gap      = w - compute - transfer                # scheduling/host residual

so compute + transfer + gap == w by construction (the acceptance criterion
"sums to round wall time within 10%" holds exactly, modulo rounding) and
`gap` isolates what neither the compute roofline nor the latency model
explains — launch and host dispatch, scheduler bookkeeping.

Surfaced via `core.autotune.telemetry_summary()` (per-kernel ``breakdown``
entries) and `launch/kernel_bench.py --json`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.machine import MachineModel, get_machine
from repro_torch.core.schedule import (
    TileProfile,
    tile_compute_s,
    tile_transfer_s,
)

__all__ = ["attribute", "stall_breakdown"]


def attribute(profile: TileProfile, depth: Optional[int],
              observed_tile_s: float, *,
              machine: Optional[MachineModel] = None) -> Dict[str, Any]:
    """Attribute one kernel's observed per-tile wall time (seconds) to
    compute / exposed transfer / scheduling gap. See module docstring for
    the exact split; all times reported in microseconds."""
    m = machine or get_machine()
    d = max(int(depth) if depth else 1, 1)
    tc = tile_compute_s(profile, machine=m)
    tt = tile_transfer_s(profile, machine=m)
    t_model = max(tc, tt, (m.hbm_latency_s + tt + tc) / d)
    w = max(float(observed_tile_s), 0.0)
    compute = min(tc, w)
    transfer = min(max(t_model - tc, 0.0), w - compute)
    gap = max(w - compute - transfer, 0.0)
    return {
        "depth": d,
        "observed_us": round(w * 1e6, 3),
        "modeled_us": round(t_model * 1e6, 3),
        "compute_us": round(compute * 1e6, 3),
        "transfer_us": round(transfer * 1e6, 3),
        "gap_us": round(gap * 1e6, 3),
        "compute_frac": round(compute / w, 4) if w else 0.0,
        "transfer_frac": round(transfer / w, 4) if w else 0.0,
        "gap_frac": round(gap / w, 4) if w else 0.0,
    }


def stall_breakdown(machine: Optional[MachineModel] = None) -> Dict[str, Any]:
    """Fig. 14-shaped report over every kernel the feedback store has both
    samples and a recorded tile profile for (the active machine's slice of
    `core.autotune`'s stores). Kernels observed without a profile (e.g. a
    drive loop that only calls `observe_pipeline`) are listed with their
    observed time entirely unattributed."""
    from repro_torch.core import autotune  # local: autotune ties back into obs

    m = machine or get_machine()
    summ = autotune.telemetry_summary()
    out: Dict[str, Any] = {"machine": m.name, "kernels": {}}
    for kernel, entry in summ["kernels"].items():
        if not entry.get("samples"):
            continue
        bd = entry.get("breakdown")
        if bd is None:
            w_us = entry.get("p50_us", 0.0)
            bd = {"depth": entry.get("depth"), "observed_us": w_us,
                  "modeled_us": None, "compute_us": 0.0, "transfer_us": 0.0,
                  "gap_us": w_us, "unattributed": True}
        out["kernels"][kernel] = bd
    return out
