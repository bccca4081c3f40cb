"""The one machine description every layer reads (CoroAMU's latency dial).

The paper's central knob is latency: the coroutine schedule is re-solved as
far-memory latency dials from 200ns to 800ns (§III-D, §V), and the AMU line
of work argues the latency model must be a first-class *runtime* input, not
a compile-time constant scattered through the code. This module is that
input: a frozen `MachineModel` dataclass holding every hardware constant
the repo reasons with, a table of named profiles, and a process-wide
active-profile switch (`set_machine`/`get_machine`, seeded from the
`REPRO_MACHINE` env var).

Consumers (one definition, many readers):

  core.schedule   - solve_depth/adaptive_depth/achieved_bandwidth read
                    peak_flops / hbm_bw / hbm_latency_s / vmem_bytes /
                    request_slots from the active (or passed) model
  core.autotune   - choose_depth keys its feedback store by
                    (machine, kernel) so a profile switch never reuses
                    stale latency samples

The port's default profile is `h100`: shared memory per thread block plays
the part of VMEM, so `context.max_depth` caps a pipeline by what one CUDA
block can hold. The TPU / CPU-interpret / NH-G profiles are kept so the
depth solve can be compared across machines. Which path a kernel takes is
decided by the device of its tensors, never by the active profile.

Profile selection::

  REPRO_MACHINE=v5e python -m repro_torch.launch.serve ...   # env, at import
  set_machine("h100")                                        # runtime
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Tuple, Union

__all__ = [
    "MachineModel",
    "MACHINES",
    "DEFAULT_MACHINE",
    "MACHINE_ENV",
    "get_machine",
    "set_machine",
    "machine_profile",
    "profile_names",
]

MACHINE_ENV = "REPRO_MACHINE"


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Everything the schedule/roofline/sim layers know about one machine."""

    name: str
    peak_flops: float        # sustained FLOP/s (bf16 on TPU profiles)
    hbm_bw: float            # bytes/s to the far store (HBM on-chip)
    hbm_latency_s: float     # round-trip latency one decoupled DMA sees
    vmem_bytes: int          # scratchpad (VMEM / SPM) capacity
    ici_bw: float            # bytes/s per interconnect link (collectives)
    request_slots: int       # outstanding-DMA bound ("SPM request slots")
    clock_ghz: float         # core clock (cycles <-> seconds in core.sim)
    backend: str = "tpu"     # "tpu" | "interpret" | "cuda" (descriptive)

    def replace(self, **kw) -> "MachineModel":
        return dataclasses.replace(self, **kw)

    def summary(self) -> Dict[str, float]:
        return {
            "machine": self.name,
            "peak_tflops": self.peak_flops / 1e12,
            "hbm_gbps": self.hbm_bw / 1e9,
            "hbm_latency_ns": self.hbm_latency_s * 1e9,
            "vmem_mib": self.vmem_bytes / (1 << 20),
            "request_slots": self.request_slots,
        }


_V5E = MachineModel(
    name="v5e",
    peak_flops=197e12,            # bf16, per chip (datasheet)
    hbm_bw=819e9,
    hbm_latency_s=700e-9,         # HBM round-trip seen by a DMA
    vmem_bytes=128 * 1024 * 1024,
    ici_bw=50e9,                  # per link
    request_slots=64,             # paper's "capped only by SPM request slots"
    clock_ghz=0.94,
)

# The paper's latency dial (§V): the same chip in front of far memory that
# adds 200ns-800ns on top of local HBM at UNCHANGED bandwidth — the paper
# sweeps latency with bandwidth held fixed, which is exactly what isolates
# the schedule's latency tolerance (halving bandwidth would *lengthen* each
# tile's transfer and so *shrink* the depth needed to hide the dial). The
# AMU these profiles model provisions a larger request-slot arena —
# covering more latency takes more coroutines in flight (§III-D), and the
# SPM slot bound is a property of the memory unit, not the core.
_FAR_SLOTS = 256

# NVIDIA H100 SXM. peak_flops (dense bf16 tensor cores), hbm_bw (HBM3) and
# ici_bw (NVLink, per direction) are data-sheet values. vmem_bytes is the
# shared memory one thread block may use (232,448 B, Hopper tuning guide).
# hbm_latency_s, request_slots and clock_ghz are estimates, not
# measurements: a global load that misses L2 takes roughly 600 ns under
# load; 64 slots matches context.MAX_DEPTH; 1.755 GHz is the boost clock.
_H100 = MachineModel(
    name="h100",
    peak_flops=989e12,            # data sheet
    hbm_bw=3.35e12,               # data sheet
    hbm_latency_s=600e-9,         # estimate
    vmem_bytes=232_448,           # data sheet: max shared memory per block
    ici_bw=450e9,                 # data sheet: NVLink 900 GB/s, each way
    request_slots=64,             # estimate
    clock_ghz=1.755,              # estimate
    backend="cuda",
)

MACHINES: Dict[str, MachineModel] = {
    "h100": _H100,
    "v5e": _V5E,
    "v5e-far-200ns": _V5E.replace(
        name="v5e-far-200ns",
        hbm_latency_s=_V5E.hbm_latency_s + 200e-9,
        request_slots=_FAR_SLOTS,
    ),
    "v5e-far-800ns": _V5E.replace(
        name="v5e-far-800ns",
        hbm_latency_s=_V5E.hbm_latency_s + 800e-9,
        request_slots=_FAR_SLOTS,
    ),
    # The reference package's CPU path: Pallas interpret mode on one CPU
    # core. Compute dwarfs transfer, so solved depths collapse toward the
    # floor — picking this profile documents that interpret timings are not
    # TPU performance (benchmarks/kernel_bench.py docstring).
    "cpu-interpret": MachineModel(
        name="cpu-interpret",
        peak_flops=5e10,
        hbm_bw=20e9,
        hbm_latency_s=100e-9,
        vmem_bytes=128 * 1024 * 1024,
        ici_bw=0.0,
        request_slots=16,
        clock_ghz=3.0,
        backend="interpret",
    ),
    # The paper's FPGA-emulated NH-G RISC-V SoC (Table I): core.sim derives
    # its clock and far-memory bandwidth from here and cross-checks them
    # (sim.calibration_check). 16 B/cycle at 3 GHz = 48 GB/s far bandwidth.
    "nh-g": MachineModel(
        name="nh-g",
        peak_flops=7.5e9,          # 2.5 sustained IPC x 3 GHz
        hbm_bw=48e9,
        hbm_latency_s=700e-9,      # mid-dial; sim sweeps 100ns-1us anyway
        vmem_bytes=64 * 1024,      # SPM
        ici_bw=0.0,
        request_slots=64,          # AMU slots (Fig. 16: MLP peaks ~64)
        clock_ghz=3.0,
        backend="interpret",
    ),
}

DEFAULT_MACHINE = "h100"

_lock = threading.Lock()


def machine_profile(name: str) -> MachineModel:
    try:
        return MACHINES[name]
    except KeyError:
        raise KeyError(
            f"unknown machine profile {name!r}; known: {sorted(MACHINES)}"
        ) from None


def profile_names() -> Tuple[str, ...]:
    return tuple(MACHINES)


def _initial() -> MachineModel:
    return machine_profile(os.environ.get(MACHINE_ENV, DEFAULT_MACHINE))


_active: MachineModel = _initial()


def get_machine() -> MachineModel:
    """The process-wide active machine model."""
    return _active


def set_machine(m: Union[str, MachineModel, None] = None) -> MachineModel:
    """Switch the active profile (by name, or an ad-hoc `MachineModel`).

    ``set_machine(None)`` re-resolves from `REPRO_MACHINE`/the default —
    what the test fixture uses to reset between tests. Returns the now-
    active model. `core.autotune` keys its feedback store by machine name,
    so switching never reuses another profile's latency samples.
    """
    global _active
    with _lock:
        if m is None:
            _active = _initial()
        elif isinstance(m, MachineModel):
            _active = m
        else:
            _active = machine_profile(m)
        return _active
