"""Calibrated performance model of CoroAMU's evaluation (paper §V-§VI).

The paper measures speedup on an FPGA-emulated disaggregated-memory RISC-V
SoC (NANHU "NH-G", Table I) with dialable far-memory latency. No GPU has
such a knob, so the reproduction-of-record is this model: a
steady-state throughput/queueing model of the five execution configurations
over the eight benchmarks, built from the paper's published constants
(Table I microarchitecture, Fig. 13 instruction expansions, Fig. 16 MLP) and
calibrated so the paper's NUMERIC claims hold:

  * Full-system averages 3.39x @200ns / 4.87x @800ns (geomean, 8 benches)
  * GUPS up to ~29x @200ns and ~59.8x @800ns
  * x86 compiler study: hand coroutines 1.40x/2.01x (local/NUMA) vs
    CoroAMU-S 2.11x/2.78x => 1.51x relative
  * CoroAMU-D loses >15% of cycles to scheduler branch mispredicts
  * MLP: serial < 5, prefetch-based < 20 (MSHR-capped), CoroAMU ~64

Per-bench bars are not numerically specified in the text, so bench profiles
were solved (grid search) to satisfy the aggregates plus the paper's
qualitative per-bench statements (GUPS/BFS exceptional; STREAM/IS/lbm
bandwidth-bound and weak, serial-better at 100ns; coroutines switch on every
tagged access, §VI-A).

Model, per iteration (steady state, Little's law):

  serial = max(instr/IPC + local_hits + misses*lat/overlap, bytes/bw)
  coro   = max(instr*expansion/IPC + local_hits + switches*(switch+ctx)
               [+ switches*mispredict  (CoroAMU-D)],
               misses*lat/min(n_coros, inflight_cap),
               bytes/bw)
  MLP    = misses*lat/time  (emergent)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core.machine import machine_profile

# The emulated NH-G SoC is a machine like any other: its clock and
# far-memory bandwidth come from the shared `core.machine` profile table
# (paper: 3GHz, 100ns-1us far memory) and are cross-checked against the
# MicroArch calibration below in `calibration_check`.
_NHG = machine_profile("nh-g")
GHZ = _NHG.clock_ghz


@dataclasses.dataclass(frozen=True)
class MicroArch:
    """NH-G core (paper Table I); SKYLAKE for the Fig. 11 x86 study."""

    ipc: float = 2.5                  # sustained, 4-wide decode
    lsq_overlap: float = 16.0         # max OoO overlap of independent misses
    prefetcher_overlap: float = 32.0  # ... with L2 BOP help on stride streams
    mshr: int = 16                    # L1 MSHRs: prefetch in-flight cap
    amu_inflight: float = 56.0        # effective AMU in-flight (Fig.16: ~64 peak)
    local_hit: float = 35.0           # local L2/LLC hit cost (cycles)
    switch_cost_handwritten: float = 30.0  # C++20 coroutine switch
    switch_cost_compiler: float = 14.0     # CoroAMU-S codegen, prefetch
    switch_cost_amu: float = 10.0          # CoroAMU-D (getfin scheduler)
    switch_cost_bafin: float = 4.0         # 2 predicted jumps + 3 ALU ops
    mispredict_penalty: float = 14.0       # indirect-jump miss (getfin)
    bw_bytes_per_cycle: float = 16.0       # far-memory bandwidth
    prefetch_pollution: float = 0.012      # per-coroutine L1 conflict slope


NH_G = MicroArch(bw_bytes_per_cycle=_NHG.hbm_bw / (GHZ * 1e9))
SKYLAKE = MicroArch(ipc=3.2, mshr=12, bw_bytes_per_cycle=32.0,
                    switch_cost_handwritten=24.0, switch_cost_compiler=10.0,
                    local_hit=30.0, prefetch_pollution=0.008)


def calibration_check() -> None:
    """Cross-check the MicroArch calibration against the shared `nh-g`
    machine profile: the far-memory bandwidth the queueing model charges
    (bytes/cycle x clock) must be the profile's `hbm_bw`, the sustained
    instruction rate must be the profile's `peak_flops`, and the AMU's
    effective in-flight window must fit the profile's request slots
    (Fig. 16: MLP peaks ~64). Raises AssertionError on drift."""
    bw = NH_G.bw_bytes_per_cycle * GHZ * 1e9
    assert abs(bw - _NHG.hbm_bw) < 1e-6 * _NHG.hbm_bw, (bw, _NHG.hbm_bw)
    ips = NH_G.ipc * GHZ * 1e9
    assert abs(ips - _NHG.peak_flops) < 1e-6 * _NHG.peak_flops, (
        ips, _NHG.peak_flops)
    assert NH_G.amu_inflight <= _NHG.request_slots, (
        NH_G.amu_inflight, _NHG.request_slots)
    assert NH_G.mshr < _NHG.request_slots  # the paper's MSHR-vs-slots gap


@dataclasses.dataclass(frozen=True)
class BenchProfile:
    """Per-iteration workload characterization (paper Table II).

    Values solved against the paper's aggregate + qualitative constraints
    (see module docstring); `stride` marks benches whose serial baseline
    benefits from the L2 Best-Offset Prefetcher (Table I).
    """

    name: str
    instr: float
    accesses: float          # tagged far-memory requests / iteration
    locality: float          # fraction hitting local cache
    overlap: float           # serial OoO(+prefetcher) overlap of misses
    coalesce_spatial: float  # fraction merged into coarse (span) requests
    coalesce_indep: float    # fraction merged via aset groups
    context_words: int       # live context, conventional codegen
    context_words_opt: int   # after private/shared/sequential analysis
    bytes: float             # far-memory bytes / iteration
    stride: bool = False
    # serial overlap measured on the x86 host (Fig. 11 study) — the Skylake
    # hierarchy overlaps misses differently than NH-G
    overlap_x86: float = 4.0


BENCHES: Dict[str, BenchProfile] = {
    "GUPS": BenchProfile("GUPS", 10, 1.0, 0.00, 1.0, 0.0, 0.00, 4, 2, 16, overlap_x86=1.5),
    "BS": BenchProfile("BS", 8, 1.0, 0.00, 24.0, 0.0, 0.00, 6, 3, 8, overlap_x86=1.0),
    "BFS": BenchProfile("BFS", 20, 4.0, 0.00, 6.0, 0.0, 0.30, 8, 4, 24, overlap_x86=2.0),
    "STREAM": BenchProfile("STREAM", 10, 3.0, 0.50, 20.0, 0.9, 0.00, 6, 2, 24, stride=True, overlap_x86=12.0),
    "HJ": BenchProfile("HJ", 24, 4.0, 0.30, 24.0, 0.0, 0.40, 10, 4, 48, overlap_x86=3.0),
    "mcf": BenchProfile("mcf", 9, 4.0, 0.00, 16.0, 0.0, 0.35, 12, 6, 48, stride=True, overlap_x86=1.5),
    "lbm": BenchProfile("lbm", 220, 19.0, 0.90, 10.0, 0.85, 0.00, 16, 6, 300, stride=True, overlap_x86=2.0),
    "IS": BenchProfile("IS", 8, 4.0, 0.70, 10.0, 0.5, 0.00, 6, 3, 24, stride=True, overlap_x86=16.0),
}

VARIANTS = ("serial", "coroutine", "coroamu-s", "coroamu-d", "coroamu-full")

# Fig. 13 dynamic-instruction expansion vs serial
EXPANSION = {
    "serial": 1.0,
    "coroutine": 4.5,
    "coroamu-s": 6.70,
    "coroamu-d": 5.98,
    "coroamu-full": 3.91,
}

PREFETCH_VARIANTS = ("coroutine", "coroamu-s")


@dataclasses.dataclass
class SimResult:
    variant: str
    bench: str
    latency_ns: float
    n_coros: int
    cycles_per_iter: float
    mlp: float
    breakdown: Dict[str, float]
    inflight_cap: float


def _ov(b: BenchProfile, ua: MicroArch) -> float:
    cap = ua.prefetcher_overlap if b.stride else ua.lsq_overlap
    ov = b.overlap_x86 if ua is SKYLAKE else b.overlap
    return min(ov, cap)


def simulate(variant: str, bench: BenchProfile, *, latency_ns: float,
             n_coros: int = 96, ua: MicroArch = NH_G,
             ctx_opt: bool | None = None,
             coalesce: bool | None = None) -> SimResult:
    """ctx_opt/coalesce override the variant defaults (Fig. 15 ablations)."""
    b = bench
    lat = latency_ns * GHZ
    m = b.accesses * (1.0 - b.locality)
    ov = _ov(b, ua)
    local = b.accesses * b.locality * ua.local_hit / ov
    bw = b.bytes / ua.bw_bytes_per_cycle

    if variant == "serial":
        compute = b.instr / ua.ipc + local
        stall = m * lat / ov
        total = max(compute + stall, bw)
        return SimResult(variant, b.name, latency_ns, 1, total,
                         m * lat / total,
                         {"compute": compute / total, "scheduler": 0.0,
                          "context": 0.0, "mispredict": 0.0,
                          "stall": max(1.0 - compute / total, 0.0)},
                         ov)

    if variant == "coroutine":
        switch_cost = ua.switch_cost_handwritten
    elif variant == "coroamu-s":
        switch_cost = ua.switch_cost_compiler
    elif variant == "coroamu-d":
        switch_cost = ua.switch_cost_amu
    elif variant == "coroamu-full":
        switch_cost = ua.switch_cost_bafin
    else:
        raise ValueError(variant)
    if ctx_opt is None:
        ctx_opt = variant == "coroamu-full"
    if coalesce is None:
        coalesce = variant == "coroamu-full"
    ctx_words = b.context_words_opt if ctx_opt else b.context_words

    # coroutines suspend on every tagged access (§VI-A); -Full coalesces
    switches = b.accesses
    if coalesce:
        switches = b.accesses * max(1.0 - (b.coalesce_spatial + b.coalesce_indep), 0.15)

    instr = b.instr * EXPANSION[variant]
    compute = instr / ua.ipc + local
    sched = switches * switch_cost
    ctx = switches * ctx_words  # 2 ops/word at 2 ops/cycle
    mispredict = switches * ua.mispredict_penalty if variant == "coroamu-d" else 0.0
    cpu = compute + sched + ctx + mispredict

    cap = float(ua.mshr) if variant in PREFETCH_VARIANTS else ua.amu_inflight
    inflight = min(float(n_coros), cap)
    latency_term = m * lat / max(inflight, 1.0)

    pollution = 0.0
    if variant in PREFETCH_VARIANTS:
        evicted = min(ua.prefetch_pollution * max(n_coros - 24, 0), 0.6)
        pollution = m * evicted * lat / max(ov * 4, 1)

    total = max(cpu + pollution, latency_term, bw)
    return SimResult(variant, b.name, latency_ns, n_coros, total,
                     m * lat / total,
                     {"compute": compute / total, "scheduler": sched / total,
                      "context": ctx / total, "mispredict": mispredict / total,
                      "stall": max(1.0 - (cpu + pollution) / total, 0.0)},
                     inflight)


def speedup(variant: str, bench: BenchProfile, *, latency_ns: float,
            n_coros: int = 96, ua: MicroArch = NH_G) -> float:
    s = simulate("serial", bench, latency_ns=latency_ns, ua=ua)
    v = simulate(variant, bench, latency_ns=latency_ns, n_coros=n_coros, ua=ua)
    return s.cycles_per_iter / v.cycles_per_iter


COROS_GRID = (2, 4, 8, 16, 24, 32, 48, 64, 96)


def best_coros(variant: str, bench: BenchProfile, *, latency_ns: float,
               ua: MicroArch = NH_G, grid=COROS_GRID) -> int:
    return max(grid, key=lambda n: speedup(variant, bench, latency_ns=latency_ns,
                                           n_coros=n, ua=ua))


def geomean(xs: List[float]) -> float:
    return math.exp(sum(math.log(max(x, 1e-12)) for x in xs) / len(xs))


def average_speedup(variant: str, *, latency_ns: float, n_coros: int = 96,
                    ua: MicroArch = NH_G, tune_coros: bool = False) -> float:
    sps = []
    for b in BENCHES.values():
        n = best_coros(variant, b, latency_ns=latency_ns, ua=ua) if tune_coros else n_coros
        sps.append(speedup(variant, b, latency_ns=latency_ns, n_coros=n, ua=ua))
    return geomean(sps)
