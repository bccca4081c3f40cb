"""Fig. 14: execution-cycle breakdown at 200ns for (1) serial, (2) CoroAMU-D,
(3) CoroAMU-D + bafin.

Paper: scheduler branch mispredicts cost >15% of CoroAMU-D cycles on average;
bafin eliminates them.
"""
from __future__ import annotations

import statistics

from repro_torch.core import sim
from repro_torch.launch.kernel_bench import csv_table

CONFIGS = (
    ("serial", {}),
    ("coroamu-d", {}),
    ("coroamu-d+bafin", {}),
)


def _simulate(tag, bench):
    if tag == "coroamu-d+bafin":
        # bafin removes the mispredict penalty but keeps -D codegen
        r = sim.simulate("coroamu-full", bench, latency_ns=200, n_coros=96,
                         ctx_opt=False, coalesce=False)
    else:
        r = sim.simulate(tag, bench, latency_ns=200, n_coros=96)
    return r


def rows():
    out = []
    for tag, _ in CONFIGS:
        for name, b in sim.BENCHES.items():
            r = _simulate(tag, b)
            out.append([tag, name,
                        round(r.breakdown["compute"], 3),
                        round(r.breakdown["scheduler"], 3),
                        round(r.breakdown["context"], 3),
                        round(r.breakdown["mispredict"], 3),
                        round(r.breakdown["stall"], 3)])
    return out


def mean_mispredict() -> float:
    return statistics.mean(
        _simulate("coroamu-d", b).breakdown["mispredict"]
        for b in sim.BENCHES.values())


def table() -> str:
    return csv_table(
        ["config", "bench", "compute", "scheduler", "context", "mispredict", "stall"],
        rows())


if __name__ == "__main__":
    print(table())
    print(f"# mean CoroAMU-D mispredict fraction: {mean_mispredict():.2f} (paper: >0.15)")
