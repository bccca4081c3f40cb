"""Fig. 16: memory-level parallelism (in-flight requests at the controller).

Paper: serial < 5 for latency-sensitive apps, prefetch-based < 20
(MSHR-capped), CoroAMU ~64 (SPM-backed, scalable with more coroutines).
"""
from __future__ import annotations

from repro_torch.core import sim
from repro_torch.launch.kernel_bench import csv_table


def rows():
    out = []
    for name, b in sim.BENCHES.items():
        r = [name]
        for variant in ("serial", "coroamu-s", "coroamu-full"):
            m = sim.simulate(variant, b, latency_ns=800, n_coros=96).mlp
            r.append(round(m, 1))
        out.append(r)
    return out


def table() -> str:
    return csv_table(["bench", "serial", "prefetch", "coroamu"], rows())


if __name__ == "__main__":
    print(table())
