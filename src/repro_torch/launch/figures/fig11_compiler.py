"""Fig. 11: prefetch-based CoroAMU compiler vs hand-written coroutines on x86.

Paper numbers (Intel Xeon Gold 6130, local/NUMA = 90/130ns): SOTA coroutines
average 1.40x / 2.01x; the CoroAMU compiler 2.11x / 2.78x (1.51x relative).
"""
from __future__ import annotations

from repro_torch.core import sim
from repro_torch.launch.kernel_bench import csv_table


def rows():
    out = []
    for lat, tag in ((90, "local"), (130, "numa")):
        for variant in ("coroutine", "coroamu-s"):
            per = {}
            for name, b in sim.BENCHES.items():
                n = sim.best_coros(variant, b, latency_ns=lat, ua=sim.SKYLAKE)
                per[name] = sim.speedup(variant, b, latency_ns=lat,
                                        n_coros=n, ua=sim.SKYLAKE)
            avg = sim.geomean(list(per.values()))
            out.append([tag, variant, *(round(per[n], 2) for n in sim.BENCHES),
                        round(avg, 2)])
    return out


def table() -> str:
    return csv_table(["memory", "variant", *sim.BENCHES, "geomean"], rows())


def headline():
    vals = {}
    for lat, tag in ((90, "local"), (130, "numa")):
        for variant in ("coroutine", "coroamu-s"):
            vals[(tag, variant)] = sim.average_speedup(
                variant, latency_ns=lat, ua=sim.SKYLAKE, tune_coros=True)
    return vals


if __name__ == "__main__":
    print(table())
