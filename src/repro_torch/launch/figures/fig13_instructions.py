"""Fig. 13: dynamic instruction expansion vs serial (control cost).

Paper: 6.70x (CoroAMU-S) -> 5.98x (-D, SPM removes software queues) ->
3.91x (-Full, metadata offloaded into memory ops + bafin).
"""
from __future__ import annotations

from repro_torch.core import sim
from repro_torch.launch.kernel_bench import csv_table


def rows():
    out = []
    for variant in ("coroutine", "coroamu-s", "coroamu-d", "coroamu-full"):
        # per-bench switch counts show WHERE the expansion goes
        per = []
        for b in sim.BENCHES.values():
            r = sim.simulate(variant, b, latency_ns=100, n_coros=96)
            sw = b.accesses
            if variant == "coroamu-full":
                sw = b.accesses * max(1 - (b.coalesce_spatial + b.coalesce_indep), 0.15)
            per.append(round(sw, 2))
        out.append([variant, sim.EXPANSION[variant], *per])
    return out


def table() -> str:
    return csv_table(["variant", "instr_expansion", *(f"{n}_switches" for n in sim.BENCHES)], rows())


if __name__ == "__main__":
    print(table())
