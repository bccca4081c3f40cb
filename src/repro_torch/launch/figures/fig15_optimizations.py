"""Fig. 15: compiler-optimization ablation at 100ns — (1) CoroAMU-D+bafin,
(2) + context minimization, (3) + request aggregation.

Reports normalized performance, normalized switch count, and context
operations per switch. Paper: gains up to ~20% (GUPS/IS/HJ context; mcf/HJ/
lbm/STREAM aggregation). The kernel-level twin of (3) is the coalescing
planner (core.descriptors) exercised by kernel_bench.py.
"""
from __future__ import annotations

from repro_torch.core import sim
from repro_torch.launch.kernel_bench import csv_table

STAGES = (
    ("bafin", dict(ctx_opt=False, coalesce=False)),
    ("+context", dict(ctx_opt=True, coalesce=False)),
    ("+aggregation", dict(ctx_opt=True, coalesce=True)),
)


def rows():
    out = []
    for name, b in sim.BENCHES.items():
        base = sim.simulate("coroamu-full", b, latency_ns=100, n_coros=96,
                            **STAGES[0][1]).cycles_per_iter
        for tag, kw in STAGES:
            r = sim.simulate("coroamu-full", b, latency_ns=100, n_coros=96, **kw)
            switches = b.accesses
            if kw["coalesce"]:
                switches = b.accesses * max(
                    1 - (b.coalesce_spatial + b.coalesce_indep), 0.15)
            ctx_words = b.context_words_opt if kw["ctx_opt"] else b.context_words
            out.append([name, tag,
                        round(base / r.cycles_per_iter, 3),
                        round(switches / b.accesses, 3),
                        2 * ctx_words])
    return out


def table() -> str:
    return csv_table(
        ["bench", "stage", "perf_norm", "switches_norm", "ctx_ops_per_switch"],
        rows())


if __name__ == "__main__":
    print(table())
