"""Fig. 12: full-system speedup vs far-memory latency on NH-G.

Paper: CoroAMU-Full averages 3.39x @200ns and 4.87x @800ns over serial
(up to 29.0x / 59.8x on GUPS). CoroAMU-S is labeled at its best coroutine
count; -D/-Full run 96 coroutines.

Each row also reports the pipeline depth the substrate would solve for
that latency (`schedule.solve_depth` on the GUPS-like row-gather tile,
under the active machine profile; the column keeps the reference table's
name, ``tpu_depth``) — the §III-D point in one column: the chosen depth
tracks latency instead of being tuned for one value.
"""
from __future__ import annotations

from repro_torch.core import autotune, sim
from repro_torch.core.schedule import solve_depth
from repro_torch.launch.kernel_bench import csv_table

LATENCIES = (100, 200, 400, 800)

# the GUPS analogue: 8 random rows of a [*, 128] f32 table per tile
GATHER_PROFILE = autotune.profile_row_gather(8, 128, 4)


def rows():
    out = []
    for lat in LATENCIES:
        depth = solve_depth(GATHER_PROFILE, latency_s=lat * 1e-9)
        for variant in ("coroamu-s", "coroamu-d", "coroamu-full"):
            per = {}
            for name, b in sim.BENCHES.items():
                n = (sim.best_coros(variant, b, latency_ns=lat)
                     if variant == "coroamu-s" else 96)
                per[name] = sim.speedup(variant, b, latency_ns=lat, n_coros=n)
            out.append([lat, variant,
                        *(round(per[n], 2) for n in sim.BENCHES),
                        round(sim.geomean(list(per.values())), 2),
                        depth])
    return out


def table() -> str:
    return csv_table(
        ["latency_ns", "variant", *sim.BENCHES, "geomean", "tpu_depth"],
        rows())


if __name__ == "__main__":
    print(table())
