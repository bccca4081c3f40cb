"""GUPS launcher: the paper's flagship benchmark through the coroutine
kernels, plus the calibrated model's predicted speedups at
disaggregated-memory latencies.

GUPS is a random row gather followed by a deduplicated read-modify-write
scatter (`gups_round`), both through the hand-written CUDA kernels on the
card (their plain versions on the CPU). The default run prints what the
reference's ``examples/gups_coro.py`` prints: the depths the autotuner chose
and their context bytes, the coalescing ratio of the random stream, the
depth solve at 200 and 800 ns, and the model's GUPS speedups. ``--smoke``
prints instead the one JSON record of the reference's
``scripts/machine_smoke.py``: the solved and the launched row-gather depth
under the active machine profile (``REPRO_MACHINE``).

It runs on the GPU unless asked for the CPU:

  python -m repro_torch.launch.gups
  python -m repro_torch.launch.gups --device cpu
  REPRO_MACHINE=v5e-far-800ns python -m repro_torch.launch.gups --smoke
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import autotune, sim
from repro_torch.core.descriptors import plan_gather
from repro_torch.core.machine import get_machine
from repro_torch.core.schedule import achieved_bandwidth, solve_depth
from repro_torch.kernels.coro_gather.coro_gather import (
    row_gather,
    row_gather_spec,
)
from repro_torch.kernels.coro_gather.ops import coro_gather, padded_indices
from repro_torch.kernels.coro_scatter_add.coro_scatter_add import (
    scatter_add_spec,
    scatter_add_unique,
)
from repro_torch.kernels.coro_scatter_add.ops import rmw_operands

PAPER_GUPS = {200: "29.0", 800: "59.8"}   # paper's reported speedups


def observed(kernel: str, n_tiles: int, fn: Callable, *args, **kw):
    """Run the kernel wrapper `fn` on operands already on the device; on the
    card, feed its device time (CUDA events around the call) to
    `autotune.observe_pipeline`, the always-on transfer telemetry, as one
    sample over `n_tiles` tiles. Host passes in front of a kernel (dedup,
    padding, copies) stay outside the call. The CPU runs plain versions,
    whose times are not transfer samples."""
    dev = args[0].device
    if dev.type != "cuda":
        return fn(*args, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kw)
    end.record()
    end.synchronize()
    autotune.observe_pipeline(kernel, start.elapsed_time(end) / 1e3, n_tiles)
    return out


def gups_round(table: torch.Tensor, idx, updates, *,
               depth: Optional[int] = None, rows_per_tile: int = 8):
    """One GUPS round: gathered = table[idx], then updated = table with
    updates[i] added at idx[i] (duplicates combined first). Returns
    (gathered, updated); `table` is left as it was. It does what
    `coro_gather` and `coro_scatter_add` do, and times only their two
    kernel calls as transfer samples."""
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    rows = padded_indices(idx, table.device, rows_per_tile)
    gathered = observed("row_gather", rows.shape[0] // rows_per_tile,
                        row_gather, table, rows, depth=depth,
                        rows_per_tile=rows_per_tile)[:len(idx)]
    uniq, summed = rmw_operands(table, idx, updates, rows_per_tile)
    updated = observed("scatter_add", uniq.shape[0] // rows_per_tile,
                       scatter_add_unique, table.clone(), uniq, summed,
                       depth=depth, rows_per_tile=rows_per_tile)
    return gathered, updated


def machine_line() -> str:
    m = get_machine()
    return (f"machine profile: {m.name} "
            f"(hbm latency {m.hbm_latency_s * 1e9:.0f}ns, "
            f"{m.hbm_bw / 1e9:.0f} GB/s, {m.request_slots} request slots; "
            f"switch with REPRO_MACHINE=v5e-far-800ns)")


def gups_example(device, *, rows: int = 1024, d: int = 128, n: int = 256,
                 seed: int = 0, out: Callable[[str], None] = print) -> Dict:
    """The reference example at a [rows, d] f32 table and n indices, on
    `device`: prints its lines through `out` and returns its numbers."""
    out(machine_line())
    rng = np.random.RandomState(seed)
    table = torch.as_tensor(rng.randn(rows, d).astype(np.float32),
                            device=device)
    idx = rng.randint(0, rows, n).astype(np.int32)
    upd = torch.as_tensor((rng.randn(n, d) * 0.1).astype(np.float32),
                          device=device)

    gathered, updated = gups_round(table, idx, upd)
    dups = n - len(np.unique(idx))
    out(f"gather ok: {tuple(gathered.shape)}; update ok: "
        f"{tuple(updated.shape)} (dedup handled {dups} duplicate rows)")

    res: Dict = {"gathered": gathered, "updated": updated, "depths": {}}
    for spec, key in ((row_gather_spec(8, d, torch.float32), "row_gather"),
                      (scatter_add_spec(8, d, torch.float32), "scatter_add")):
        depth = autotune.last_choice(key)
        ctx, base = spec.context_bytes(depth), spec.context_bytes(
            depth, baseline=True)
        res["depths"][key] = (depth, ctx, base)
        out(f"{key}: chose depth {depth}; derived context {ctx} B "
            f"(all-private baseline {base} B)")

    plan = plan_gather(idx, span=8)
    res["coalescing"] = (plan.n_requests, plan.requests_issued(),
                         plan.coalescing_ratio())
    out(f"coalescing on random indices: {plan.n_requests} -> "
        f"{plan.requests_issued()} requests (random barely coalesces, "
        "as the paper observes for GUPS)")

    # latency-aware depth: the dynamic-scheduler analogue
    p = autotune.profile_row_gather(8, d, 4)
    res["depth_solve"] = {}
    for lat_ns in (200, 800):
        dep = solve_depth(p, latency_s=lat_ns * 1e-9)
        bw = achieved_bandwidth(p, dep, latency_s=lat_ns * 1e-9) / 1e9
        bw2 = achieved_bandwidth(p, 2, latency_s=lat_ns * 1e-9) / 1e9
        res["depth_solve"][lat_ns] = (dep, bw, bw2)
        out(f"{lat_ns}ns: depth {dep} sustains {bw:.0f} GB/s "
            f"(double-buffer only: {bw2:.0f} GB/s)")

    # the paper's reported result, from the calibrated model
    g = sim.BENCHES["GUPS"]
    res["sim"] = {}
    for lat in (200, 800):
        s = sim.speedup("coroamu-full", g, latency_ns=lat)
        res["sim"][lat] = s
        out(f"CoroAMU-Full GUPS @{lat}ns: {s:.1f}x over serial "
            f"(paper: {PAPER_GUPS[lat]}x)")

    res["telemetry"] = autotune.telemetry_summary()
    out(f"telemetry: {res['telemetry']}")
    return res


def machine_smoke(device) -> Dict:
    """The machine profile reaches the depth solver end to end: the
    unclamped solved row-gather depth and the depth one launched gather ran
    (clamped to its tile count), under the active profile."""
    m = get_machine()
    spec = row_gather_spec(8, 128, torch.float32)
    solved = autotune.choose_depth(spec.profile(), vars=spec.all_vars())
    rng = np.random.RandomState(0)
    table = torch.as_tensor(rng.randn(64, 128).astype(np.float32),
                            device=device)
    idx = torch.as_tensor(rng.randint(0, 64, 32).astype(np.int32),
                          device=device)
    got = coro_gather(table, idx)
    if tuple(got.shape) != (32, 128) or not torch.equal(got,
                                                        table[idx.long()]):
        raise AssertionError("coro_gather disagrees with table[idx]")
    return {"machine": m.name,
            "hbm_latency_ns": round(m.hbm_latency_s * 1e9, 1),
            "solved_depth": solved,
            "ran_depth": autotune.last_choice("row_gather"),
            "device": str(got.device)}


def main(argv=None):
    from repro_torch.serve.engine import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--rows", type=int, default=1024, help="table rows")
    ap.add_argument("--d", type=int, default=128, help="table row width (f32)")
    ap.add_argument("--n", type=int, default=256, help="indices per round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="print the machine-profile smoke record instead")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        rec = machine_smoke(device)
        print(json.dumps(rec))
        return rec
    return gups_example(device, rows=args.rows, d=args.d, n=args.n,
                        seed=args.seed)


if __name__ == "__main__":
    main()
