"""Kernel micro-benchmarks of the ported coroutine kernels: shape sweeps,
coalescing stats, the depth solver and the context classification.

The rows are the reference's ``benchmarks/kernel_bench.py`` rows whose
kernels the port has (row and span gather, scatter-add, dense and paged
flash-decode, the MoE grouped matmul, the SSD scan, STREAM triad), and its
shared-prefix serving row, which drives the paged engine (on the card its
decode rounds and prefill chunks run as captured CUDA graphs).
The derived columns are what the reference reports: correctness against
the plain version, the coalescing ratio (paper §III-C), and the
latency-aware depth the scheduler solves (§III-D). ``us_per_call`` is the
device time of one guarded call (CUDA events around it, so the guard's
output scan is in it) on the card; with ``--device cpu``
it is the host time of the kernels' plain versions, which says nothing
about the card.

This is also a run-time feedback producer for the autotuner: measured
per-tile times are fed to `core.autotune.record_transfer` (adaptive rows)
and `observe_pipeline` (``--json``).

  python -m repro_torch.launch.kernel_bench            # CSV tables, on the GPU
  python -m repro_torch.launch.kernel_bench --json
  python -m repro_torch.launch.kernel_bench --device cpu
  python -m repro_torch.launch.kernel_bench --strict --json --trace OUT.json

``--strict`` turns off the guard's depth ladder (`core.guard.set_strict`):
any kernel failure or parity mismatch raises its typed error, so a clean
``--strict --json`` report shows zero backoffs in its ``substrate``
section. ``--trace`` exports the run's span trace as Chrome trace-event
JSON (open in https://ui.perfetto.dev).
"""
from __future__ import annotations

import argparse
import io
import json
import time
from typing import Iterable, List, Sequence

import numpy as np
import torch

from repro_torch.core import autotune, guard
from repro_torch.core.descriptors import plan_gather
from repro_torch.core.machine import get_machine
from repro_torch.core.schedule import TileProfile, achieved_bandwidth, solve_depth
from repro_torch.kernels.coro_gather.coro_gather import (
    row_gather,
    row_gather_plain,
    row_gather_spec,
    span_gather,
    span_gather_spec,
)
from repro_torch.kernels.coro_gather.ops import coro_gather
from repro_torch.kernels.coro_scatter_add.coro_scatter_add import (
    scatter_add_spec,
    scatter_add_unique,
)
from repro_torch.kernels.coro_scatter_add.ops import rmw_operands
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_spec,
    flash_decode,
    paged_decode_spec,
)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.moe_gmm.moe_gmm import gmm, gmm_spec, n_slices
from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK, ssd_scan, ssd_spec
from repro_torch.kernels.stream_copy.ops import stream_triad
from repro_torch.kernels.stream_copy.stream_copy import (
    triad,
    triad_plain,
    triad_spec,
)
from repro_torch.launch.gups import observed


def csv_table(header: Sequence[str], rows: Iterable[Sequence]) -> str:
    buf = io.StringIO()
    buf.write(",".join(map(str, header)) + "\n")
    for r in rows:
        buf.write(",".join(
            f"{x:.4g}" if isinstance(x, float) else str(x) for x in r) + "\n")
    return buf.getvalue()


def timed(fn, *args, repeats: int = 3, **kw):
    """(result, us_per_call) after one warm-up call: CUDA events around the
    calls on the card, the host clock on the CPU."""
    fn(*args, **kw)
    if args[0].device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            out = fn(*args, **kw)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) * 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6 / repeats


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def gather_rows(device) -> List[list]:
    rng = np.random.RandomState(0)
    out = []
    for n_rows, d, n_idx in ((512, 128, 256), (2048, 256, 512)):
        table = _tensor(rng.randn(n_rows, d).astype(np.float32), device)
        idx = _tensor(rng.randint(0, n_rows, n_idx).astype(np.int32), device)
        res, us = timed(coro_gather, table, idx, repeats=1)
        ok = bool(torch.equal(res, row_gather_plain(table, idx)))
        depth = autotune.last_choice("row_gather")
        out.append(["coro_gather", f"{n_rows}x{d}/{n_idx}", round(us, 1), ok,
                    depth])
    return out


COALESCE_PATTERNS = ("gups_random", "stream_unit", "hj_mixed")


def coalesce_patterns(rows: int = 4096, n: int = 512, seed: int = 1):
    """The reference's three index streams: uniform random, unit stride, and
    a hash-join mix (one run of 200/512 of the stream, then random ids)."""
    rng = np.random.RandomState(seed)
    run = n * 200 // 512
    return {
        "gups_random": rng.randint(0, rows, n),
        "stream_unit": np.arange(n),
        "hj_mixed": np.concatenate([np.arange(100, 100 + run),
                                    rng.randint(0, rows, n - run)]),
    }


def coalesce_rows() -> List[list]:
    out = []
    for name, idx in coalesce_patterns().items():
        plan = plan_gather(idx, span=8)
        out.append(["coalesce", name, plan.n_requests,
                    plan.requests_issued(), round(plan.coalescing_ratio(), 3)])
    return out


def schedule_rows() -> List[list]:
    out = []
    for tag, tile_bytes, flops in (("gather_row", 8 * 2048 * 4, 64 * 8),
                                   ("kv_block", 2 * 128 * 8 * 128 * 2,
                                    4 * 128 * 96 * 128),
                                   ("stream_tile", 2 * 128 * 512 * 4,
                                    128 * 512)):
        p = TileProfile(tile_bytes=tile_bytes, flops_per_tile=float(flops))
        d = solve_depth(p)
        bw = achieved_bandwidth(p, d) / 1e9
        bw2 = achieved_bandwidth(p, 2) / 1e9
        out.append(["depth_solver", tag, d, round(bw, 1), round(bw2, 1)])
    return out


def adaptive_rows(device) -> List[list]:
    """Feed measured per-tile times back into the autotuner: the feedback
    path re-solves from the observed latency instead of the data-sheet
    constant. The tile is big enough that the static solve sits below the
    request-slot cap, so a slower observation shows as a deeper solve."""
    rng = np.random.RandomState(3)
    table = _tensor(rng.randn(512, 512).astype(np.float32), device)
    idx = _tensor(rng.randint(0, 512, 64).astype(np.int32), device)
    rows_per_tile = 8
    profile = autotune.profile_row_gather(rows_per_tile, 512, 4)
    static = autotune.choose_depth(profile, kernel="row_gather_bench")

    n_tiles = idx.shape[0] // rows_per_tile
    autotune.clear_samples("row_gather_bench")
    for _ in range(5):
        _, us = timed(coro_gather, table, idx, repeats=1,
                      rows_per_tile=rows_per_tile)
        autotune.record_transfer("row_gather_bench", us * 1e-6 / n_tiles)
    adaptive = autotune.choose_depth(profile, kernel="row_gather_bench")
    n = len(autotune.transfer_samples("row_gather_bench"))
    autotune.clear_samples("row_gather_bench")
    return [["adaptive_depth", "row_gather", n, static, adaptive]]


def context_rows() -> List[list]:
    """Derived context per ported kernel family (the §III-B classification):
    the depth the autotuner solves from the spec, the classified context
    bytes at that depth, the all-private baseline, and their ratio."""
    f32 = torch.float32
    specs = (
        row_gather_spec(8, 128, f32),
        scatter_add_spec(8, 128, f32),
        decode_spec(128, 8, 12, 128, f32),
        gmm_spec(64, 512, 128, f32, f_total=2048),
        ssd_spec(64, 8, 64, 128, f32, seq_len=2048),
        triad_spec(128, 512, f32),
    )
    out = []
    for spec in specs:
        depth = autotune.choose_depth(spec.profile(), vars=spec.all_vars())
        opt = spec.context_bytes(depth)
        base = spec.context_bytes(depth, baseline=True)
        out.append([spec.name, depth, opt, base, round(opt / base, 3)])
    return out


def triad_rows(device) -> List[list]:
    rng = np.random.RandomState(2)
    b = _tensor(rng.randn(1024, 64).astype(np.float32), device)
    c = _tensor(rng.randn(1024, 64).astype(np.float32), device)
    res, us = timed(stream_triad, b, c, 2.5, repeats=1)
    ok = bool(torch.allclose(res, triad_plain(b, c, 2.5), rtol=1e-5,
                             atol=1e-5))
    return [["stream_triad", "1024x64", round(us, 1), ok,
             autotune.last_choice("stream_triad")]]


def paged_decode_rows(device) -> List[list]:
    """Paged vs dense decode kernel at EQUAL total KV.

    The same [B, S] worth of KV is served once as dense per-request caches
    and once as a shuffled block pool addressed through block tables. The
    row reports the paged spec's classified context bytes, the depth the
    paged kernel ran (in pages), and tokens/s of both kernels: from the
    device time of one call on the card, from the plain versions' host time
    with ``--device cpu``."""
    rng = np.random.RandomState(4)
    out = []
    for bsz, s, kh, h, d, blk in ((2, 256, 2, 8, 16, 64),):
        q = rng.randn(bsz, h, d).astype(np.float32)
        k = rng.randn(bsz, s, kh, d).astype(np.float32)
        v = rng.randn(bsz, s, kh, d).astype(np.float32)
        # carve the same KV into a block pool with shuffled page placement
        m = s // blk
        nb = bsz * m + 1  # + garbage page 0
        ids = rng.permutation(np.arange(1, nb)).reshape(bsz, m)
        kp = np.zeros((nb, blk, kh, d), np.float32)
        vp = np.zeros((nb, blk, kh, d), np.float32)
        kp[ids.reshape(-1)] = k.reshape(bsz * m, blk, kh, d)
        vp[ids.reshape(-1)] = v.reshape(bsz * m, blk, kh, d)
        q, k, v, kp, vp = (_tensor(a, device) for a in (q, k, v, kp, vp))
        bt = _tensor(ids.astype(np.int32), device)
        lens = _tensor(np.full((bsz,), s, np.int32), device)

        _, us_dense = timed(decode_attention, q, k, v, s - 1, blk=blk,
                            repeats=1)
        res, us_paged = timed(paged_decode_attention, q, kp, vp, bt, lens,
                              repeats=1)
        want = decode_attention(q, k, v, s - 1, blk=blk)
        # the reference's 2e-5 between its two kernels; on the card the two
        # split the rows differently, and are held to chip_smoke's f32 2e-4
        tol = 2e-5 if device.type == "cpu" else 2e-4
        if not torch.allclose(res, want, rtol=tol, atol=tol):
            raise AssertionError("paged decode disagrees with dense decode")
        g = h // kh
        spec = paged_decode_spec(blk, kh, g, d, torch.float32, m)
        depth = autotune.last_choice("paged_decode")
        out.append(["paged_decode", f"{bsz}x{s}x{kh}x{d}/blk{blk}",
                    spec.context_bytes(depth), depth,
                    round(bsz / (us_paged * 1e-6), 1),
                    round(bsz / (us_dense * 1e-6), 1)])
    return out


def prefix_decode_rows(device) -> List[list]:
    """Shared-prefix serving at EQUAL KV budget, cache warm vs cold.

    The same 6-request workload (all opening with a 3-block system prompt)
    runs through the paged engine twice — prefix cache on, then off — with
    identical pool size and params. The row reports the warm run's hit
    rate, pages dedup'd, blocks allocated warm/cold and decode tokens/s for
    both runs (the host's wall clock around the rounds; the dedup counters
    are the point)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServingEngine

    cfg = get_config("yi-6b").reduced().replace(dtype="float32",
                                                param_dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, device)
    rng = np.random.RandomState(5)
    blk, new = 4, 6
    shared = list(rng.randint(0, cfg.vocab, 3 * blk))
    prompts = [shared + list(rng.randint(0, cfg.vocab, 3 + i))
               for i in range(6)]

    def run(prefix_cache):
        eng = PagedServingEngine(cfg, block_size=blk, num_blocks=48,
                                 params=params, max_in_flight=2,
                                 prefix_cache=prefix_cache, device=device)
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        return eng.run()

    warm, cold = run(True), run(False)
    hit_rate = warm["prefix_hits"] / max(warm["requests"], 1)
    return [["prefix_decode", f"{len(prompts)}req/blk{blk}",
             round(hit_rate, 3), warm["blocks_shared"],
             f"{warm['blocks_allocated']}/{cold['blocks_allocated']}",
             warm["decode_tok_per_s"], cold["decode_tok_per_s"]]]


def _json_workloads(device):
    """One small run per ported kernel: (spec for the static solve, tiles,
    thunk). Shapes mirror what the thunk launches; each thunk prepares the
    kernel's operands (padding, dedup, the plan) outside the timed call."""
    rng = np.random.RandomState(7)
    f32 = torch.float32
    table_g = _tensor(rng.randn(256, 128).astype(np.float32), device)
    idx_g = _tensor(rng.randint(0, 256, 64).astype(np.int32), device)
    run = np.arange(40, 104)                     # 64 rows: 8 spans of 8
    starts = _tensor(plan_gather(run, span=8).span_starts, device)
    table_s = _tensor(rng.randn(256, 128).astype(np.float32), device)
    idx_s = rng.randint(0, 256, 32)
    upd_s = _tensor(rng.randn(32, 128).astype(np.float32), device)
    uniq, summed = rmw_operands(table_s, idx_s, upd_s, 8)
    n_s = uniq.shape[0] // 8
    q = _tensor(rng.randn(2, 8, 16).astype(np.float32), device)
    k = _tensor(rng.randn(2, 128, 2, 16).astype(np.float32), device)
    v = _tensor(rng.randn(2, 128, 2, 16).astype(np.float32), device)
    n_kv = 2 * 2 * 2                  # (sequence, KV head) blocks x 64-row tiles
    xs = _tensor(rng.randn(2, 16, 64).astype(np.float32), device)
    w = _tensor(rng.randn(2, 64, 256).astype(np.float32), device)
    n_w = 2 * (256 // 128) * n_slices(64, 4)     # weight k-slices streamed
    x = _tensor(rng.randn(1, 128, 2, 8).astype(np.float32), device)
    dt = _tensor(rng.rand(1, 128, 2).astype(np.float32), device)
    a = _tensor(-np.abs(rng.randn(2)).astype(np.float32), device)
    bm = _tensor(rng.randn(1, 128, 16).astype(np.float32), device)
    cm = _tensor(rng.randn(1, 128, 16).astype(np.float32), device)
    n_x = 2 * (128 // CHUNK[f32])     # (chunk, head) tiles of x streamed
    tb = _tensor(rng.randn(256, 64).astype(np.float32), device)
    tc = _tensor(rng.randn(256, 64).astype(np.float32), device)
    return [
        (row_gather_spec(8, 128, f32), 8,
         lambda: observed("row_gather", 8, row_gather, table_g, idx_g)),
        (span_gather_spec(8, 128, f32), 8,
         lambda: observed("span_gather", 8, span_gather, table_g, starts,
                          span=8)),
        (scatter_add_spec(8, 128, f32), n_s,
         lambda: observed("scatter_add", n_s, scatter_add_unique,
                          table_s.clone(), uniq, summed)),
        (decode_spec(64, 2, 4, 16, f32), n_kv,
         lambda: observed("flash_decode", n_kv, flash_decode, q, k, v, 127,
                          blk=64)),
        (gmm_spec(16, 64, 128, f32, f_total=256), n_w,
         lambda: observed("moe_gmm", n_w, gmm, xs, w)),
        (ssd_spec(64, 2, 8, 16, f32, seq_len=128), n_x,
         lambda: observed("ssd_scan", n_x, ssd_scan, x, dt, a, bm, cm,
                          chunk=64)),
        (triad_spec(128, 64, f32), 2,
         lambda: observed("stream_triad", 2, triad, tb, tc, 2.5)),
    ]


def json_report(device) -> dict:
    """Machine-stamped report: active profile, per-kernel static solve vs
    the depth actually run, and the observed p99 per-tile time from the
    telemetry the runs fed (on the card; the CPU feeds none). Each workload
    runs twice: the first run is warm-up (dropped by the warm-up skip)."""
    from repro_torch.obs import metrics as obs_metrics

    m = get_machine()
    workloads = _json_workloads(device)
    for _, _, run in workloads:
        run()
        run()
    summ = autotune.telemetry_summary()
    kernels = {}
    for spec, _, _ in workloads:
        t = summ["kernels"].get(spec.name, {})
        # choose_depth AFTER the runs so it reports the static solve without
        # disturbing the telemetry the runs recorded
        kernels[spec.name] = {
            "static_depth": autotune.choose_depth(spec.profile(),
                                                  vars=spec.all_vars()),
            "ran_depth": t.get("depth"),
            "mode": t.get("mode"),
            "samples": t.get("samples", 0),
            "observed_p99_us": t.get("p99_us"),
            "breakdown": t.get("breakdown"),
        }
    return {"machine": m.name, "profile": m.summary(),
            "device": str(device), "kernels": kernels,
            "substrate": guard.stats(),
            "metrics": obs_metrics.default_registry().snapshot()}


def table(device) -> str:
    s = f"# device: {device}\n"
    s += csv_table(["kernel", "shape", "us_per_call", "allclose", "auto_depth"],
                   gather_rows(device) + triad_rows(device))
    s += csv_table(["pass", "pattern", "requests", "issued", "ratio"],
                   coalesce_rows())
    s += csv_table(["pass", "tile", "depth", "GBps_at_depth", "GBps_at_2"],
                   schedule_rows())
    s += csv_table(["pass", "kernel", "samples", "static_depth",
                    "adaptive_depth"], adaptive_rows(device))
    s += csv_table(["spec", "depth", "ctx_bytes", "ctx_baseline", "ratio"],
                   context_rows())
    return s + paged_table(device)


def paged_table(device) -> str:
    """The paged rows' tables: paged vs dense decode, prefix cache warm vs
    cold."""
    s = csv_table(["pass", "shape", "ctx_bytes", "depth", "tok_per_s",
                   "dense_tok_per_s"], paged_decode_rows(device))
    s += csv_table(["pass", "workload", "hit_rate", "blocks_shared",
                    "alloc_warm/cold", "tok_per_s_warm", "tok_per_s_cold"],
                   prefix_decode_rows(device))
    return s


def main(argv=None):
    from repro_torch.serve.engine import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true",
                    help="machine-stamped JSON report instead of CSV tables")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export the bench run's span trace as Chrome "
                         "trace-event JSON (open in https://ui.perfetto.dev)")
    ap.add_argument("--strict", action="store_true",
                    help="disable substrate degradation: any kernel "
                         "backoff or parity mismatch raises its typed "
                         "SubstrateError instead")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.strict:
        guard.set_strict(True)
    if args.json:
        text = json.dumps(json_report(device), indent=2)
    else:
        text = table(device)
    print(text)
    if args.trace:
        from repro_torch.obs import trace as obs_trace

        obs_trace.get_tracer().export(args.trace)
    return text


if __name__ == "__main__":
    main()
