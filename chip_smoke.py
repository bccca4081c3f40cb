#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the serving and GUPS paths from the sources
     in the checkout (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card: paged
     decode at yi-6b, granite-3-2b, internlm2-20b, head_dim-16 and
     one-KV-head shapes (1 to 32 query heads per KV head), ragged
     lengths plus a zero-length padding row, f32 (tolerance 2e-3) and bf16
     (3e-2), at depths 1, 2 and the solved depth; the row and span
     gathers in f32, bf16 and int32, 1/4/8 rows per tile, depths 1, 2 and
     solved, an index count off the tile, rows of 16-byte, 4-byte and
     (bf16) 2-byte units, and the coalesced gather of the gups_random,
     stream_unit and hj_mixed streams (all bitwise); the scatter-add with
     duplicates through its op in f32 (2e-3) and bf16 (3e-2), and the
     kernel on deduplicated rows (bitwise, 16- and 2-byte units); the triad
     in f32 (1e-5) and bf16 (2e-2);
  4. a reduced yi-6b engine in f32 on the card against the same engine on
     the CPU (same parameters, same prompts, round width pinned): the
     greedy tokens must be identical;
  5. the main path: `serve_paged` for yi-6b at full width with the serving
     layout (bf16), 8 requests, prompts of 64-256 tokens (half share a
     system prefix), 32 new tokens each, prefix cache on. Launch counts are
     zeroed just before and read just after; every request must finish and
     the paged-decode kernel must run n_layers times per decode round;
  6. times at the main path's decode shapes (CUDA events around one call
     per layer, queued behind a device sleep; median of 21 batches): the
     kernel, its plain version, and as a yardstick
     `scaled_dot_product_attention` over K/V gathered beforehand (it
     excludes the page gather); the bound is the larger of the live K/V
     bytes over 3.35 TB/s and the flops over 989 TFLOP/s (data sheet);
  7. a profile of full-width decode rounds (torch.profiler): device time
     by kernel per round and the device's busy share of the wall clock;
  8. the GUPS path at a real size, through `repro_torch.launch.gups` and the
     ops: a 2^24 x 128 f32 table (8 GiB, far past the 50 MB L2), 2^22
     seeded uniform-random indices gathered and then scatter-added, a
     coalesced gather of a 2^22 hj_mixed-style stream, and a triad over
     three [2^21, 128] f32 arrays (1 GiB each). Launch counts are zeroed
     just before and read just after and must be what the calls imply; the
     gather must equal table[idx] bitwise and the updated table the plain
     scatter-add; peak device memory is printed;
  9. times of the four GUPS-path kernels at phase 8's shapes (the same
     method as phase 6): kernel, plain version, and as a yardstick the
     PyTorch call for the same function (index_select, index_select over
     the expanded span rows, index_add_ on the deduplicated rows,
     torch.add(b, c, alpha=s)); each bound is the bytes the function must
     move over 3.35 TB/s (or its flops over 67 TFLOP/s f32, if larger);
     then the same kernels at other depths (tiles in flight per block) and
     the triad at other tile heights, each time beside its bound;
 10. one JSON line describing every kernel, then the result line.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BW = 3.35e12          # H100 SXM data sheet, bytes/s
PEAK = {"bfloat16": 989e12, "float32": 67e12}   # data sheet, dense
TOL = {"float32": 2e-3, "bfloat16": 3e-2}
PARITY_LENGTHS = [1, 15, 16, 17, 300, 2048]
HEAD_SHAPES = [("yi-6b", 32, 4, 128), ("granite-3-2b", 32, 8, 64),
               ("head_dim-16", 4, 2, 16), ("internlm2-20b", 48, 8, 128),
               ("one-kv-head", 32, 1, 64)]
SERVE = dict(batch=8, prompt_len=256, gen=32, block_size=16)
# The GUPS path (HPCC RandomAccess, cut to one batch of 2^22 updates of
# 512 B rows) and the STREAM triad arrays (each over 4x the caches).
GUPS = dict(rows=1 << 24, d=128, n=1 << 22, triad_rows=1 << 21, scalar=3.0)
TRIAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GUPS_KERNELS = (   # name, CUDA source, TPU kernel it replaces
    ("row_gather", "coro_gather/csrc/coro_gather.cu",
     "coro_gather/coro_gather.py:56"),
    ("span_gather", "coro_gather/csrc/coro_gather.cu",
     "coro_gather/coro_gather.py:82"),
    ("scatter_add", "coro_scatter_add/csrc/scatter_add.cu",
     "coro_scatter_add/coro_scatter_add.py:49"),
    ("stream_triad", "stream_copy/csrc/triad.cu",
     "stream_copy/stream_copy.py:40"),
)
F32_PEAK = 67e12                 # data sheet, f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def card_info(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return line


# ------------------------------------------------------------------ phase 2


def build_kernels():
    from repro_torch.kernels import build
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.stream_copy import stream_copy as sc

    t0 = time.perf_counter()
    libs = build.build([da.SOURCE, cg.SOURCE, sa.SOURCE, sc.SOURCE])
    log(f"built {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")


# ------------------------------------------------------------------ phase 3


def paged_problem(torch, gen, lengths, *, h, kh, d, blk, dtype, device,
                  pad_row=True):
    """Random pools and disjoint shuffled block tables for the ragged
    `lengths`, plus (optionally) a zero-length padding row on page 0."""
    nb_per = [-(-n // blk) for n in lengths]
    m = max(nb_per)
    total = sum(nb_per)
    nb = total + 4                                   # + garbage page 0 + spare
    q = torch.randn(len(lengths) + pad_row, h, d, generator=gen,
                    device=device).to(dtype)
    kp = torch.randn(nb, blk, kh, d, generator=gen, device=device).to(dtype)
    vp = torch.randn(nb, blk, kh, d, generator=gen, device=device).to(dtype)
    ids = (torch.randperm(nb - 1, generator=gen, device=device) + 1)[:total]
    bt = torch.zeros(len(lengths) + pad_row, m, dtype=torch.int32,
                     device=device)
    off = 0
    for r, n in enumerate(nb_per):
        bt[r, :n] = ids[off:off + n]
        off += n
    lens = torch.tensor(list(lengths) + [0] * pad_row, dtype=torch.int32,
                        device=device)
    return q, kp, vp, bt, lens


def check_parity(torch) -> float:
    from repro_torch.kernels.decode_attention import decode_attention as da

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    for name, h, kh, d in HEAD_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            tol = TOL[dtype_name]
            q, kp, vp, bt, lens = paged_problem(
                torch, gen, PARITY_LENGTHS, h=h, kh=kh, d=d, blk=16,
                dtype=dtype, device="cuda")
            ref = da.paged_flash_decode_plain(q, kp, vp, bt, lens).float()
            for depth in (1, 2, None):
                out = da.paged_flash_decode(q, kp, vp, bt, lens, depth=depth)
                torch.cuda.synchronize()
                out = out.float()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{name} {dtype_name} depth={depth}: "
                                         "non-finite output")
                err = float((out[:-1] - ref[:-1]).abs().max())
                ok = torch.allclose(out[:-1], ref[:-1], rtol=tol, atol=tol)
                log(f"parity {name:13s} {dtype_name:8s} depth={depth} "
                    f"max_abs_err={err:.3e} tol={tol:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"paged_decode disagrees with its "
                                         f"plain version: {name} {dtype_name} "
                                         f"depth={depth} err={err:.3e}")
                worst = max(worst, err / tol)
    return worst


# ------------------------------------------------------------------ phase 4


def check_engine_card_vs_cpu(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import build_model

    cfg = get_config("yi-6b").reduced().replace(dtype="float32",
                                                param_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params_cpu = build_model(cfg).init(gen, "cpu")

    def to_card(tree):
        return {k: (to_card(v) if isinstance(v, dict) else v.to("cuda"))
                for k, v in tree.items()}

    kw = dict(batch=4, prompt_len=40, gen=12, block_size=4, seed=1,
              max_in_flight=3)
    cpu = serve_paged(cfg, device="cpu", params=params_cpu, **kw)
    reset_launch_counts()
    card = serve_paged(cfg, device="cuda", params=to_card(params_cpu), **kw)
    launches = launch_counts()["paged_decode"]
    if cpu["generated"] != card["generated"]:
        raise AssertionError(f"card tokens {card['generated']} != CPU tokens "
                             f"{cpu['generated']}")
    if launches <= 0:
        raise AssertionError("the card engine never launched paged_decode")
    log(f"engine f32 card == cpu: {sum(map(len, card['generated']))} tokens "
        f"identical, paged_decode launches {launches}")


# ------------------------------------------------------------------ phase 5


def serve_main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SERVING_OVERRIDES, serve_paged

    cfg = get_config("yi-6b").replace(**SERVING_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launch_counts()
    stats = serve_paged(cfg, device="cuda", **SERVE)
    counts = launch_counts()
    wall = time.perf_counter() - t0
    n = SERVE["batch"]
    bad = {k: stats[k] for k in ("failed", "cancelled", "stalled") if stats[k]}
    if stats["completed"] != n or bad or \
            any(s != "finished" for s in stats["states"]):
        raise AssertionError(f"not every request finished: completed "
                             f"{stats['completed']}/{n}, {bad}, "
                             f"{stats['states']}")
    want = cfg.n_layers * stats["decode_rounds"]
    if counts["paged_decode"] != want or want == 0:
        raise AssertionError(f"paged_decode launched {counts['paged_decode']} "
                             f"times, want n_layers x decode rounds = {want}")
    for toks in stats["generated"]:
        if len(toks) != SERVE["gen"] or not all(0 <= t < cfg.vocab
                                                for t in toks):
            raise AssertionError(f"bad generation {toks}")
    shown = {k: stats[k] for k in (
        "decode_tok_per_s", "ttft_p50_ms", "ttft_p99_ms", "tbt_p50_ms",
        "tbt_p99_ms", "p50_ms", "p99_ms", "round_width", "solved_depth",
        "decode_rounds", "rounds", "prefill_chunks", "prefix_hits",
        "cow_forks", "preemptions", "prefill_s", "decode_s", "prompt_lens")}
    shown["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    shown["wall_s"] = wall
    log("serve yi-6b full width: " + json.dumps(shown))
    return cfg, stats, counts


# ------------------------------------------------------------------ phase 6


def median_ms(torch, fn, args_list, repeats=21):
    """Device time of one call of `fn`, median over `repeats` batches. Each
    batch calls `fn` once per entry of `args_list` (one entry per layer, so
    the working set exceeds the 50 MB L2, as in a decode round) between two
    CUDA events, queued behind a device-side sleep so that host overhead
    does not leave the device idle inside the timed window."""
    for a in args_list[:4]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(60_000_000)        # ~30 ms of device time
        start.record()
        for a in args_list:
            fn(*a)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(args_list))
    return statistics.median(times)


def time_kernel(torch, cfg, stats):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as da

    blk = SERVE["block_size"]
    width = stats["round_width"]
    lens = sorted(stats["prompt_lens"])[-width:]
    lengths = [n + SERVE["gen"] // 2 for n in lens]    # mid-generation
    h, kh, d = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    m = -(-(SERVE["prompt_len"] + SERVE["gen"]) // blk)
    nb = width * m + 1
    layers = []
    for _ in range(cfg.n_layers):
        q = torch.randn(width, h, d, generator=gen, device="cuda").to(dtype)
        kp = torch.randn(nb, blk, kh, d, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(nb, blk, kh, d, generator=gen, device="cuda").to(dtype)
        perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
        bt = perm[: width * m].reshape(width, m).to(torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        layers.append((q, kp, vp, bt, ln))

    # agreement on exactly these inputs
    q, kp, vp, bt, ln = layers[0]
    out = da.paged_flash_decode(q, kp, vp, bt, ln)
    ref = da.paged_flash_decode_plain(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), rtol=TOL["bfloat16"],
                          atol=TOL["bfloat16"]):
        raise AssertionError(f"paged_decode disagrees at the main path's "
                             f"shapes: max_abs_err={err:.3e}")

    # the yardstick: SDPA over K/V gathered (and masked) beforehand
    s_len = m * blk
    gathered = []
    for q, kp, vp, bt, ln in layers:
        k = kp[bt.long()].reshape(width, s_len, kh, d).transpose(1, 2)
        v = vp[bt.long()].reshape(width, s_len, kh, d).transpose(1, 2)
        mask = (torch.arange(s_len, device="cuda")[None, :]
                < ln.long()[:, None])[:, None, None, :]
        gathered.append((q[:, :, None], k.contiguous(), v.contiguous(), mask))

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    depth = stats["solved_depth"]

    def kernel(*a):
        return da.paged_flash_decode(*a, depth=depth)

    kernel_a = median_ms(torch, kernel, layers)
    plain_ms = median_ms(torch, da.paged_flash_decode_plain, layers)
    library_ms = median_ms(torch, sdpa, gathered)
    kernel_b = median_ms(torch, kernel, layers)
    ms = statistics.median([kernel_a, kernel_b])

    itemsize = 2
    kv_bytes = 2 * sum(lengths) * kh * d * itemsize       # K and V rows < len
    io_bytes = 2 * width * h * d * itemsize + bt.numel() * 4 + ln.numel() * 4
    bytes_s = (kv_bytes + io_bytes) / HBM_BW
    flops = 4 * h * d * sum(lengths)                      # q.k and p.v
    ops_s = flops / PEAK["bfloat16"]
    bound_ms = max(bytes_s, ops_s) * 1e3
    log(f"times at B={width} H={h} KH={kh} D={d} blk={blk} M={m} "
        f"lengths={lengths}: kernel {kernel_a:.4f}/{kernel_b:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa (pre-gathered, no page gather) "
        f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({kv_bytes + io_bytes} B, {flops} flop)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "shape": {"B": width, "H": h, "KH": kh, "D": d, "blk": blk,
                      "M": m, "lengths": lengths, "dtype": "bfloat16"}}


# ------------------------------------------------------------------ phase 7


def profile_decode_rounds(torch, cfg, width, rounds=4):
    """Where a decode round's time goes at the main path's widths: an
    engine with one full round of `width` requests, all prefilled; `rounds` rounds
    timed on the host clock, then `rounds` more under torch.profiler for
    the device time by kernel. Busy share = device time per round over the
    unprofiled wall clock per round."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import PagedServingEngine

    new = 64
    blocks = -(-(SERVE["prompt_len"] + new) // SERVE["block_size"])
    eng = PagedServingEngine(cfg, block_size=SERVE["block_size"],
                             num_blocks=width * blocks, max_in_flight=width,
                             device="cuda")
    rng = np.random.default_rng(0)
    for n in rng.integers(SERVE["prompt_len"] // 2, SERVE["prompt_len"] + 1,
                          width):
        eng.submit(rng.integers(0, cfg.vocab, int(n)), max_new_tokens=new)
    for _ in range(200):
        if len(eng.scheduler.running) == width:
            break
        eng.step_round()
    if len(eng.scheduler.running) != width:
        raise AssertionError("the profiled engine never filled its round")
    eng.step_round()                                   # one warm round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        eng.step_round()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            eng.step_round()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op (aten::mm) also reports the
        # time of the kernels it launched, which would count them twice
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev / 1e3 / rounds, e.count // rounds, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile decode round (B={width}, {cfg.n_layers} layers): wall "
        f"{wall_ms:.2f} ms/round, device busy {busy_ms:.2f} ms/round "
        f"({100 * busy_ms / wall_ms:.1f}% busy), device time by kernel per "
        f"round:")
    for ms, count, key in rows[:12]:
        log(f"  {ms:8.3f} ms {count:6d} x  {key[:90]}")
    return busy_ms / wall_ms


# ----------------------------------------------- phase 3 (GUPS-path kernels)


def _equal(name: str, got, want) -> None:
    """Bitwise agreement of a copy with its plain version."""
    import torch

    ok = got.shape == want.shape and got.dtype == want.dtype and \
        bool(torch.equal(got, want))
    log(f"parity {name}: {'bitwise ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel output differs from its plain "
                             f"version")


def _close(name: str, got, want, tol: float) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    log(f"parity {name}: max_abs_err={err:.3e} tol={tol:g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees with its plain version, "
                             f"max_abs_err={err:.3e}")
    return err


def check_gups_parity(torch) -> None:
    """The gather, scatter-add and triad kernels against their plain
    versions on the card, at small shapes that reach every code path."""
    import numpy as np

    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_gather.ops import coalesced_gather, \
        coro_gather
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.coro_scatter_add.ops import coro_scatter_add
    from repro_torch.kernels.stream_copy import stream_copy as sc
    from repro_torch.launch.kernel_bench import coalesce_patterns

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def table(rows, d, dtype, scale=10.0):
        t = torch.randn(rows, d, generator=gen, device="cuda") * scale
        return t.to(dtype)

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        # 16-byte rows, and rows of 4-byte words (20 B) or, in bf16, of
        # 2-byte units (10 B)
        for rows, d in ((300, 128), (64, 5)):
            tab = table(rows, d, dtype)
            idx = torch.randint(0, rows, (48,), generator=gen, device="cuda",
                                dtype=torch.int32)
            for rpt in (1, 4, 8):
                for depth in (1, 2, None):
                    _equal(f"row_gather {dtype} {rows}x{d} rows/tile={rpt} "
                           f"depth={depth}",
                           cg.row_gather(tab, idx, depth=depth,
                                         rows_per_tile=rpt),
                           cg.row_gather_plain(tab, idx))
            odd = idx[:45]                          # off the 8-row tile
            _equal(f"coro_gather {dtype} {rows}x{d} n=45",
                   coro_gather(tab, odd), cg.row_gather_plain(tab, odd))
            starts = torch.randint(0, rows - 8, (13,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            for depth in (1, 2, None):
                _equal(f"span_gather {dtype} {rows}x{d} depth={depth}",
                       cg.span_gather(tab, starts, span=8, depth=depth),
                       cg.span_gather_plain(tab, starts, 8))
    tab = table(4096, 128, torch.float32)
    for name, idx in coalesce_patterns().items():
        out, plan = coalesced_gather(tab, idx)
        _equal(f"coalesced_gather {name} ({plan.n_spans} spans, "
               f"{plan.n_singles} singles)", out,
               tab[torch.as_tensor(idx, device="cuda").long()])

    rng = np.random.RandomState(3)
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        tab = table(4096, 128, dtype, scale=1.0)   # the reference's scale
        idx = rng.randint(0, 4096, 2045).astype(np.int32)   # duplicates
        upd = torch.randn(2045, 128, generator=gen, device="cuda").to(dtype)
        want = tab.to(torch.float32, copy=True).index_put_(
            (torch.as_tensor(idx, device="cuda").long(),), upd.float(),
            accumulate=True)
        for depth in (1, 2, None):
            got = coro_scatter_add(tab, idx, upd, depth=depth)
            _close(f"coro_scatter_add {dtype} depth={depth}", got, want, tol)
        uniq = torch.as_tensor(rng.permutation(4096)[:2040].astype(np.int32),
                               device="cuda")
        for d in (128, 5):          # 16-byte units; bf16 d=5: 2-byte units
            tab_d = tab[:, :d].contiguous()
            summed = torch.randn(2040, d, generator=gen,
                                 device="cuda").to(dtype)
            for depth in (1, 2, None):
                _equal(f"scatter_add_unique {dtype} d={d} depth={depth}",
                       sa.scatter_add_unique(tab_d.clone(), uniq, summed,
                                             depth=depth),
                       sa.scatter_add_unique_plain(tab_d.clone(), uniq,
                                                   summed))

    for dtype in (torch.float32, torch.bfloat16):
        tol = TRIAD_TOL[str(dtype).split(".")[1]]
        for n, d, rows in ((4096, 128, 128), (640, 96, 64), (64, 3, 2),
                           (63, 3, 1)):
            b = table(n, d, dtype)
            c = table(n, d, dtype)
            want = sc.triad_plain(b, c, 2.5)
            for depth in (1, 2, None):
                _close(f"triad {dtype} {n}x{d} rows={rows} depth={depth}",
                       sc.triad(b, c, 2.5, rows=rows, depth=depth), want,
                       tol)
    torch.cuda.synchronize()


# ------------------------------------------------------------------ phase 8


def gups_main_path(torch):
    """The GUPS path at its real size; returns what phase 9 times."""
    import numpy as np

    from repro_torch.core import autotune
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.coro_gather.ops import coalesced_gather
    from repro_torch.kernels.stream_copy.ops import stream_triad
    from repro_torch.kernels.stream_copy.stream_copy import triad_plain
    from repro_torch.launch.gups import gups_round
    from repro_torch.launch.kernel_bench import coalesce_patterns

    rows, d, n = GUPS["rows"], GUPS["d"], GUPS["n"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    table = torch.randn(rows, d, generator=gen, device="cuda")
    idx = torch.randint(0, rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    upd = torch.randn(n, d, generator=gen, device="cuda") * 0.1
    hj = coalesce_patterns(rows=rows, n=n, seed=5)["hj_mixed"]
    b = torch.randn(GUPS["triad_rows"], d, generator=gen, device="cuda")
    c = torch.randn(GUPS["triad_rows"], d, generator=gen, device="cuda")
    torch.cuda.synchronize()

    walls = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    gathered, updated = gups_round(table, idx, upd)
    torch.cuda.synchronize()
    walls["gups_round"] = time.perf_counter() - t0
    depths = {"row_gather": autotune.last_choice("row_gather"),
              "scatter_add": autotune.last_choice("scatter_add")}
    t0 = time.perf_counter()
    hj_out, plan = coalesced_gather(table, hj)
    torch.cuda.synchronize()
    walls["coalesced_gather"] = time.perf_counter() - t0
    depths["span_gather"] = autotune.last_choice("span_gather")
    t0 = time.perf_counter()
    a = stream_triad(b, c, GUPS["scalar"])
    torch.cuda.synchronize()
    walls["stream_triad"] = time.perf_counter() - t0
    depths["stream_triad"] = autotune.last_choice("stream_triad")
    counts = launch_counts()

    want = {"paged_decode": 0, "row_gather": 1 + bool(plan.n_singles),
            "span_gather": int(bool(plan.n_spans)), "scatter_add": 1,
            "stream_triad": 1}
    if counts != want:
        raise AssertionError(f"GUPS path launches {counts}, want {want}")
    idx64 = idx.long()
    if not torch.equal(gathered, table[idx64]):
        raise AssertionError("GUPS gather differs from table[idx]")
    if not torch.equal(hj_out, table[torch.as_tensor(hj, device="cuda")]):
        raise AssertionError("coalesced gather differs from table[idx]")
    del gathered, hj_out
    plain = table.clone().index_put_((idx64,), upd, accumulate=True)
    err = _max_abs_err(updated, plain)
    if not _allclose(updated, plain, 2e-3):
        raise AssertionError(f"GUPS scatter differs from the plain scatter-"
                             f"add: max_abs_err={err:.3e}")
    del plain
    triad_err = float((a - triad_plain(b, c, GUPS["scalar"])).abs().max())
    if triad_err > TRIAD_TOL["float32"]:
        raise AssertionError(f"triad differs from its plain version: "
                             f"{triad_err:.3e}")
    n_unique = int(torch.unique(idx).numel())
    shown = {"launches": counts, "depths": depths, "walls_s": walls,
             "unique_rows": n_unique,
             "coalescing": [plan.n_requests, plan.requests_issued(),
                            plan.coalescing_ratio()],
             "scatter_max_abs_err_vs_index_put": err,
             "memory_allocated_before_gb": held_gb,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9}
    log("gups path: " + json.dumps(shown))
    del a
    return {"table": table, "idx": idx, "updated": updated, "plan": plan,
            "b": b, "c": c, "n_unique": n_unique, "depths": depths,
            "counts": counts}


# ------------------------------------------------------------------ phase 9


def _max_abs_err(a, b, *, rows: int = 1 << 20) -> float:
    """Largest |a - b| in f32, over chunks of rows: no temporary of the
    size of an 8 GiB table."""
    err = 0.0
    for s in range(0, a.shape[0], rows):
        err = max(err, float((a[s:s + rows].float()
                              - b[s:s + rows].float()).abs().max()))
    return err


def _allclose(a, b, tol: float, *, rows: int = 1 << 20) -> bool:
    import torch

    return all(bool(torch.allclose(a[s:s + rows], b[s:s + rows], rtol=tol,
                                   atol=tol))
               for s in range(0, a.shape[0], rows))


def _bound_ms(nbytes: float, flops: float = 0.0):
    bytes_s, ops_s = nbytes / HBM_BW, flops / F32_PEAK
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else \
        "operations"


def time_gups_kernels(torch, st):
    """Kernel, plain and library times of the four GUPS-path kernels at the
    shapes phase 8 gave them, each kernel checked against its plain
    version on exactly these inputs."""
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.stream_copy import stream_copy as sc

    table, idx, plan, depths = st["table"], st["idx"], st["plan"], \
        st["depths"]
    d = GUPS["d"]
    row_bytes = d * table.element_size()
    starts = torch.as_tensor(plan.span_starts, device="cuda")
    span_rows = cg.span_rows(starts, plan.span)
    # the scatter kernel's inputs at phase 8's shape: the distinct rows,
    # padded with unused rows to the tile, and one update row each
    uniq = torch.unique(idx)
    pad = (-uniq.numel()) % 8
    free = torch.ones(table.shape[0], dtype=torch.bool, device="cuda")
    free[uniq.long()] = False
    uniq = torch.cat([uniq, free.nonzero()[:pad, 0].int()])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    summed = torch.randn(uniq.numel(), d, generator=gen, device="cuda") * 0.1
    work = st["updated"]
    b, c, s = st["b"], st["c"], GUPS["scalar"]
    n, t, u, nt = idx.numel(), starts.numel(), uniq.numel(), b.numel()

    cases = {
        "row_gather": dict(
            kernel=lambda: cg.row_gather(table, idx,
                                         depth=depths["row_gather"]),
            plain=lambda: cg.row_gather_plain(table, idx),
            library=(torch.index_select, (table, 0, idx.long())),
            bound=_bound_ms(2 * n * row_bytes + 4 * n),
            shape={"table": list(table.shape), "n": n, "rows_per_tile": 8,
                   "dtype": "float32"}),
        "span_gather": dict(
            kernel=lambda: cg.span_gather(table, starts, span=plan.span,
                                          depth=depths["span_gather"]),
            plain=lambda: cg.span_gather_plain(table, starts, plan.span),
            library=(torch.index_select, (table, 0, span_rows)),
            bound=_bound_ms(2 * t * plan.span * row_bytes + 4 * t),
            shape={"table": list(table.shape), "spans": t, "span": plan.span,
                   "dtype": "float32"}),
        "scatter_add": dict(
            kernel=lambda: sa.scatter_add_unique(work, uniq, summed,
                                                 depth=depths["scatter_add"]),
            plain=lambda: sa.scatter_add_unique_plain(work, uniq, summed),
            library=(lambda i, v: work.index_add_(0, i, v),
                     (uniq.long(), summed)),
            bound=_bound_ms(3 * u * row_bytes + 4 * u, u * d),
            shape={"table": list(table.shape), "n": u, "rows_per_tile": 8,
                   "dtype": "float32"}),
        "stream_triad": dict(
            kernel=lambda: sc.triad(b, c, s, depth=depths["stream_triad"]),
            plain=lambda: sc.triad_plain(b, c, s),
            library=(lambda x, y: torch.add(x, y, alpha=s), (b, c)),
            bound=_bound_ms(3 * nt * 4, 2 * nt),
            shape={"N": b.shape[0], "d": d, "rows": 128, "dtype": "float32"}),
    }
    out = {}
    for name, case in cases.items():
        if name == "scatter_add":       # in place: compare on copies
            before = work.clone()
            got = sa.scatter_add_unique(before.clone(), uniq, summed,
                                        depth=depths["scatter_add"])
            ref = sa.scatter_add_unique_plain(before, uniq, summed)
            del before
        else:
            got, ref = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        err = _max_abs_err(got, ref)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"the GUPS path's shapes: {err:.3e}")
        del got, ref
        lib_fn, lib_args = case["library"]
        kernel_a = median_ms(torch, lambda: case["kernel"](), [()])
        plain_ms = median_ms(torch, lambda: case["plain"](), [()])
        library_ms = median_ms(torch, lib_fn, [lib_args])
        kernel_b = median_ms(torch, lambda: case["kernel"](), [()])
        bound_ms, bound_by = case["bound"]
        ms = statistics.median([kernel_a, kernel_b])
        log(f"times {name} {json.dumps(case['shape'])}: kernel "
            f"{kernel_a:.4f}/{kernel_b:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of the bound")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "shape": case["shape"]}
    gups = GUPS["n"] / ((out["row_gather"]["ms"] + out["scatter_add"]["ms"])
                        * 1e-3) / 1e9
    log(f"GUPS from kernel times: {gups:.4f} giga-updates/s "
        f"({GUPS['n']} updates: gather + scatter-add of {u} rows)")

    # the same work at other depths, and the triad at other tile heights
    sweep = [("row_gather", f"depth={k}",
              lambda k=k: cg.row_gather(table, idx, depth=k))
             for k in (4, 8, 16, 32, 56)]
    sweep += [("scatter_add", f"depth={k}",
               lambda k=k: sa.scatter_add_unique(work, uniq, summed, depth=k))
              for k in (4, 8, 16, 28)]
    sweep += [("stream_triad", f"rows={r} depth={k}",
               lambda r=r, k=k: sc.triad(b, c, s, rows=r, depth=k))
              for r, k in ((128, 1), (64, 1), (64, 3), (32, 1), (32, 2),
                           (32, 6))]
    swept = {}
    for name, tag, fn in sweep:
        ms = median_ms(torch, fn, [()])
        swept[f"{name} {tag}"] = ms
        log(f"sweep {name} {tag}: {ms:.4f} ms, "
            f"{out[name]['bound_ms'] / ms:.1%} of the bound")
    log("sweep: " + json.dumps(swept))
    return out


# --------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # f32 results are compared on the card: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch

    repro_torch.reset()
    card_info(torch)
    build_kernels()
    check_parity(torch)
    check_gups_parity(torch)
    check_engine_card_vs_cpu(torch)
    cfg, stats, counts = serve_main_path(torch)
    timing = time_kernel(torch, cfg, stats)
    profile_decode_rounds(torch, cfg, stats["round_width"])
    log(f"depths: solved {stats['solved_depth']}, round width "
        f"{stats['round_width']}")
    gups = gups_main_path(torch)
    gups_times = time_gups_kernels(torch, gups)
    kernels = [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:163",
        "tpu": "kernels/decode_attention/decode_attention.py:paged_flash_decode",
        "launches": counts["paged_decode"],
        "parity": "ok",
        **{k: timing[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
        "shape": timing["shape"],
    }]
    for name, source, replaces in GUPS_KERNELS:
        t = gups_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": gups["counts"][name],
            "parity": "ok",
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "shape": t["shape"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
