#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the serving path from the sources in the
     checkout (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card: paged
     decode at yi-6b, granite-3-2b, internlm2-20b, head_dim-16 and
     one-KV-head shapes (1 to 32 query heads per KV head), ragged
     lengths plus a zero-length padding row, f32 (tolerance 2e-3) and bf16
     (3e-2), at depths 1, 2 and the solved depth;
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
  8. one JSON line describing every kernel, then the result line.

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
    from repro_torch.kernels.decode_attention import decode_attention as da

    t0 = time.perf_counter()
    libs = build.build([da.SOURCE])
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
    check_engine_card_vs_cpu(torch)
    cfg, stats, counts = serve_main_path(torch)
    timing = time_kernel(torch, cfg, stats)
    profile_decode_rounds(torch, cfg, stats["round_width"])
    log(f"depths: solved {stats['solved_depth']}, round width "
        f"{stats['round_width']}")
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
