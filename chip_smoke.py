#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the serving (paged and dense), GUPS and
     training paths from the sources in the checkout (one nvcc per
     source, all started together; K1 and K3 share one source, K4's
     backward has its own);
  3. each kernel against its plain PyTorch version on the card: paged
     decode (K1) at yi-6b, granite-3-2b, internlm2-20b, head_dim-16 and
     one-KV-head shapes (1 to 32 query heads per KV head), ragged
     lengths plus a zero-length padding row (it must come out 0), f32
     (2e-4) and bf16 (3e-3 + 1e-2 x |value|), at depths 1, 2 and the
     solved depth; at yi-6b's heads also splits 1, 2 and the plan's in 32-
     and 64-row tiles, pages of 4, 8 and 32 rows, and page depths 20 and
     27 (bf16), whose recorded depth must be the clamp's ring in pages;
     the MoE grouped matmul at qwen3-moe's decode, down
     projection and prefill shapes, granite-moe's, reduced tails and rows
     off the 16-byte unit, with one token block shared by every expert
     (stride 0) and with a token block per expert, in f32 (2e-3) and bf16
     (3e-2 + 3e-2 x |value|), at depths 1, 2 and solved, then its
     persistent walk at given grids (three tiles over 2 blocks, fewer
     tiles than blocks, C 16 and 17, ragged f, 2 blocks an SM: whole tiles
     dealt in turn, some blocks walking one more), each repeated bitwise;
     the row and span
     gathers in f32, bf16 and int32, 1/4/8 rows per tile, depths 1, 2 and
     solved, an index count off the tile, rows of 16-byte, 4-byte and
     (bf16) 2-byte units, the row gather at the per-SM splits phase 9
     sweeps, and the coalesced gather of the gups_random,
     stream_unit and hj_mixed streams (all bitwise); the scatter-add with
     duplicates through its op in f32 (2e-3) and bf16 (3e-2), and the
     kernel on deduplicated rows (bitwise, 16- and 2-byte units), also at
     the per-SM splits phase 9 sweeps (4099 tiles, off every split's block
     boundary, and 5, fewer than its blocks; d 128 and 5); the triad
     in f32 (bitwise) and bf16 (2e-2) on 16-byte items, 4- and 2-byte
     units and 16-byte items at an address off 16 bytes, at depths 1, 2
     and solved, then at given item sizes (items smaller than the caller's
     tile, fewer items than the card's SMs, an odd item count);
  3c. the dense engine's kernels against their plain versions: dense
     flash-decode at the five head shapes above over a cache of 1056 rows
     (off the 128-row tile), pos 0, mid and last, f32 (2e-4) and bf16
     (3e-3 + 1e-2 x |value|), depths 1, 2 and solved, then at the dense
     path's shape (B 8, yi-6b's heads) split 1, 2 and the plan's ways, pos
     in the first split, at split boundaries +-1 and past S; the SSD scan at mamba2-130m's (nh 24,
     p 64, n 128, chunk 256), hymba-1.5b's (nh 50, p 64, n 16) and a
     reduced shape (chunk 16), x/B/C in f32 and in bf16 beside f32 dt,
     depths 1, 2 and solved; then its chunk-parallel cases (1, 2 and 8
     kernel chunks, s 4096, s off the chunk, 50 and 8 heads in groups of
     6, one group of every head, one head a group) with dt in f32 and bf16;
     and a strong decay (dt 8, A -1), at 2e-3 + 2e-3 x |value| (f32) and
     3e-2 + 3e-2 x |value| (bf16 y);
  4. a reduced yi-6b engine, and (4b) a reduced granite-moe engine, in f32
     on the card against the same engine on the CPU (same parameters, same
     prompts, round width pinned): the greedy tokens must be identical,
     and every decode round and every prefill chunk on the card a captured
     CUDA graph or its replay (`graphs`, by step name: captures, capture
     seconds, replays); then `launch.kernel_bench`'s two paged rows on the
     card (paged against dense decode at equal KV; the shared-prefix
     engine warm against cold), printed with the card's name; (4c) the
     same for the dense engine, reduced yi-6b and mamba2-130m, its decode
     steps one capture and replays (`jit_decode_step`), the launches
     those of `dense_launches`;
  5. the main path: `serve_paged` for yi-6b at full width with the serving
     layout (bf16, weights drawn once from seed 0 and shared by phases 5-7
     and 5c), 8 requests, prompts of 64-256 tokens (half share a system
     prefix), 32 new tokens each, prefix cache on, in the guard's strict
     mode (the ``--strict`` lane; it must show no backoff: the line's
     `substrate`). Launch counts are
     zeroed just before and read just after; every request must finish and
     the paged-decode kernel must run n_layers times per decode round
     (each round a replay of a captured graph, counted as the launches its
     capture recorded), and every round and prefill chunk must be a
     captured graph or its replay (one prefill graph per padded length
     and table width); the line's `graphs` gives captures, capture seconds
     and replays of the decode and the prefill graphs, and
     `memory_reserved_gb` what the allocator holds after the run, the
     graphs' private pools included;
  6. K1 times at the main path's decode shape (CUDA events around one call
     per layer of the launch the guarded wrapper ran, taken back from the
     guard (`path_launch`): every timing loop below times such a launch
     without the guard's checks, since the guard's output scan waits for
     the device; queued behind a device sleep; median of 21 batches) and
     at B 1 (its longest request): the kernel (with the splits, tile and
     depth it ran), its plain version, and as a yardstick
     `scaled_dot_product_attention` over K/V gathered beforehand (it
     excludes the page gather); the bound is the larger of the live K/V
     bytes over 3.35 TB/s and the flops over 989 TFLOP/s (data sheet);
     then a sweep of tile height (32, 64) x splits, each beside the bound;
  7. a profile of full-width decode rounds (torch.profiler), each a replay
     of the round's CUDA graph: device time by kernel per round, K1's share
     of it, the device's busy share of the wall clock, and the graphs
     captured on the way (how many, their capture time) and replayed; then
     the same of replayed 32-token prefill chunks at table width 18; after
     each, the guard's cost in the eager step before a capture: a step at
     a new key (eager, then captured) with the guard's checks and with
     them stubbed out, in turns (`eager_guard_cost`);
  5c. the dense engine: `serve(engine="dense")` for yi-6b at full width on
     phase 5's weights, under strict (no backoff; every decode step a
     captured graph or its replay, as in 5d and 5e), batch 8, prompts of
     1024 tokens, 32 new tokens
     (caches [32, 8, 1056, 4, 128] x 2, 0.55 GB). Launch counts zeroed
     just before and read just after: dense flash-decode 32 x 31 times and
     nothing else; decode tok/s and per-token p50/p99 (the first step
     includes the decode step's capture: `decode_captures`); then a
     profile of dense decode steps through `jit_decode_step` (device time
     by kernel, busy share, captures), as phase 7;
  6c. dense flash-decode times at 5c's decode shape (B 8, S 1056, pos
     1040; the method of phase 6) and at B 1: kernel (with the splits,
     tile height and depth it ran), plain version, and as a yardstick
     scaled_dot_product_attention over the cache sliced to pos + 1; bound:
     the live K/V bytes over 3.35 TB/s; then a sweep of tile height (64,
     128) and splits at B 8, each beside the bound;
  5d. `serve(engine="dense")` for mamba2-130m at full width, bf16, random
     weights from seed 0, batch 8, prompts of 2048 tokens (8 chunks of
     256), 32 new tokens: the SSD scan 24 times (once per layer of the
     prefill) and nothing else; then (6c) SSD-scan times at that prefill
     shape in bf16 (with a head-group x depth sweep) and in f32: kernel,
     the time of each of its three launches (torch.profiler) and plain
     version (no PyTorch call computes the scan); bound: the larger of the
     bytes in and out over 3.35 TB/s and the reference spec's flops over
     the peak of the kernel's products (989 TFLOP/s bf16 tensor cores, 67
     TFLOP/s f32); then a profile of its decode steps, as 5c;
  3d. (after 6c, so that the phases above run as before) dense
     flash-decode at paligemma-3b's heads (8 on one KV head, head dim
     256) over 1056 rows and at whisper-medium's decoder self-attention
     (16 on 16, D 64) over 288 rows, at pos 0, half the cache, the first,
     middle and last decode positions and the last row, f32 and bf16 at
     the same bounds, depths 1, 2 and solved at B 3, splits 1, 2 and the
     plan's at B 8; and the
     sliding-window ring decode (`models.lm.ring_decode_attention`) at
     hymba-1.5b's heads (25 on 5, D 64) over a ring of 1024 slots, pos
     before, at and after the wrap (the new row at slot pos % 1024, the
     output K3's plain version at min(pos, 1023)); then (4d) reduced
     hymba-1.5b, whisper-medium and paligemma-3b dense engines in f32 on
     the card against the CPU, as 4c;
  5e. the hybrid, enc-dec and VLM families at full width, one at a time
     (bf16, random weights from seed 0, each freed before the next),
     `serve(engine="dense")` under strict, batch 8, 32 new tokens:
     hymba-1.5b at 2048 prompt tokens (the sliding-window blocks of its
     prefill and the ring's roll; K4 32 times, K3 32 x 31), whisper-
     medium at 1024 frames and 256 text tokens (K3 2 x 24 x 31: self and
     cross attention), paligemma-3b at 256 patches and 768 text tokens (K3
     18 x 31 at head dim 256). Launch counts zeroed just before and read
     just after; no backoff; every decode step a captured graph or its
     replay. Each with a profile of replayed decode steps, and hymba's K4
     times at its prefill shape (b 8, s 2048, nh 50, p 64, n 16);
  6e. K3 times at paligemma-3b's decode shape (B 8, S 1056, pos 1040, D
     256), whisper-medium's self-attention (B 8, 16 heads, S 288, pos
     272) and cross shape (S 1024, pos 1023) and hymba-1.5b's ring (B 8,
     25 on 5 heads, 1024 slots, pos 1023), each shape derived from its
     config and phase 5e's run (`family_k3_shapes`), the method of phase
     6c; then `launch.serve_batched --engine both
     --prefix-cache` (its asserts must hold);
  5b. the MoE path: `serve_paged` for qwen3-moe-30b-a3b at full width
     (48 layers, 128 experts, 61.1 GB of bf16 weights), the same traffic
     as phase 5, after yi-6b is freed. Every request must finish, the
     paged-decode kernel run n_layers times per decode round and the
     grouped matmul 3 x n_layers times per decode round and prefill chunk;
  6b. grouped-matmul times at that path's decode (C = round width) and
     prefill (C = 32) shapes, gate/up (dm -> f) and down (f -> dm), on
     layer 0's weights (with the blocks an SM, slots a block, grid and
     tiles a block that ran): the kernel, its plain version, and as a
     yardstick torch.bmm over the tokens expanded to every expert; the
     bound is the weights, tokens and output over 3.35 TB/s (or the flops
     over 989 TFLOP/s, if larger); and the host time of one call of the
     launch `gmm` ran, without the solve and the guard (`path_launch`,
     `host_ms_per_call`);
  7b. a profile of full-width qwen3-moe decode rounds, replays as in
     phase 7: device time by kernel per round, K1's and the grouped
     matmul's shares, the busy share, the captures, and the round's floor
     (every weight but the embedding table read once); then replayed
     prefill chunks, as phase 7, with the grouped matmul's share;
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
     the guarded row gather and scatter-add (the guard's scan of what they
     wrote included) beside their bare launches, sync to sync, and GUPS
     through each; then the same kernels at other depths (tiles in flight per block;
     the row gather's and the scatter-add's per SM, and at 4x14, 6x9, 8x6
     and 12x4 (K5a) and 2x14, 3x8, 4x7, 6x4 and 12x2 (K6) blocks an SM x
     slots; the K6 line of phase 9 gives its split and grid), the triad
     at item sizes (with the blocks an SM that fit) and at other tile
     heights and depths, and the grouped matmul at
     qwen3-moe's decode shape at other depths (k-slices in flight per
     block) and at other blocks per SM, each time beside its bound; last,
     in turns against copies of their sources built in a temporary
     directory: the span gather with its ring wait inlined (the source)
     against the shared header's called wait, likewise the scatter-add's,
     and the triad's one pass a
     block (the source) against a persistent grid of 4, 8 and 16 blocks an
     SM, block g walking items g, g + grid, ...; then (g) the four GUPS
     kernels three times more through `launch.gups.observed` and
     `obs.stall_breakdown()` over them: each kernel's compute, transfer
     and gap must sum to its observed per-tile time;
 10. the guard (`core.guard`) on the card (its sentinel is off in phases
     1-9, whatever ``REPRO_PARITY`` says): (a) with the sentinel on full,
     each of the nine guarded wrappers (K4's backward among them) once at
     small f32 shapes: a parity check each, no mismatch; (b) a deliberately wrong plain version around
     K5a's `row_gather_at`: `KernelParityError`, the ladder 8, 4, 2, 1,
     each depth quarantined; (c) K6 asked for 64 and 32 slots of 8 KiB,
     which `check_smem` refuses: the ladder lands on 16, the table equals
     the plain version's bitwise, the refused depths are quarantined and
     `choose_depth` does not propose them; (d) a dense decode step graph
     of reduced yi-6b under the full sentinel: the eager step is checked,
     the capture and its replays add no check; (e) `launch.chaos_serve`
     on reduced yi-6b, seed 0, 20 rounds: every request terminal, no
     mismatch; then the guard's own host cost per eager call (an unguarded
     launch, the guard without and with its scan, with the sentinel);
 11. training (`runtime.train_loop.train`, with the sentinel off again):
     (a) K2's gradients through `moe_gmm`'s autograd Function (each
     backward product one more K2 launch) at the six products of a
     granite-moe training step (the gate/up forward on one token block
     shared by the 32 experts, the down forward on per-expert tokens, and
     their d tokens and d weights, 4096 tokens) against the plain
     version's autograd, f32 (2e-3) and bf16 (3e-2 + 3e-2 x |value|),
     depths 1, 2 and solved; (b) a reduced granite-moe f32 train step on
     the card against the same step on the CPU (same parameters and
     batch): the loss, every gradient leaf and the AdamW update within
     2e-3, and the card's state through a checkpoint and back, bitwise;
     then the same reduced f32 step of mamba2-130m and hymba-1.5b (a K4
     forward and a K4 backward call a layer) card == CPU within 2e-3;
     (c) K4's backward kernel (`ssd_scan_bwd`, four launches a call)
     against its plain version at mamba2's and hymba's full training
     shapes (b 8, s 512, chunk 256; x/B/C slices of one projection, dt
     f32), f32 (2e-3 + 2e-3 x |value|) and bf16 (3e-2 + 3e-2 x |value|),
     depths 1, 2 and solved, dh_final None and given, one count a call;
     (d) granite-moe-1b-a400m (20 steps), mamba2-130m (20) and hymba-1.5b
     (10) trained at full width (f32 parameters, bf16 compute, batch 8 x
     seq 512, AdamW): every loss finite, the mean of the last 5 below the
     mean of the first 5, exactly the step's launches (216 K2; or 24 / 32
     K4 forward and backward calls) and no other kernel; step time p50,
     tokens a second, peak memory, then a profile of fresh steps (device
     busy share; K2's share, or K4's forward and backward ms a step) and
     the guard's cost a step; (e) K2's times at the six products beside
     torch.bmm and the bound, and K4's backward's at the two SSM training
     shapes (by launch) beside its plain version and the bound;
 12. `guard.stats()` on one JSON line, one JSON line describing every
     kernel (nine: K4's backward has its own entry; K2's, K3's and K4's
     launches by path, and K2's times at the training products and K3's
     at the new families' shapes, among them), then the result line.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.

    python3 chip_smoke.py --gmm-host-time

runs only the host-time measurement of phase 6b (the launch `gmm` runs,
taken back from the guard), on random weights of the same shapes, against
the package of the checkout the script sits in (copy the script into
another checkout with `core.guard.record` to measure that one), and
prints one JSON line.

    python3 chip_smoke.py --train

builds the kernels and runs only phase 11 (training), then prints its
record as one JSON line.

    python3 chip_smoke.py --ssd-time

likewise times only the SSD scan (K4) at phase 6c's shape in bf16 and f32
(each checked against its plain version) and prints one JSON line.

    python3 chip_smoke.py --dense-first-step

likewise takes phase 5c's first dense decode step apart (its eager run,
capture and replay, and the collections of the garbage collector inside
it) over six runs of yi-6b's dense path, and prints one JSON line.
"""
from __future__ import annotations

import json
import math
import os
import re
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
# Decode attention (K1, K3), (atol, rtol): over randn K/V of ~1000 live rows
# an output is ~0.05, and one row too many or one tile too few moves it by
# ~5e-3, so the absolute term is a tenth of the output; the relative term
# covers one bf16 rounding step of the cast output (at most 2^-7 of it).
DECODE_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (3e-3, 1e-2)}
PARITY_LENGTHS = [1, 15, 16, 17, 300, 2048]
HEAD_SHAPES = [("yi-6b", 32, 4, 128), ("granite-3-2b", 32, 8, 64),
               ("head_dim-16", 4, 2, 16), ("internlm2-20b", 48, 8, 128),
               ("one-kv-head", 32, 1, 64)]
SERVE = dict(batch=8, prompt_len=256, gen=32, block_size=16)
# The GUPS path (HPCC RandomAccess, cut to one batch of 2^22 updates of
# 512 B rows) and the STREAM triad arrays (each over 4x the caches).
GUPS = dict(rows=1 << 24, d=128, n=1 << 22, triad_rows=1 << 21, scalar=3.0)
TRIAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K7 at given item sizes in phase 3 (n, d, rows, item rows)
TRIAD_PLANS = ((4096, 128, 128, 8), (4096, 128, 128, 2), (256, 128, 128, 8),
               (301 * 16, 64, 16, 16), (1 << 16, 128, 128, 32))
# K7's item sizes swept in phase 9 (rows), and the blocks an SM of the
# persistent grids it is timed against
TRIAD_SWEEP = (2, 4, 8, 16, 32)
TRIAD_PERSISTENT = (4, 8, 16)
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
# K5a's per-SM splits swept in phase 9 (blocks per SM, slots a block): all
# fit 228 KiB of shared memory with the runtime's 1 KiB per block
K5A_SPLITS = ((4, 14), (6, 9), (8, 6), (12, 4))
# K6's, likewise (its slots hold 8 KiB at the GUPS path's shape)
K6_SPLITS = ((2, 14), (3, 8), (4, 7), (6, 4), (12, 2))
MOE_ARCH = "qwen3-moe-30b-a3b"


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
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.stream_copy import stream_copy as sc

    t0 = time.perf_counter()
    libs = build.build([da.FLASH_SOURCE, ss.SOURCE, ss.BWD_SOURCE, mg.SOURCE,
                        cg.SOURCE, sa.SOURCE, sc.SOURCE])
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


def _paged_close(torch, name, args, dtype_name, **kw) -> float:
    """K1 on `args` (the last row of zero length) against its plain
    version at DECODE_TOL; the zero-length row must come out finite, and
    0. Returns the error over the live rows."""
    from repro_torch.kernels.decode_attention import decode_attention as da

    out = da.paged_flash_decode(*args, **kw)
    ref = da.paged_flash_decode_plain(*args)
    err = _close(name, out[:-1], ref[:-1], *DECODE_TOL[dtype_name])
    pad = out[-1].float()
    if not bool(torch.isfinite(pad).all()) or bool(pad.any()):
        raise AssertionError(f"{name}: the zero-length row is not 0")
    return err


def check_parity(torch) -> float:
    """K1 at HEAD_SHAPES over 16-row pages, f32 and bf16, depths 1, 2 and
    solved; then at yi-6b's heads: splits 1, 2 and the plan's in 32- and
    64-row tiles, pages of 4, 8 and 32 rows, and deep page depths, each
    recorded as the clamp's ring. Every case ends in a zero-length row."""
    from repro_torch.core import autotune
    from repro_torch.kernels import ring
    from repro_torch.kernels.decode_attention import decode_attention as da

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    for name, h, kh, d in HEAD_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            args = paged_problem(torch, gen, PARITY_LENGTHS, h=h, kh=kh, d=d,
                                 blk=16, dtype=dtype, device="cuda")
            for depth in (1, 2, None):
                err = _paged_close(torch, f"paged_decode {name} {dtype_name} "
                                   f"depth={depth}", args, dtype_name,
                                   depth=depth)
                worst = max(worst, err / DECODE_TOL[dtype_name][0])
    sms = ring.sm_count(torch.device("cuda"))
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        args = paged_problem(torch, gen, PARITY_LENGTHS, h=32, kh=4, d=128,
                             blk=16, dtype=dtype, device="cuda")
        b, m = args[0].shape[0], args[3].shape[1]
        for blk in (32, 64):
            for splits in (1, 2, None):
                n_split, per = da.split_plan(b, 4, m * 16, blk, sms, splits)
                _paged_close(torch, f"paged_decode yi-6b {dtype_name} blk={blk}"
                             f" splits={splits} (ran {n_split} x {per} tiles)",
                             args, dtype_name, blk=blk, splits=splits)
        for page in (4, 8, 32):
            args = paged_problem(torch, gen, PARITY_LENGTHS, h=32, kh=4,
                                 d=128, blk=page, dtype=dtype, device="cuda")
            _paged_close(torch, f"paged_decode yi-6b {dtype_name} page={page}",
                         args, dtype_name)
    # deep page depths: the ring runs the clamp's 64-row tiles (at most one
    # split's, and what shared memory holds beside the table slice)
    args = paged_problem(torch, gen, PARITY_LENGTHS, h=32, kh=4, d=128, blk=16,
                         dtype=torch.bfloat16, device="cuda")
    b, m = args[0].shape[0], args[3].shape[1]
    for splits in (1, None):
        _, per = da.split_plan(b, 4, m * 16, da.FLASH_BLK, sms, splits)
        for depth in (20, 27):
            tiles = da.kernel_depth(depth, g=8, d=128, page=16,
                                    blk=da.FLASH_BLK, itemsize=2, n_tiles=per,
                                    m=m)
            want = da.ring_pages(tiles, da.FLASH_BLK, 16)
            _paged_close(torch, f"paged_decode yi-6b bfloat16 depth={depth} "
                         f"splits={splits} (ring {tiles} tiles = {want} pages)",
                         args, "bfloat16", depth=depth, splits=splits)
            ran = autotune.last_choice("paged_decode")
            if ran != want:
                raise AssertionError(f"paged_decode recorded depth {ran}, "
                                     f"the clamp gives {want}")
    return worst


# ------------------------------------------------- phase 3 (grouped matmul)


GMM_SHAPES = (   # name, E, C, dm, f, tokens shared by every expert
    ("qwen3-moe decode gate/up", 128, 5, 2048, 768, True),
    ("qwen3-moe decode down", 128, 5, 768, 2048, False),
    ("qwen3-moe prefill gate/up", 128, 32, 2048, 768, True),
    ("qwen3-moe prefill down", 128, 32, 768, 2048, False),
    ("granite-moe decode gate/up", 32, 5, 1024, 512, True),
    ("reduced C=1", 4, 1, 64, 32, True),
    ("reduced C=5", 4, 5, 64, 32, False),
    ("ragged C=33", 4, 33, 200, 136, True),
    ("off the 16-byte unit", 2, 7, 50, 36, True),
)


# The persistent walk at a given grid (whole tiles dealt in turn): name, E,
# C, dm, f, shared, blocks
GMM_WALK_CASES = (
    ("three tiles over 2 blocks", 1, 5, 2048, 384, True, 2),
    ("fewer tiles than blocks", 2, 5, 64, 32, False, 1000),
    ("C=16, 4 blocks", 3, 16, 512, 256, False, 4),
    ("C=17, 5 blocks", 3, 17, 256, 136, True, 5),
    ("ragged f and dm, 4 blocks", 3, 5, 200, 136, True, 4),
    ("qwen3-moe decode gate/up, 2 blocks an SM", 128, 5, 2048, 768, True,
     "2/SM"),
)


def gmm_operands(torch, gen, e, c, dm, f, shared, dtype):
    """Tokens (one [C, dm] block expanded over the experts when `shared`,
    as the dense MoE layer passes them) and weights scaled by dm**-0.5."""
    rows = 1 if shared else e
    tokens = torch.randn(rows, c, dm, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(e, dm, f, generator=gen, device="cuda")
         * dm ** -0.5).to(dtype)
    return tokens.expand(e, c, dm), w


def check_gmm_parity(torch) -> float:
    from repro_torch.core import autotune
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    worst = 0.0
    for name, e, c, dm, f, shared in GMM_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            tokens, w = gmm_operands(torch, gen, e, c, dm, f, shared, dtype)
            ref = mg.gmm_plain(tokens, w)
            for depth in (1, 2, None):
                out = mg.gmm(tokens, w, depth=depth)
                ran = autotune.last_choice("moe_gmm")
                err = _close(f"moe_gmm {name} [{e},{c},{dm}]x[{dm},{f}] "
                             f"shared={shared} {dtype_name} depth={depth} "
                             f"(ran {ran})", out, ref, TOL[dtype_name])
                worst = max(worst, err)
            del tokens, w, ref, out
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, e, c, dm, f, shared, blocks in GMM_WALK_CASES:
        if blocks == "2/SM":
            blocks = 2 * sm
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            tokens, w = gmm_operands(torch, gen, e, c, dm, f, shared, dtype)
            out = mg.gmm_at(tokens, w, depth=2, blocks=blocks)
            again = mg.gmm_at(tokens, w, depth=2, blocks=blocks)
            walk = mg.walk(e, c, dm, f, tokens.element_size(), blocks)
            err = _close(f"moe_gmm walk: {name} [{e},{c},{dm}]x[{dm},{f}] "
                         f"{dtype_name} ({walk.blocks} blocks over "
                         f"{walk.tiles} tiles)", out, mg.gmm_plain(tokens, w),
                         TOL[dtype_name])
            if not torch.equal(out, again):
                raise AssertionError(f"moe_gmm walk: {name}: two runs of "
                                     "one call differ")
            worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


# ------------------------------------------------------------------ phase 4


GRAPH_FIELDS = ("captures", "capture_s", "replays")


def graph_delta(since: dict) -> dict:
    """`core.step_graph.stats()` since `since`, by step name (the dense and
    paged decode steps, the paged prefill chunks): the CUDA graphs
    captured, the seconds the captures took and the replays."""
    from repro_torch.core import step_graph

    now = step_graph.stats()["by_name"]
    out = {}
    for name, counts in now.items():
        before = since["by_name"].get(name, {})
        delta = {k: counts[k] - before.get(k, 0) for k in GRAPH_FIELDS}
        if any(delta.values()):
            out[name] = delta
    return out


def check_graphs(label: str, graphs: dict, want: dict) -> None:
    """Every step of each name in `want` ({name: steps run}) was a captured
    graph or its replay, with at least one capture."""
    for name, steps in want.items():
        got = graphs.get(name, dict.fromkeys(GRAPH_FIELDS, 0))
        if got["captures"] < 1 or got["captures"] + got["replays"] != steps:
            raise AssertionError(f"{label}: {steps} {name} steps were not "
                                 f"captured graphs and replays: {graphs}")


def check_engine_card_vs_cpu(torch, arch: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import step_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().replace(dtype="float32",
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
    since = step_graph.stats()
    card = serve_paged(cfg, device="cuda", params=to_card(params_cpu), **kw)
    counts = launch_counts()
    graphs = graph_delta(since)
    if cpu["generated"] != card["generated"]:
        raise AssertionError(f"{arch}: card tokens {card['generated']} != "
                             f"CPU tokens {cpu['generated']}")
    ran = {k: counts[k] for k in ("paged_decode", "moe_gmm")[:1 + cfg.moe]}
    if not all(ran.values()):
        raise AssertionError(f"{arch}: the card engine did not launch every "
                             f"kernel of its path: {ran}")
    check_graphs(arch, graphs, {"paged_decode": card["decode_rounds"],
                                "paged_prefill": card["prefill_chunks"]})
    log(f"engine {arch} reduced f32 card == cpu: "
        f"{sum(map(len, card['generated']))} tokens identical, launches "
        f"{ran}, decode rounds {card['decode_rounds']} and prefill chunks "
        f"{card['prefill_chunks']} as graphs {json.dumps(graphs)}")


def bench_paged_rows(torch, card: str) -> None:
    """`launch.kernel_bench`'s two paged rows on the card: paged against
    dense decode at equal KV, and the shared-prefix engine warm against
    cold (reduced yi-6b, f32: its rounds and prefill chunks replayed)."""
    from repro_torch.launch import kernel_bench

    log(f"kernel_bench paged rows on {card}:")
    for line in kernel_bench.paged_table(torch.device("cuda")).splitlines():
        log(f"  {line}")


# ------------------------------------------------------------------ phase 5


def serve_main_path(torch, arch: str, params=None):
    """`serve_paged` for `arch` at full width, serving layout (bf16), with
    the launch counts zeroed just before and read just after, in the
    guard's strict mode (the ``--strict`` lane: a kernel failure raises;
    the run must show no backoff)."""
    from repro_torch.configs import get_config
    from repro_torch.core import guard, step_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SERVING_OVERRIDES, serve_paged

    cfg = get_config(arch).replace(**SERVING_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    since = step_graph.stats()
    before = guard.stats()
    guard.set_strict(True)
    reset_launch_counts()
    try:
        stats = serve_paged(cfg, device="cuda", params=params, **SERVE)
    finally:
        guard.set_strict(False)
    counts = launch_counts()
    wall = time.perf_counter() - t0
    graphs = graph_delta(since)
    substrate = _guard_delta(before)
    if substrate["backoffs"] or substrate["parity_mismatches"]:
        raise AssertionError(f"{arch}: strict serving degraded: {substrate}")
    n = SERVE["batch"]
    bad = {k: stats[k] for k in ("failed", "cancelled", "stalled") if stats[k]}
    if stats["completed"] != n or bad or \
            any(s != "finished" for s in stats["states"]):
        raise AssertionError(f"not every request finished: completed "
                             f"{stats['completed']}/{n}, {bad}, "
                             f"{stats['states']}")
    want = {"paged_decode": cfg.n_layers * stats["decode_rounds"],
            "moe_gmm": 3 * cfg.n_layers * (stats["decode_rounds"]
                                           + stats["prefill_chunks"])
            if cfg.moe else 0}
    for name, n in want.items():
        if counts[name] != n or (n == 0 and (name == "paged_decode"
                                             or cfg.moe)):
            raise AssertionError(
                f"{arch}: {name} launched {counts[name]} times, want {n} "
                f"(paged_decode: n_layers x decode rounds; moe_gmm: 3 x "
                f"n_layers x (decode rounds + prefill chunks))")
    for toks in stats["generated"]:
        if len(toks) != SERVE["gen"] or not all(0 <= t < cfg.vocab
                                                for t in toks):
            raise AssertionError(f"bad generation {toks}")
    shown = {k: stats[k] for k in (
        "decode_tok_per_s", "ttft_p50_ms", "ttft_p99_ms", "tbt_p50_ms",
        "tbt_p99_ms", "p50_ms", "p99_ms", "round_width", "solved_depth",
        "decode_rounds", "rounds", "prefill_chunks", "prefix_hits",
        "cow_forks", "preemptions", "prefill_s", "decode_s", "prompt_lens")}
    check_graphs(arch, graphs, {"paged_decode": stats["decode_rounds"],
                                "paged_prefill": stats["prefill_chunks"]})
    shown["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the graphs' private pools are held (with the caching allocator's
    # free blocks) in what is reserved after the run
    shown["memory_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    shown["wall_s"] = wall
    shown["launches"] = {k: counts[k] for k in want}
    shown["graphs"] = graphs
    shown["substrate"] = {"strict": True, **substrate}
    log(f"serve {arch} full width: " + json.dumps(shown))
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


def path_launch(fn, *args, **kw):
    """Call the guarded kernel wrapper `fn` once, its checks included, and
    return (its output, the launch it ran as a thunk: `GuardResult.rerun`,
    which runs the same kernel at the same depth, split and grid without
    the guard). The timing loops time that thunk: the launch the main path
    makes, without the guard's output scan (a device sync)."""
    from repro_torch.core import guard

    with guard.record() as calls:
        out = fn(*args, **kw)
    return out, calls[-1].rerun


def run_thunk(run):
    return run()


def paged_decode_bound(lengths, h, kh, d, m):
    """(bound ms, bound_by, bytes, flops) of paged decode attention: the
    live K/V rows, q, the output, the block table and the lengths over
    3.35 TB/s, or the flops over 989 TFLOP/s (bf16) if larger."""
    b = len(lengths)
    kv_bytes = 2 * sum(lengths) * kh * d * 2          # K and V rows < len
    io_bytes = 2 * b * h * d * 2 + b * m * 4 + b * 4
    flops = 4 * h * d * sum(lengths)                  # q.k and p.v
    bytes_s, ops_s = (kv_bytes + io_bytes) / HBM_BW, flops / PEAK["bfloat16"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations",
            kv_bytes + io_bytes, flops)


def time_paged(torch, layers, gathered, lengths, depth):
    """K1 on `layers` (one (q, pools, table, lengths) per layer), checked
    against its plain version on the first, then its time, the plain
    version's and SDPA's over `gathered` (K/V gathered beforehand), beside
    the bound."""
    import torch.nn.functional as F

    from repro_torch.core import autotune
    from repro_torch.kernels import ring
    from repro_torch.kernels.decode_attention import decode_attention as da

    q, kp, vp, bt, ln = layers[0]
    b, h, d = q.shape
    page, kh, m = kp.shape[1], kp.shape[2], bt.shape[1]
    runs = [path_launch(da.paged_flash_decode, *a, depth=depth)
            for a in layers]
    ran = autotune.last_choice("paged_decode")
    err = _close(f"paged_decode at the main path's shape B={b} lengths="
                 f"{lengths}", runs[0][0],
                 da.paged_flash_decode_plain(q, kp, vp, bt, ln),
                 *DECODE_TOL["bfloat16"])
    launches = [(run,) for _, run in runs]
    del runs

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    kernel_a = median_ms(torch, run_thunk, launches)
    plain_ms = median_ms(torch, da.paged_flash_decode_plain, layers)
    library_ms = median_ms(torch, sdpa, gathered)
    kernel_b = median_ms(torch, run_thunk, launches)
    ms = statistics.median([kernel_a, kernel_b])
    bound_ms, bound_by, nbytes, flops = paged_decode_bound(lengths, h, kh, d, m)
    sms = ring.sm_count(q.device)
    n_split, per = da.split_plan(b, kh, m * page, da.FLASH_BLK, sms)
    shape = {"B": b, "H": h, "KH": kh, "D": d, "page": page, "M": m,
             "lengths": lengths, "dtype": "bfloat16", "blk": da.FLASH_BLK,
             "splits": n_split, "tiles_per_split": per,
             "blocks": b * kh * n_split, "depth_pages": ran,
             "solved_depth_pages": depth, "sms": sms}
    log(f"times paged_decode {json.dumps(shape)}: kernel "
        f"{kernel_a:.6f}/{kernel_b:.6f} ms, plain {plain_ms:.6f} ms, sdpa "
        f"(pre-gathered, no page gather) {library_ms:.6f} ms, bound "
        f"{bound_ms:.8f} ms ({bound_by}, {nbytes} B, {flops} flop), "
        f"{bound_ms / ms:.1%} of the bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "splits": n_split, "shape": shape}


def time_kernel(torch, cfg, stats):
    """K1 at the main path's decode shape (B = round width, mid-generation
    lengths of its longest prompts, 16-row pages, a table as wide as a
    request's pages, one layer's pools per call) and at B 1 (the longest
    request): kernel, plain version, SDPA over K/V gathered beforehand (it
    excludes the page gather), bound; then a sweep of tile height (32, 64)
    x splits at the main path's shape, each beside the bound."""
    from repro_torch.core import autotune
    from repro_torch.kernels import ring
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

    # the yardstick: SDPA over K/V gathered (and masked) beforehand
    s_len = m * blk
    gathered = []
    for q, kp, vp, bt, ln in layers:
        k = kp[bt.long()].reshape(width, s_len, kh, d).transpose(1, 2)
        v = vp[bt.long()].reshape(width, s_len, kh, d).transpose(1, 2)
        mask = (torch.arange(s_len, device="cuda")[None, :]
                < ln.long()[:, None])[:, None, None, :]
        gathered.append((q[:, :, None], k.contiguous(), v.contiguous(), mask))

    depth = stats["solved_depth"]
    rec = time_paged(torch, layers, gathered, lengths, depth)
    # B 1: the longest request alone
    one = [(q[-1:], kp, vp, bt[-1:], ln[-1:]) for q, kp, vp, bt, ln in layers]
    rec["b1"] = time_paged(torch, one, [tuple(t[-1:] for t in g)
                                        for g in gathered],
                           lengths[-1:], depth)
    sms = ring.sm_count(torch.device("cuda"))
    swept = {}
    for tile in (32, 64):
        seen = set()
        for splits in (None, 1, 2, 3, 5):
            plan = da.split_plan(width, kh, m * blk, tile, sms, splits)
            if plan in seen:
                continue
            seen.add(plan)

            launches = [(path_launch(da.paged_flash_decode, *a, blk=tile,
                                     splits=plan[0], depth=depth)[1],)
                        for a in layers]
            pages = autotune.last_choice("paged_decode")
            t = median_ms(torch, run_thunk, launches)
            del launches
            tag = (f"blk={tile} splits={plan[0]} tiles_per_split={plan[1]} "
                   f"depth_pages={pages} "
                   f"blocks={width * kh * plan[0]}"
                   f"{' (plan)' if splits is None else ''}")
            swept[tag] = t
            log(f"sweep paged_decode B={width} {tag}: {t:.6f} ms, "
                f"{rec['bound_ms'] / t:.1%} of the bound")
    rec["sweep"] = swept
    return rec


# ------------------------------------------------------------------ phase 7


def profile_decode_rounds(torch, cfg, width, rounds=4, params=None):
    """Where a decode round's time goes at the main path's widths: an
    engine with one full round of `width` requests, all prefilled, then
    `profile_steps` over its rounds."""
    import numpy as np

    from repro_torch.core import step_graph
    from repro_torch.serve import PagedServingEngine

    new = 64
    blocks = -(-(SERVE["prompt_len"] + new) // SERVE["block_size"])
    since = step_graph.stats()
    eng = PagedServingEngine(cfg, block_size=SERVE["block_size"],
                             num_blocks=width * blocks, max_in_flight=width,
                             device="cuda", params=params)
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
    out = profile_steps(torch, eng.step_round, rounds,
                        f"decode round (B={width}, {cfg.n_layers} layers)",
                        since)

    def fresh_round():                  # a new step: eager, then captured
        eng._decode_fn = None
        eng.step_round()

    eager_guard_cost(torch, fresh_round,
                     f"{cfg.name} decode round (B={width})")
    return out


def profile_prefill_chunks(torch, cfg, params, rounds=4):
    """Where a replayed prefill chunk's time goes at the main path's shape:
    one request's 32-token chunks at the main path's table width (prompt
    plus generation over 16-token pages: 18) through the engine's
    `ChunkedPrefiller`, on pools of that request's pages, each call a
    chunk further along a 256-token prompt (wrapping), then
    `profile_steps` over them: the first call at the key runs eagerly and
    captures, the rest replay."""
    import numpy as np

    from repro_torch.core import step_graph
    from repro_torch.models import build_model
    from repro_torch.models.params import torch_dtype
    from repro_torch.serve.prefill import ChunkedPrefiller

    since = step_graph.stats()
    blk, chunk, plen = SERVE["block_size"], 32, SERVE["prompt_len"]
    tw = -(-(plen + SERVE["gen"]) // blk)
    shape = (cfg.n_layers, tw + 1, blk, cfg.kv_heads, cfg.resolved_head_dim)
    k_pools = torch.zeros(shape, dtype=torch_dtype(cfg.dtype), device="cuda")
    v_pools = torch.zeros_like(k_pools)
    table = np.arange(1, tw + 1, dtype=np.int32)      # page 0: garbage
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, plen)
    model = build_model(cfg)
    pre = ChunkedPrefiller(model, blk, "cuda")
    calls = [0]

    def step():
        start = chunk * (calls[0] % (plen // chunk))
        calls[0] += 1
        logits, _, _, _ = pre.run_chunk(params, k_pools, v_pools,
                                        prompt[start:start + chunk], table,
                                        start, chunk)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: non-finite prefill logits")

    out = profile_steps(torch, step, rounds,
                        f"prefill chunk {cfg.name} (32 tokens, table width "
                        f"{tw}, {cfg.n_layers} layers)", since)
    if list(pre.graphs) != [(chunk, tw)] or \
            pre.graphs[(chunk, tw)].captures != 1:
        raise AssertionError(f"{cfg.name}: the profiled chunks were not one "
                             f"capture and its replays: {list(pre.graphs)}")

    def fresh_chunk():                  # a new key: eager, then captured
        ChunkedPrefiller(model, blk, "cuda").run_chunk(
            params, k_pools, v_pools, prompt[:chunk], table, 0, chunk)

    eager_guard_cost(torch, fresh_chunk,
                     f"{cfg.name} prefill chunk (32 tokens)")
    return out


def eager_guard_cost(torch, fresh_step, label, turns=3) -> dict:
    """The guard's cost in the eager step a serving run makes before each
    capture (one a key): `fresh_step()`, a step at a new key (run eagerly,
    then captured), on the host clock from an idle device to its work
    done, with the guard as it is ("checked") and with its checks of each
    output (scan, sentinel, injected poison: `core.guard._police`) stubbed
    out for this measurement ("unchecked"), in turns: checked, unchecked,
    unchecked, checked, `turns` times. The eager step's guarded calls are
    its launches (a capture takes its own back). Logs and returns the
    medians and the difference a guarded call."""
    from unittest import mock

    from repro_torch.core import guard
    from repro_torch.kernels import launch_counts

    def run():
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh_step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        return dt, sum(after[k] - before[k] for k in after)

    times = {"checked": [], "unchecked": []}
    calls = set()
    for _ in range(turns):
        for mode in ("checked", "unchecked", "unchecked", "checked"):
            if mode == "checked":
                dt, n = run()
            else:
                with mock.patch.object(guard, "_police",
                                       lambda *a, **k: None):
                    dt, n = run()
            times[mode].append(dt)
            calls.add(n)
    if len(calls) != 1:
        raise AssertionError(f"{label}: eager steps launched {calls} kernels")
    n = calls.pop()
    out = {k: statistics.median(v) for k, v in times.items()}
    out.update(runs=times, guarded_calls=n,
               guard_ms=out["checked"] - out["unchecked"])
    out["guard_us_a_call"] = out["guard_ms"] / n * 1e3 if n else None
    log(f"guard eager cost {label}: eager step plus capture "
        f"{out['checked']:.2f} ms checked, {out['unchecked']:.2f} ms "
        f"unchecked ({json.dumps(times)}); {n} guarded calls; "
        f"{out['guard_ms']:.2f} ms a step"
        + (f", {out['guard_us_a_call']:.1f} µs a call" if n else ""))
    return out


def log_gmm_share(label, by_kernel, wall_ms) -> None:
    """The grouped matmul's (K2) device ms per call in a profile's
    `by_kernel`, logged beside the call's device time and wall clock."""
    device_ms = sum(by_kernel.values())
    gmm_ms = sum(ms for key, ms in by_kernel.items() if "gmm_kernel" in key)
    log(f"{label}: grouped matmul {gmm_ms:.3f} ms of {device_ms:.3f} ms "
        f"device time ({gmm_ms / device_ms:.1%}), wall {wall_ms:.2f} ms")


def profile_steps(torch, step, rounds, label, since):
    """One warm call of `step`, `rounds` calls timed on the host clock,
    then `rounds` more under torch.profiler for the device time by kernel
    (each a replay of the captured step). Busy share = device time per call
    over the unprofiled wall clock per call. Logs the CUDA graphs captured
    since `step_graph.stats()` read `since` (the path's set-up included),
    their capture time and the replays. Returns (busy share, device ms per
    call by kernel name, wall ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            step()
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
    log(f"profile {label}: wall {wall_ms:.2f} ms/call, device busy "
        f"{busy_ms:.2f} ms/call ({100 * busy_ms / wall_ms:.1f}% busy), "
        f"graphs {json.dumps(graph_delta(since))}, device time by kernel "
        f"per call:")
    for ms, count, key in rows[:12]:
        log(f"  {ms:8.3f} ms {count:6d} x  {key[:90]}")
    return busy_ms / wall_ms, {key: ms for ms, _, key in rows}, wall_ms


def log_decode_share(label, by_kernel) -> float:
    """The decode-attention kernels' (split pass + merge) device ms per call
    in a profile's `by_kernel`, logged beside the call's device time."""
    ms = sum(t for key, t in by_kernel.items()
             if "flash_split_kernel" in key or "flash_merge_kernel" in key)
    total = sum(by_kernel.values())
    log(f"{label}: decode attention (split pass + merge) {ms:.3f} ms of "
        f"{total:.3f} ms device time ({ms / total:.1%})")
    return ms


def profile_dense_steps(torch, cfg, params, rounds=4):
    """Where a dense decode step's time goes at the dense path's widths:
    the batch prefilled with random prompts, then `profile_steps` over
    decode steps (the cache holds every step)."""
    from repro_torch.core import step_graph
    from repro_torch.launch.serve import jit_decode_step
    from repro_torch.models import build_model

    import numpy as np

    from repro_torch.launch.serve import make_prompts

    since = step_graph.stats()
    kw = DENSE_SERVE[cfg.name]
    model = build_model(cfg)
    decode = jit_decode_step(model)
    prompts, text = make_prompts(cfg, kw["batch"], kw["prompt_len"],
                                 np.random.default_rng(13), "cuda")
    state = {}
    state["cache"], logits = model.prefill(params, prompts,
                                           pad_to=text + 2 * rounds + 1)
    state["tokens"] = torch.argmax(logits, dim=-1).to(torch.int32)

    def step():
        logits, state["cache"] = decode(params, state["cache"],
                                        {"tokens": state["tokens"]})
        state["tokens"] = torch.argmax(logits, dim=-1).to(torch.int32)

    return profile_steps(torch, step, rounds,
                         f"dense decode step {cfg.name} (B={kw['batch']}, "
                         f"{cfg.n_layers} layers)", since)


# ----------------------------------------------------------------- phase 6b


def gmm_bound(e, c, dm, f, itemsize=2, shared=True):
    """Bytes: the weights, the tokens (one [C, dm] block when `shared`, one
    an expert otherwise) and the [E, C, f] output, each once; flops:
    2 E C dm f on the tensor cores."""
    nbytes = (e * dm * f + (1 if shared else e) * c * dm + e * c * f) \
        * itemsize
    flops = 2 * e * c * dm * f
    bytes_s, ops_s = nbytes / HBM_BW, flops / PEAK["bfloat16"]
    return max(bytes_s, ops_s) * 1e3, \
        "bytes" if bytes_s >= ops_s else "operations"


def time_gmm(torch, params, width):
    """The grouped matmul at the MoE path's shapes, on layer 0's weights:
    decode (C = round width) and prefill (C = 32), gate/up and down."""
    from repro_torch.core import autotune
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    moe = params["layers"]["moe"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    out = {}
    for phase, c in (("decode", width), ("prefill", 32)):
        for proj, w in (("gate/up", moe["w_gate"][0]),
                        ("down", moe["w_down"][0])):
            e, dm, f = w.shape
            shared = proj == "gate/up"       # the dense layer's [1, T, d]
            rows = 1 if shared else e
            # two token sets and two weight layers per batch: the working
            # set is far past the 50 MB L2, as in a round
            w2 = moe["w_gate" if shared else "w_down"][1]
            args = []
            for wi in (w, w2):
                tok = torch.randn(rows, c, dm, generator=gen, device="cuda")
                args.append((tok.to(torch.bfloat16).expand(e, c, dm), wi))
            tokens = args[0][0]
            got, run = path_launch(mg.gmm, tokens, w)
            launches = [(run,), (path_launch(mg.gmm, *args[1])[1],)]
            depth = autotune.last_choice("moe_gmm")
            per_sm = mg.blocks_per_sm(tokens, w, depth)
            grid = mg.grid_for(tokens, w, depth)
            tiles = mg.walk(e, c, dm, f, 2, grid).tiles
            ref = mg.gmm_plain(tokens, w)
            torch.cuda.synchronize()
            err = _close(f"moe_gmm {MOE_ARCH} {phase} {proj} at the path's "
                         f"shape", got, ref, TOL["bfloat16"])
            del got, ref
            kernel_a = median_ms(torch, run_thunk, launches)
            plain_ms = median_ms(torch, mg.gmm_plain, args)
            library_ms = median_ms(torch, torch.bmm, args)
            kernel_b = median_ms(torch, run_thunk, launches)
            host_ms = host_ms_per_call(torch, run, ())
            ms = statistics.median([kernel_a, kernel_b])
            bound_ms, bound_by = gmm_bound(e, c, dm, f)
            spec = mg.gmm_spec(c, dm, mg.F_TILE, torch.bfloat16, f_total=f)
            solved = autotune.choose_depth(spec.profile(),
                                           vars=spec.all_vars())
            shape = {"E": e, "C": c, "dm": dm, "f": f, "shared": shared,
                     "dtype": "bfloat16", "solved_depth": solved,
                     "ran_depth": depth, "blocks_per_sm": per_sm,
                     "slots_a_block": depth, "grid": grid,
                     "tiles": tiles, "tiles_a_block": -(-tiles // grid)}
            log(f"times moe_gmm {phase} {proj} {json.dumps(shape)}: kernel "
                f"{kernel_a:.4f}/{kernel_b:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.bmm {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}), {bound_ms / ms:.1%} of the bound; host "
                f"{host_ms:.5f} ms a call")
            out[f"{phase} {proj}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "host_ms": host_ms, "shape": shape}
            del args, tokens, launches, run
    return out


def host_ms_per_call(torch, fn, args, calls=100, repeats=5):
    """Host time of one call of `fn`: the wall clock of `calls` calls in a
    row, queued behind a device-side sleep so that no call waits on the
    device, median of `repeats` runs."""
    fn(*args)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(60_000_000)        # ~30 ms of device time
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def gmm_host_times(torch) -> dict:
    """`host_ms_per_call` of the launch `gmm` runs (`path_launch`'s thunk:
    the grid and `gmm_at`; the depth solve and the guard's checks stay
    outside) at phase 6b's shapes (C 5 and 32, gate/up with tokens shared
    at stride 0, down with a block per expert) on random bf16 weights, for
    this checkout's package."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    out = {}
    for proj, (e, dm, f) in (("gate/up", (128, 2048, 768)),
                             ("down", (128, 768, 2048))):
        w = torch.randn(e, dm, f, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for phase, c in (("decode", 5), ("prefill", 32)):
            rows = 1 if proj == "gate/up" else e
            tokens = torch.randn(rows, c, dm, generator=gen, device="cuda",
                                 dtype=torch.bfloat16).expand(e, c, dm)
            out[f"{phase} {proj}"] = host_ms_per_call(
                torch, path_launch(mg.gmm, tokens, w)[1], ())
    return out


def ssd_times(torch) -> dict:
    """K4 (`ssd_scan`, this checkout's package) at phase 6c's shape (b 8,
    s 2048, nh 24, p 64, n 128, chunk 256; x/B/C slices of one joint
    projection, dt f32) in bf16 and f32: device ms a call (`median_ms`,
    two operand sets alternating, twice in turns) and the largest error
    against the plain version."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        sets = [ssd_operands(torch, gen, 8, 2048, 24, 64, 128,
                             dtype=getattr(torch, dtype_name))
                for _ in range(2)]
        runs = [path_launch(ss.ssd_scan, *a, chunk=256) for a in sets]
        (y, h), _ = runs[0]
        ry, rh = ss.ssd_scan_plain(*sets[0], chunk=256)
        err = _close(f"ssd_scan {dtype_name} y", y, ry, TOL[dtype_name])
        err = max(err, _close(f"ssd_scan {dtype_name} h_final", h, rh,
                              TOL["float32"]))
        launches = [(run,) for _, run in runs]
        del y, h, ry, rh, runs
        times = [median_ms(torch, run_thunk, launches) for _ in range(2)]
        out[dtype_name] = {"ms": statistics.median(times), "runs": times,
                           "max_abs_err": err}
        del sets
    return out


def dense_first_steps(torch, runs: int = 6) -> dict:
    """Phase 5c's first decode step, taken apart: yi-6b's dense path at
    its `DENSE_SERVE` size (this checkout's package, one set of bf16
    weights from seed 0, strict), `runs` times over, each with a new
    decode step graph, as `serve` drives it: prefill, then
    `timed_decode_loop` through `jit_decode_step`. A run reports its first
    step (its eager run, the capture and the first replay), the capture's
    time (`core.step_graph.stats()`), the p50 of the other steps, one more
    eager step after them, and the collector's collections inside the
    first step and after it (count and ms, by `gc.callbacks`). Also the
    cost of a `gc.freeze()` + `gc.unfreeze()` pair over the objects then
    alive."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import guard, step_graph
    from repro_torch.launch.serve import (SERVING_OVERRIDES, jit_decode_step,
                                          make_prompts, timed_decode_loop)
    from repro_torch.models import build_model

    cfg = get_config("yi-6b").replace(**SERVING_OVERRIDES)
    kw = DENSE_SERVE["yi-6b"]
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen, "cuda")
    guard.set_strict(True)
    collections = []
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            collections.append((time.perf_counter(), info["generation"],
                                time.perf_counter() - started["t"]))

    gc.callbacks.append(on_gc)
    out = []
    try:
        for _ in range(runs):
            prompts, text = make_prompts(cfg, kw["batch"], kw["prompt_len"],
                                         np.random.default_rng(0), "cuda")
            cache, logits = model.prefill(params, prompts,
                                          pad_to=text + kw["gen"])
            tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            since = step_graph.stats()
            decode = jit_decode_step(model)
            t0 = time.perf_counter()
            _, tokens, lat = timed_decode_loop(
                decode, params, cache, tokens, steps=kw["gen"] - 1,
                make_batch=lambda t, i: {"tokens": t})
            t1 = t0 + lat[0]
            graphs = graph_delta(since)["dense_decode"]
            te = time.perf_counter()
            model.decode_step(params, cache, {"tokens": tokens})
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - te) * 1e3
            first = [c for c in collections if t0 <= c[0] <= t1]
            rest = [c for c in collections if t1 < c[0] <= te]
            out.append({
                "first_ms": lat[0] * 1e3,
                "capture_ms": graphs["capture_s"] * 1e3,
                "p50_rest_ms": statistics.median(lat[1:]) * 1e3,
                "eager_ms": eager_ms,
                "gc_first": [len(first), sum(c[2] for c in first) * 1e3,
                             max((c[1] for c in first), default=None)],
                "gc_rest": [len(rest), sum(c[2] for c in rest) * 1e3],
                "captures": graphs["captures"]})
            del cache, logits, decode
    finally:
        gc.callbacks.remove(on_gc)
    n_objects = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.freeze()
    gc.unfreeze()
    freeze_ms = (time.perf_counter() - t0) * 1e3
    return {"runs": out, "gc_objects": n_objects,
            "freeze_unfreeze_ms": freeze_ms}


def round_floor_ms(cfg, params) -> float:
    """A decode round reads every weight once, but of the embedding table
    only the round's rows: the rest of the parameter bytes over 3.35 TB/s."""
    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else
                   v.numel() * v.element_size() for v in tree.values())
    embed = params["embed"]
    return (nbytes(params) - embed.numel() * embed.element_size()) \
        / HBM_BW * 1e3


# --------------------------------------------- phase 3c (dense decode, SSD)

DENSE_S = 1056                 # off the 128-row tile, as the engine pads it
SSD_SHAPES = (   # name, batch, seq, nh, p, n, chunk
    ("mamba2-130m", 2, 512, 24, 64, 128, 256),
    ("hymba-1.5b", 2, 512, 50, 64, 16, 256),
    ("reduced", 2, 64, 8, 16, 16, 16),
)
# K4's chunk-parallel cases (name, batch, seq, nh, p, n, head group): 1, 2
# and 8 kernel chunks (128 rows in bf16) and s 4096, s off the chunk, head
# counts off the group
SSD_CHUNK_CASES = (
    ("1 chunk", 2, 128, 24, 64, 128, 6),
    ("2 chunks", 2, 256, 24, 64, 128, 6),
    ("8 chunks", 2, 1024, 24, 64, 128, 6),
    ("s 4096", 2, 4096, 24, 64, 128, 6),
    ("s off the chunk, hymba's heads", 2, 208, 50, 64, 16, 6),
    ("8 heads in groups of 6 and 2", 2, 192, 8, 16, 32, 6),
    ("every head one group", 2, 256, 24, 64, 128, 24),
    ("one head a group", 2, 256, 24, 64, 128, 1),
)


def ssd_operands(torch, gen, b, s, nh, p, n, *, dtype, strong=False,
                 weak=False):
    """x, B and C as slices of one joint [b, s, nh p + 2 n] projection in
    `dtype` (the SSM block's layout), dt in f32 in [0.1, 0.6) (or 8, with
    A = -1: a strong decay; or in [0.005, 0.03): a weak one, under which a
    64-row chunk keeps ~a third of its state), A = -exp(0.3 N)."""
    joint = torch.randn(b, s, nh * p + 2 * n, generator=gen,
                        device="cuda").to(dtype)
    x = joint[..., :nh * p].reshape(b, s, nh, p)
    bm, cm = joint[..., nh * p:nh * p + n], joint[..., nh * p + n:]
    dt = torch.rand(b, s, nh, generator=gen, device="cuda") * 0.5 + 0.1
    a = -torch.exp(torch.randn(nh, generator=gen, device="cuda") * 0.3)
    if strong:
        dt, a = torch.full_like(dt, 8.0), torch.full_like(a, -1.0)
    if weak:
        dt = dt * 0.05
    return x, dt, a, bm, cm


def check_dense_parity(torch) -> None:
    """K3 (dense flash-decode) at HEAD_SHAPES over a cache of DENSE_S rows,
    pos 0, mid and last, f32 and bf16 (DECODE_TOL), depths 1, 2 and
    solved; K4 (SSD scan) at mamba2's, hymba's and a reduced shape, f32
    throughout and bf16 x/B/C beside f32 dt, depths 1, 2 and solved, and a
    strong decay. K4's tolerance has a relative term (the kernel sums
    32-row tiles, the plain version 256-row chunks): 2e-3 + 2e-3 x |value|
    in f32, 3e-2 + 3e-2 x |value| for bf16 y; its f32 state 2e-3 +
    2e-3 x |value| in both."""
    from repro_torch.core import autotune
    from repro_torch.kernels import ring
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    for name, h, kh, d in HEAD_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q = torch.randn(3, h, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(3, DENSE_S, kh, d, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(3, DENSE_S, kh, d, generator=gen,
                            device="cuda").to(dtype)
            for pos in (0, DENSE_S // 2, DENSE_S - 1):
                ref = da.flash_decode_plain(q, k, v, pos)
                for depth in (1, 2, None):
                    out = da.flash_decode(q, k, v, pos, depth=depth)
                    ran = autotune.last_choice("flash_decode")
                    _close(f"flash_decode {name} S={DENSE_S} pos={pos} "
                           f"{dtype_name} depth={depth} (ran {ran})", out,
                           ref, *DECODE_TOL[dtype_name])
    # the dense path's shape, split 1 and 2 ways and as planned (9 at B 8
    # on 132 SMs): pos in the first split (the later ones empty), at the
    # first split boundary +-1, past S
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q = torch.randn(8, 32, 128, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(8, DENSE_S, 4, 128, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        for splits in (1, 2, None):
            n_split, per = da.split_plan(8, 4, DENSE_S, da.FLASH_BLK,
                                         ring.sm_count(q.device), splits)
            edge = per * da.FLASH_BLK
            for pos in (0, 30, edge - 1, edge, edge + 1, 1040, 1055, 1500):
                _close(f"flash_decode B=8 H=32 KH=4 D=128 S={DENSE_S} "
                       f"pos={pos} {dtype_name} splits={splits} (ran "
                       f"{n_split} x {per} tiles of {da.FLASH_BLK})",
                       da.flash_decode(q, k, v, pos, splits=splits),
                       da.flash_decode_plain(q, k, v, pos),
                       *DECODE_TOL[dtype_name])
    for name, b, s, nh, p, n, chunk in SSD_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            args = ssd_operands(torch, gen, b, s, nh, p, n, dtype=dtype)
            ry, rh = ss.ssd_scan_plain(*args, chunk=chunk)
            for depth in (1, 2, None):
                y, h = ss.ssd_scan(*args, chunk=chunk, depth=depth)
                ran = autotune.last_choice("ssd_scan")
                tag = (f"ssd_scan {name} [b={b},s={s},nh={nh},p={p},n={n}] "
                       f"chunk={chunk} x/B/C {dtype_name} dt float32 "
                       f"depth={depth} (ran {ran})")
                _close(tag + " y", y, ry, TOL[dtype_name])
                _close(tag + " h_final", h, rh, TOL["float32"])
    for name, b, s, nh, p, n, group in SSD_CHUNK_CASES:
        for dtype_name, dt_name in (("float32", "float32"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")):
            args = list(ssd_operands(torch, gen, b, s, nh, p, n,
                                     dtype=getattr(torch, dtype_name)))
            args[1] = args[1].to(getattr(torch, dt_name))
            ry, rh = ss.ssd_scan_plain(*args, chunk=16)
            run = ss.plan(b, s, nh, p, n, args[0].element_size(), 2, group)
            y, h = ss.ssd_scan_at(*args, chunk=16, depth=2, group=group)
            tag = (f"ssd_scan {name} [b={b},s={s},nh={nh},p={p},n={n}] "
                   f"x/B/C {dtype_name} dt {dt_name}: {run.chunks} chunks "
                   f"of {run.chunk}, {run.groups} groups of {run.group} "
                   f"heads")
            _close(tag + " y", y, ry, TOL[dtype_name])
            _close(tag + " h_final", h, rh, TOL["float32"])
    args = ssd_operands(torch, gen, 2, 64, 4, 16, 16, dtype=torch.float32,
                        strong=True)
    ry, rh = ss.ssd_scan_plain(*args, chunk=16)
    y, h = ss.ssd_scan(*args, chunk=16)
    _close("ssd_scan strong decay (dt 8, A -1, chunk 16) y", y, ry,
           TOL["float32"])
    _close("ssd_scan strong decay h_final", h, rh, TOL["float32"])
    torch.cuda.synchronize()


# ------------------------------------------------------------- phase 3d


def check_family_parity(torch) -> None:
    """K3 at the new families' cache shapes (`family_k3_shapes`): at
    paligemma-3b's (H 8, KH 1, D 256) and at whisper-medium's decoder
    self-attention (H 16, KH 16, D 64, a cache of text + new rows, off the
    tile), B 3 at depths 1, 2 and solved, then at the path's batch split 1,
    2 and the plan's ways, each at pos 0, half the cache, the first, middle
    and last decode positions and the last row, f32 and bf16 (DECODE_TOL);
    and the ring form (`models.lm.ring_decode_attention`) at hymba-1.5b's
    (H 25, KH 5, D 64, its batch, a ring of `sliding_window` slots) with
    pos before, at and after the wrap: the new row lands at slot pos % w
    and the output is K3's plain version over the ring at min(pos, w - 1)."""
    from repro_torch.core import autotune
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.models.lm import ring_decode_attention

    shapes = family_k3_shapes()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for label, (bb, h, kh, d, s, mid, _) in shapes.items():
            if label.endswith((" ring", " cross")):
                continue
            first = s - 2 * (s - mid)      # the first decode position
            for b, splits_list in ((3, (None,)), (bb, (1, 2, None))):
                q = torch.randn(b, h, d, generator=gen,
                                device="cuda").to(dtype)
                k, v = (torch.randn(b, s, kh, d, generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                for pos in sorted({0, s // 2, first, mid, s - 2, s - 1}):
                    ref = da.flash_decode_plain(q, k, v, pos)
                    for splits in splits_list:
                        for depth in ((1, 2, None) if b == 3 else (None,)):
                            out = da.flash_decode(q, k, v, pos, depth=depth,
                                                  splits=splits)
                            ran = autotune.last_choice("flash_decode")
                            _close(f"flash_decode {label} H={h} KH={kh} "
                                   f"D={d} B={b} S={s} pos={pos} "
                                   f"{dtype_name} depth={depth} (ran {ran})"
                                   f" splits={splits}",
                                   out, ref, *DECODE_TOL[dtype_name])
        (label, (b, h, kh, d, w, _, _)), = (
            (k, v) for k, v in shapes.items() if k.endswith(" ring"))
        kc, vc = (torch.randn(b, w, kh, d, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        for pos in (0, w // 2 - 1, w - 1, w, w + w // 4, 3 * w + 5):
            q = torch.randn(b, 1, h, d, generator=gen,
                            device="cuda").to(dtype)
            nk, nv = (torch.randn(b, 1, kh, d, generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            out, _, _ = ring_decode_attention(
                q, kc, vc, nk, nv,
                torch.tensor(pos, dtype=torch.int32, device="cuda"), w)
            if not (torch.equal(kc[:, pos % w], nk[:, 0])
                    and torch.equal(vc[:, pos % w], nv[:, 0])):
                raise AssertionError(f"ring decode pos={pos}: the new row "
                                     f"is not at slot {pos % w}")
            _close(f"ring decode {label} H={h} KH={kh} D={d} B={b} w={w} "
                   f"pos={pos} {dtype_name}", out[:, 0],
                   da.flash_decode_plain(q[:, 0], kc, vc, min(pos, w - 1)),
                   *DECODE_TOL[dtype_name])
    torch.cuda.synchronize()


# ------------------------------------------------------------- phase 4c


def check_dense_engine_card_vs_cpu(torch, arch: str) -> None:
    """The dense engine, reduced `arch` in f32, on the card against the CPU
    (same parameters, same prompts): identical greedy tokens, and the
    card's run launched its path's kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             param_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params_cpu = build_model(cfg).init(gen, "cpu")

    def to_card(tree):
        return {k: (to_card(v) if isinstance(v, dict) else v.to("cuda"))
                for k, v in tree.items()}

    kw = dict(batch=4, prompt_len=48, gen=12, seed=1)
    cpu = serve(cfg, device="cpu", params=params_cpu, **kw)
    reset_launch_counts()
    card = serve(cfg, device="cuda", params=to_card(params_cpu), **kw)
    counts = launch_counts()
    if card["decode_captures"] != 1:
        raise AssertionError(f"{arch} dense: {card['decode_captures']} "
                             f"captures of the decode step, want 1")
    if cpu["generated"] != card["generated"]:
        raise AssertionError(f"{arch} dense: card tokens {card['generated']} "
                             f"!= CPU tokens {cpu['generated']}")
    want = dense_launches(cfg, kw["prompt_len"], kw["gen"])
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{arch} dense: launches {got}, want {want}")
    log(f"engine {arch} reduced dense f32 card == cpu: "
        f"{sum(map(len, card['generated']))} tokens identical, launches "
        f"{json.dumps(got)}, one capture, {kw['gen'] - 2} replays")


def dense_launches(cfg, prompt_len: int, gen: int) -> dict:
    """The kernel launches of one dense-engine run: flash_decode once a
    layer per decode step (twice in an enc-dec decoder: self and cross
    attention), ssd_scan once an SSM or hybrid layer in the prefill (when
    the prompt is whole chunks, the reference's route)."""
    want = {}
    if cfg.has_attention:
        want["flash_decode"] = (cfg.n_layers * (gen - 1)
                                * (2 if cfg.enc_dec else 1))
    if cfg.ssm and prompt_len % cfg.ssm_chunk == 0:
        want["ssd_scan"] = cfg.n_layers
    return want


# ------------------------------------------------- phases 5c, 5d and 5e


DENSE_SERVE = {"yi-6b": dict(batch=8, prompt_len=1024, gen=32),
               "mamba2-130m": dict(batch=8, prompt_len=2048, gen=32),
               # 2048 positions reach the sliding-window blocks (2 x 1024)
               # and the ring's roll
               "hymba-1.5b": dict(batch=8, prompt_len=2048, gen=32),
               # 1024 frames, 256 text tokens
               "whisper-medium": dict(batch=8, prompt_len=1024, gen=32),
               # 256 patches, 768 text tokens
               "paligemma-3b": dict(batch=8, prompt_len=1024, gen=32)}
FAMILY_ARCHS = ("hymba-1.5b", "whisper-medium", "paligemma-3b")


def serve_dense_path(torch, arch: str, params=None):
    """`serve(engine="dense")` for `arch` at full width, serving layout
    (bf16), in the guard's strict mode, with the launch counts zeroed just
    before and read just after: the kernels of `dense_launches` and
    nothing else, no backoff, and every decode step a captured graph or
    its replay."""
    from repro_torch.configs import get_config
    from repro_torch.core import step_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SERVING_OVERRIDES, serve

    cfg = get_config(arch).replace(**SERVING_OVERRIDES)
    kw = DENSE_SERVE[arch]
    torch.cuda.reset_peak_memory_stats()
    since = step_graph.stats()
    t0 = time.perf_counter()
    reset_launch_counts()
    stats = serve(cfg, device="cuda", params=params, strict=True, **kw)
    counts = launch_counts()
    wall = time.perf_counter() - t0
    want = {name: 0 for name in counts}
    want.update(dense_launches(cfg, kw["prompt_len"], kw["gen"]))
    if counts != want:
        raise AssertionError(f"{arch} dense: launches {counts}, want {want}")
    gen_tokens = stats["generated"]
    if stats["generated_shape"] != (kw["batch"], kw["gen"]) or not all(
            0 <= t < cfg.vocab for row in gen_tokens for t in row):
        raise AssertionError(f"{arch} dense: bad generation "
                             f"{stats['generated_shape']}")
    graphs = graph_delta(since)
    check_graphs(f"serve dense {arch}", graphs,
                 {"dense_decode": kw["gen"] - 1})
    if stats["substrate"]["backoffs"]:
        raise AssertionError(f"{arch} dense: backoffs under strict: "
                             f"{stats['substrate']}")
    shown = {k: stats[k] for k in ("decode_tok_per_s", "p50_ms", "p99_ms",
                                   "mean_ms", "prefill_s", "decode_s",
                                   "decode_captures", "generated_shape",
                                   "sample_tokens")}
    shown["launches"] = {k: v for k, v in counts.items() if v}
    shown["graphs"] = graphs
    shown["substrate"] = {k: stats["substrate"][k] for k in (
        "strict", "guarded_calls", "backoffs", "numerics_faults")}
    shown["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    shown["wall_s"] = wall
    log(f"serve dense {arch} full width {json.dumps(kw)}: "
        + json.dumps(shown))
    return cfg, stats, counts


def serve_family(torch, arch: str) -> dict:
    """Phase 5e for one arch: random weights from seed 0 at full width
    (serving layout), `serve_dense_path` under strict, a profile of its
    replayed decode steps, and for hymba-1.5b K4's time at its prefill
    shape; the weights are freed before it returns."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVING_OVERRIDES
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(**SERVING_OVERRIDES)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    log(f"{arch}: {model.n_params()} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    _, stats, counts = serve_dense_path(torch, arch, params)
    busy, by_kernel, wall_ms = profile_dense_steps(torch, cfg, params)
    k3_ms = log_decode_share(f"{arch} dense decode step", by_kernel)
    out = {"counts": counts, "busy": busy, "wall_ms": wall_ms,
           "k3_ms": k3_ms, "stats": stats}
    if cfg.ssm:
        out["ssd"] = time_ssd_scan(torch, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_batched_run(torch) -> None:
    """`launch.serve_batched --engine both --prefix-cache` on the card: the
    dense demo (reduced yi-6b, hymba-1.5b, mamba2-130m), then the paged
    and prefix demos, whose asserts must hold."""
    from repro_torch.launch import serve_batched

    t0 = time.perf_counter()
    out = serve_batched.main(["--engine", "both", "--prefix-cache"])
    dense = {arch: {k: r["stats"][k] for k in ("generated_shape",
                                                "decode_tok_per_s")}
             for arch, r in out["dense"].items()}
    log(f"serve_batched --engine both on the card in "
        f"{time.perf_counter() - t0:.1f} s: dense {json.dumps(dense)}, paged "
        f"completed {out['paged']['completed']} of 8 "
        f"(kv_oversubscription {out['paged']['kv_oversubscription']}), "
        f"prefix hits {out['prefix']['prefix_hits']}")


# -------------------------------------------------------------- phase 6c


def check_flash_decode_path_shape(torch, out, q, k, v, pos, label):
    """K3's output `out` against its plain version on a dense path's bf16
    operands, then K3 on the same values in f32 (DECODE_TOL). Returns the
    bf16 error."""
    from repro_torch.core import autotune
    from repro_torch.kernels.decode_attention import decode_attention as da

    depth = autotune.last_choice("flash_decode")
    err = _close(f"flash_decode at {label} {tuple(k.shape)} "
                 f"pos={int(pos)} bfloat16 (depth {depth})", out,
                 da.flash_decode_plain(q, k, v, pos), *DECODE_TOL["bfloat16"])
    q, k, v = q.float(), k.float(), v.float()
    _close(f"flash_decode at {label} {tuple(k.shape)} pos={int(pos)} "
           f"float32", da.flash_decode(q, k, v, pos),
           da.flash_decode_plain(q, k, v, pos), *DECODE_TOL["float32"])
    return err


def flash_decode_bound(b, h, kh, d, pos):
    """(bound ms, bound_by, bytes, flops) of dense decode attention: the
    live K/V rows, q and the output over 3.35 TB/s, or the flops over
    989 TFLOP/s (bf16) if larger."""
    nbytes = 2 * b * (pos + 1) * kh * d * 2 + 2 * b * h * d * 2
    flops = 4 * b * h * d * (pos + 1)
    bytes_s, ops_s = nbytes / HBM_BW, flops / PEAK["bfloat16"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes, flops)


def family_k3_shapes() -> dict:
    """K3 at the new families' decode shapes, from each arch's config and
    its `DENSE_SERVE` run: label -> (B, H, KH, D, S, pos, layers), pos
    the middle of the decode (`gen // 2` steps before the cache's end) as
    yi-6b's. paligemma-3b: one cache of patches + text + new rows;
    whisper-medium: the decoder's self-attention over text + new rows, and
    its cross-attention over the encoder's frames (pos = S - 1); hymba-1.5b:
    its ring of `sliding_window` slots after the wrap (pos' = w - 1)."""
    from repro_torch.configs import get_config, token_split

    shapes = {}
    for arch in FAMILY_ARCHS:
        cfg, kw = get_config(arch), DENSE_SERVE[arch]
        front, text = token_split(cfg, kw["prompt_len"])
        heads = (kw["batch"], cfg.n_heads, cfg.kv_heads,
                 cfg.resolved_head_dim)
        if cfg.sliding_window:
            w = cfg.sliding_window
            shapes[f"{arch} ring"] = (*heads, w, w - 1, cfg.n_layers)
        elif cfg.enc_dec:
            s = text + kw["gen"]
            shapes[f"{arch} self"] = (*heads, s, s - kw["gen"] // 2,
                                      cfg.n_layers)
            shapes[f"{arch} cross"] = (*heads, front, front - 1,
                                       cfg.n_layers)
        else:
            s = front + text + kw["gen"]
            shapes[f"{arch} D={cfg.resolved_head_dim}"] = (
                *heads, s, s - kw["gen"] // 2, cfg.n_layers)
    return shapes


def time_flash_decode(torch, b, h, kh, d, s, pos, n_layers, sweep=False,
                      label="the dense yi-6b shape"):
    """K3 at batch `b` over caches [b, s, kh, d] at `pos` (h query heads),
    one call per layer's cache (`n_layers` of them), pos in a device int32
    as the dense step passes it: the kernel, its plain version, and as a
    yardstick scaled_dot_product_attention over the cache sliced to
    pos + 1, beside the bound. With `sweep`, the kernel again at tile
    heights 64 and 128 and several split counts."""
    import torch.nn.functional as F

    from repro_torch.core import autotune
    from repro_torch.kernels import ring
    from repro_torch.kernels.decode_attention import decode_attention as da

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    dev_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    layers = []
    for _ in range(n_layers):
        q = torch.randn(b, h, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        layers.append((q, k, v, dev_pos))
    runs = [path_launch(da.flash_decode, *a) for a in layers]
    depth = autotune.last_choice("flash_decode")
    q, k, v, _ = layers[0]
    err = check_flash_decode_path_shape(torch, runs[0][0], q, k, v, dev_pos,
                                        label)
    launches = [(run,) for _, run in runs]
    del runs
    sms = ring.sm_count(q.device)
    n_split, per = da.split_plan(b, kh, s, da.FLASH_BLK, sms)

    sliced = [(q[:, :, None], k[:, :pos + 1].transpose(1, 2),
               v[:, :pos + 1].transpose(1, 2)) for q, k, v, _ in layers]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)

    kernel_a = median_ms(torch, run_thunk, launches)
    plain_ms = median_ms(torch, da.flash_decode_plain, layers)
    library_ms = median_ms(torch, sdpa, sliced)
    kernel_b = median_ms(torch, run_thunk, launches)
    ms = statistics.median([kernel_a, kernel_b])
    bound_ms, bound_by, nbytes, flops = flash_decode_bound(b, h, kh, d, pos)
    shape = {"B": b, "H": h, "KH": kh, "D": d, "S": s, "pos": pos,
             "blk": da.FLASH_BLK, "dtype": "bfloat16", "depth": depth,
             "splits": n_split, "tiles_per_split": per,
             "blocks": b * kh * n_split, "sms": sms}
    log(f"times flash_decode {label} {json.dumps(shape)}: kernel "
        f"{kernel_a:.6f}/{kernel_b:.6f} ms, plain {plain_ms:.6f} ms, sdpa "
        f"{library_ms:.6f} ms, bound {bound_ms:.7f} ms ({bound_by}, "
        f"{nbytes} B, {flops} flop), {bound_ms / ms:.1%} of the bound")
    if sweep:
        for blk in (64, 128):
            seen = set()
            for splits in (None, 1, 2, 3, 5, 9, 17):
                plan = da.split_plan(b, kh, s, blk, sms, splits)
                if plan in seen:
                    continue
                seen.add(plan)

                swept = [(path_launch(da.flash_decode, *a, blk=blk,
                                      splits=plan[0])[1],) for a in layers]
                t = median_ms(torch, run_thunk, swept)
                del swept
                log(f"sweep flash_decode B={b} blk={blk} splits={plan[0]} "
                    f"tiles_per_split={plan[1]} depth="
                    f"{autotune.last_choice('flash_decode')} blocks="
                    f"{b * kh * plan[0]}{' (plan)' if splits is None else ''}"
                    f": {t:.6f} ms, {bound_ms / t:.1%} of the bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "splits": n_split, "shape": shape}


def launch_ms(torch, fn, calls=10) -> dict:
    """Device time of each kernel one call of `fn` launches (torch.profiler
    over `calls` calls, per call), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key): e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def kernel_name(key: str) -> str:
    """A kernel's name from its profiler key, templated or not
    ("void f<128>(float*)" and "f(float*)" give "f")."""
    found = re.findall(r"(\w+)(?=[<(])", key)
    return found[0] if found else key


def time_ssd_scan(torch, cfg, dtype_name="bfloat16", sweep=False):
    """K4 at `cfg`'s dense prefill shape (mamba2-130m: b 8, s 2048, nh 24,
    p 64, n 128; hymba-1.5b: b 8, s 2048, nh 50, p 64, n 16; chunk 256;
    x/B/C slices of one joint projection in `dtype_name`,
    dt f32), two operand sets alternating: the kernel (and each of its
    launches) and its plain version. No single PyTorch call computes the
    SSD scan, so there is no library time. The bound is the larger of the
    bytes in and out over 3.35 TB/s and the reference spec's flops
    (flops_per_tile x chunks) over the peak of the kernel's products: bf16
    tensor cores (989 TFLOP/s), f32 CUDA cores (67 TFLOP/s). Each launch
    is printed beside its own bytes over 3.35 TB/s, the f32 workspace
    counted where it is written and where it is read. `sweep` adds head
    groups x depths."""
    from repro_torch.core import autotune
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.models.ssm import ssm_dims

    kw = DENSE_SERVE[cfg.name]
    dims = ssm_dims(cfg)
    b, s, chunk = kw["batch"], kw["prompt_len"], cfg.ssm_chunk
    nh, p, n = dims["nh"], dims["p"], dims["n"]
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sets = [ssd_operands(torch, gen, b, s, nh, p, n, dtype=dtype)
            for _ in range(2)]
    runs = [path_launch(ss.ssd_scan, *a, chunk=chunk) for a in sets]
    (y, h), _ = runs[0]
    launches = [(run,) for _, run in runs]
    del runs
    depth = autotune.last_choice("ssd_scan")
    ry, rh = ss.ssd_scan_plain(*sets[0], chunk=chunk)
    err = _close(f"ssd_scan at {cfg.name}'s prefill shape, {dtype_name} "
                 f"(depth {depth}) y", y, ry, TOL[dtype_name])
    err = max(err, _close(f"ssd_scan at {cfg.name}'s prefill shape, "
                          f"{dtype_name} h_final", h, rh, TOL["float32"]))
    del y, h, ry, rh

    def plain(*a):
        return ss.ssd_scan_plain(*a, chunk=chunk)

    kernel_a = median_ms(torch, run_thunk, launches)
    plain_ms = median_ms(torch, plain, sets)
    kernel_b = median_ms(torch, run_thunk, launches)
    ms = statistics.median([kernel_a, kernel_b])
    per_launch = launch_ms(torch, launches[0][0])
    isz = dtype.itemsize
    nbytes = (2 * b * s * nh * p * isz        # x in, y out
              + 2 * b * s * n * isz           # B, C
              + b * s * nh * 4 + nh * 4       # dt, A (f32)
              + b * nh * p * n * 4)           # h_final out (f32)
    spec = ss.ssd_spec(chunk, nh, p, n, dtype, seq_len=s)
    flops = spec.flops_per_tile * b * (s // chunk)
    bytes_s, ops_s = nbytes / HBM_BW, flops / PEAK[dtype_name]
    bound_ms = max(bytes_s, ops_s) * 1e3
    bound_by = "bytes" if bytes_s >= ops_s else "operations"
    run = ss.plan(b, s, nh, p, n, isz, depth)
    shape = {"b": b, "s": s, "nh": nh, "p": p, "n": n, "chunk": chunk,
             "dtype": dtype_name, "dt": "float32", **run._asdict()}
    x_b, bc_b, dt_b = b * s * nh * p * isz, b * s * n * isz, b * s * nh * 4
    ws = run.workspace_bytes
    launch_bound_ms = {name: nb / HBM_BW * 1e3 for name, nb in (
        ("chunk_state_kernel", x_b + bc_b + dt_b + ws),     # x, B, dt -> ws
        ("state_pass_kernel", 2 * ws + b * nh * p * n * 4),  # ws -> ws, h
        ("chunk_scan_kernel", 2 * x_b + 2 * bc_b + dt_b + ws))}  # -> y
    log(f"times ssd_scan {cfg.name} {json.dumps(shape)}: kernel "
        f"{kernel_a:.4f}/{kernel_b:.4f} ms ({json.dumps(per_launch)}; each "
        f"launch's bytes over 3.35 TB/s: {json.dumps(launch_bound_ms)}), "
        f"plain {plain_ms:.4f} ms, no library call, bound {bound_ms:.5f} ms "
        f"({bound_by}, {nbytes} B, {flops:.4g} flop), "
        f"{bound_ms / ms:.1%} of the bound")
    if sweep:
        swept = {}
        for group in (2, 3, 4, 6, 8, 12, 24):
            for k in (1, 2):
                t = median_ms(torch, lambda *a, g=group, k=k: ss.ssd_scan_at(
                    *a, chunk=chunk, depth=k, group=g), sets)
                swept[f"group {group} depth {k}"] = t
                log(f"sweep ssd_scan {dtype_name} group={group} depth={k}: "
                    f"{t:.4f} ms, {bound_ms / t:.1%} of the bound")
        log("sweep: " + json.dumps(swept))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "launch_ms": per_launch, "launch_bound_ms": launch_bound_ms,
            "shape": shape}


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


def _close(name: str, got, want, tol: float, rtol=None) -> float:
    """allclose with atol `tol` and rtol `rtol` (`tol` when None)."""
    import torch

    rtol = tol if rtol is None else rtol
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=tol))
    log(f"parity {name}: max_abs_err={err:.3e} atol={tol:g} rtol={rtol:g} "
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
    # the row gather at the per-SM splits phase 9 sweeps (blocks x slots)
    idx = torch.randint(0, 4096, (1 << 15,), generator=gen, device="cuda",
                        dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        tab = table(4096, 128, dtype)
        for blocks, slots in K5A_SPLITS:
            _equal(f"row_gather {dtype} 4096x128 n=32768 at {blocks} blocks "
                   f"an SM x {slots} slots",
                   cg.row_gather_at(tab, idx, blocks_per_sm=blocks,
                                    slots=slots),
                   cg.row_gather_plain(tab, idx))
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
    # the scatter-add at the per-SM splits phase 9 sweeps: 4099 tiles (off
    # every split's block boundary) and 5 (fewer than any split's blocks)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (128, 5):
            tab = table(1 << 16, d, dtype)
            for n in (8 * 4099, 40):
                uniq = torch.as_tensor(
                    rng.permutation(1 << 16)[:n].astype(np.int32),
                    device="cuda")
                upd = table(n, d, dtype)
                want = sa.scatter_add_unique_plain(tab.clone(), uniq, upd)
                for blocks, slots in K6_SPLITS:
                    _equal(f"scatter_add_unique {dtype} d={d} n={n} at "
                           f"{blocks} blocks an SM x {slots} slots",
                           sa.scatter_add_at(tab.clone(), uniq, upd,
                                             blocks_per_sm=blocks,
                                             slots=slots), want)

    # the triad: f32 bitwise, bf16 at 2e-2; 16-byte items, 4-byte units
    # (64x3 f32, both bf16 shapes: 12-byte items), 2-byte units (63x3 bf16:
    # 6-byte items) and 16-byte items at an address 132 bytes in (4-byte
    # units); then given item sizes: items smaller than the caller's tile,
    # fewer items than the card's SMs, an odd item count
    def triad_check(tag, dtype, got, want):
        if dtype == torch.float32:
            _equal(tag, got, want)
        else:
            _close(tag, got, want, TRIAD_TOL["bfloat16"])

    for dtype in (torch.float32, torch.bfloat16):
        for n, d, rows in ((4096, 128, 128), (640, 96, 64), (64, 3, 2),
                           (63, 3, 1), (257, 33, 16)):
            b = table(n, d, dtype)
            c = table(n, d, dtype)
            if n % rows:                          # a view one row in
                b, c = b[1:], c[1:]
            want = sc.triad_plain(b, c, 2.5)
            for depth in (1, 2, None):
                triad_check(f"triad {dtype} {tuple(b.shape)} rows={rows} "
                            f"depth={depth}", dtype,
                            sc.triad(b, c, 2.5, rows=rows, depth=depth),
                            want)
        for n, d, rows, item in TRIAD_PLANS:
            b = table(n, d, dtype)
            c = table(n, d, dtype)
            triad_check(f"triad {dtype} {n}x{d} rows={rows}: {n // item} "
                        f"items of {item} rows", dtype,
                        sc.triad_at(b, c, 2.5, rows=rows, item_rows=item),
                        sc.triad_plain(b, c, 2.5))
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

    want = {name: 0 for name in counts}
    want.update(row_gather=1 + bool(plan.n_singles),
                span_gather=int(bool(plan.n_spans)), scatter_add=1,
                stream_triad=1)
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


def time_gups_kernels(torch, st, gmm_case):
    """Kernel, plain and library times of the four GUPS-path kernels at the
    shapes phase 8 gave them, each kernel checked against its plain
    version on exactly these inputs; then the depth sweeps, the grouped
    matmul's on `gmm_case` (tokens, weights, bound ms) from phase 6b."""
    from repro_torch.kernels import ring
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
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
    # the timing loops time the launch each wrapper runs at the path's
    # depth (`path_launch`), without the guard's checks around it; the
    # guarded wrappers are timed beside them below
    runs = {
        "row_gather": path_launch(cg.row_gather, table, idx,
                                  depth=depths["row_gather"]),
        "span_gather": path_launch(cg.span_gather, table, starts,
                                   span=plan.span,
                                   depth=depths["span_gather"]),
        "scatter_add": path_launch(sa.scatter_add_unique, work, uniq, summed,
                                   depth=depths["scatter_add"]),
        "stream_triad": path_launch(sc.triad, b, c, s,
                                    depth=depths["stream_triad"]),
    }
    got = {name: out for name, (out, _) in runs.items()
           if name != "scatter_add"}      # in place: checked on copies below
    runs = {name: run for name, (_, run) in runs.items()}
    triad_plan = sc.plan(*b.shape, 4, 128, depths["stream_triad"])

    # K5a's per-SM split and grid at this shape
    k5a_blocks, k5a_slots = cg.row_gather_split(depths["row_gather"], table)
    k5a_grid = ring.launch_grid(table.device, n // 8, k5a_slots,
                                k5a_slots * 8 * row_bytes, cg.THREADS,
                                k5a_blocks)[0]
    # K6's, at its 8 KiB slots (table rows and update rows)
    k6_blocks, k6_slots = sa.scatter_add_split(depths["scatter_add"], table,
                                               summed)
    k6_grid = ring.launch_grid(table.device, u // 8, k6_slots,
                               k6_slots * 16 * row_bytes, sa.THREADS,
                               k6_blocks)[0]
    cases = {
        "row_gather": dict(
            plain=lambda: cg.row_gather_plain(table, idx),
            library=(torch.index_select, (table, 0, idx.long())),
            bound=_bound_ms(2 * n * row_bytes + 4 * n),
            shape={"table": list(table.shape), "n": n, "rows_per_tile": 8,
                   "dtype": "float32", "blocks_per_sm": k5a_blocks,
                   "slots_a_block": k5a_slots, "grid": k5a_grid}),
        "span_gather": dict(
            plain=lambda: cg.span_gather_plain(table, starts, plan.span),
            library=(torch.index_select, (table, 0, span_rows)),
            bound=_bound_ms(2 * t * plan.span * row_bytes + 4 * t),
            shape={"table": list(table.shape), "spans": t, "span": plan.span,
                   "dtype": "float32"}),
        "scatter_add": dict(
            plain=lambda: sa.scatter_add_unique_plain(work, uniq, summed),
            library=(lambda i, v: work.index_add_(0, i, v),
                     (uniq.long(), summed)),
            bound=_bound_ms(3 * u * row_bytes + 4 * u, u * d),
            shape={"table": list(table.shape), "n": u, "rows_per_tile": 8,
                   "dtype": "float32", "blocks_per_sm": k6_blocks,
                   "slots_a_block": k6_slots, "grid": k6_grid}),
        "stream_triad": dict(
            plain=lambda: sc.triad_plain(b, c, s),
            library=(lambda x, y: torch.add(x, y, alpha=s), (b, c)),
            bound=_bound_ms(3 * nt * 4, 2 * nt),
            shape={"N": b.shape[0], "d": d, "rows": 128, "dtype": "float32",
                   **triad_plan._asdict()}),
    }
    out = {}
    for name, case in cases.items():
        if name == "scatter_add":       # in place: compare on copies
            before = work.clone()
            out_ = sa.scatter_add_unique(before.clone(), uniq, summed,
                                         depth=depths["scatter_add"])
            ref = sa.scatter_add_unique_plain(before, uniq, summed)
            del before
        else:
            out_, ref = got.pop(name), case["plain"]()
        torch.cuda.synchronize()
        err = _max_abs_err(out_, ref)
        if not torch.equal(out_, ref):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"the GUPS path's shapes: {err:.3e}")
        del out_, ref
        lib_fn, lib_args = case["library"]
        kernel_a = median_ms(torch, runs[name], [()])
        plain_ms = median_ms(torch, lambda: case["plain"](), [()])
        library_ms = median_ms(torch, lib_fn, [lib_args])
        kernel_b = median_ms(torch, runs[name], [()])
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
    guarded = time_guarded_gups(torch, {
        "row_gather": (lambda: cg.row_gather(table, idx,
                                             depth=depths["row_gather"]),
                       runs["row_gather"]),
        "scatter_add": (lambda: sa.scatter_add_unique(
            work, uniq, summed, depth=depths["scatter_add"]),
            runs["scatter_add"])})
    for name in ("row_gather", "scatter_add"):
        out[name]["guarded"] = guarded[name]

    # the same work at other depths (K5a: tiles in flight per SM, and its
    # per-SM split as blocks x slots), and the triad at other tile heights
    sweep = [("row_gather", f"depth={k} per SM "
              f"({'x'.join(map(str, cg.row_gather_split(k, table)))})",
              path_launch(cg.row_gather, table, idx, depth=k)[1])
             for k in (4, 8, 16, 32, 56)]
    sweep += [("row_gather", f"{k} blocks an SM x {slots} slots",
               lambda k=k, slots=slots: cg.row_gather_at(
                   table, idx, blocks_per_sm=k, slots=slots))
              for k, slots in K5A_SPLITS]
    sweep += [("scatter_add", f"depth={k} per SM "
               f"({'x'.join(map(str, sa.scatter_add_split(k, work, summed)))})",
               path_launch(sa.scatter_add_unique, work, uniq, summed,
                           depth=k)[1])
              for k in (4, 8, 16, 28)]
    sweep += [("scatter_add", f"{k} blocks an SM x {slots} slots",
               lambda k=k, slots=slots: sa.scatter_add_at(
                   work, uniq, summed, blocks_per_sm=k, slots=slots))
              for k, slots in K6_SPLITS]
    sweep += [("stream_triad", f"items of {r} rows ({r * row_bytes} B an "
               f"array, {sc.resident_blocks(r * row_bytes)} blocks an SM "
               f"fit)", lambda r=r: sc.triad_at(b, c, s, item_rows=r))
              for r in TRIAD_SWEEP]
    sweep += [("stream_triad", f"rows={r} depth={k} (items of "
               f"{sc.plan(*b.shape, 4, r, k).item_rows} rows)",
               path_launch(sc.triad, b, c, s, rows=r, depth=k)[1])
              for r, k in ((128, 1), (64, 1), (64, 3), (32, 2))]
    tokens, w, gmm_bound_ms = gmm_case
    deepest = mg.kernel_depth(64, c=tokens.shape[1], dm=tokens.shape[2],
                              itemsize=tokens.element_size())
    sweep += [("moe_gmm", f"decode gate/up depth={k} "
               f"({mg.blocks_per_sm(tokens, w, k)} blocks an SM fit, grid "
               f"{mg.grid_for(tokens, w, k)})",
               path_launch(mg.gmm, tokens, w, depth=k)[1])
              for k in sorted({1, 2, 3, 4, 6, 8, deepest})]
    # depth 2 on grids of k blocks on every SM, whole tiles dealt in turn
    # (up to one tile a block more than others)
    sm = ring.sm_count(tokens.device)
    most = mg.blocks_per_sm(tokens, w, 2)
    tiles = mg.walk(*tokens.shape, w.shape[2], 2, 1).tiles
    sweep += [("moe_gmm", f"decode gate/up depth=2 at {k} blocks an SM "
               f"(grid {sm * k}, {-(-tiles // (sm * k))} tiles a block at "
               f"most)",
               lambda k=k: mg.gmm_at(tokens, w, depth=2, blocks=sm * k))
              for k in sorted({2, most})]
    bounds = {name: t["bound_ms"] for name, t in out.items()}
    bounds["moe_gmm"] = gmm_bound_ms
    swept = {}
    for name, tag, fn in sweep:
        ms = median_ms(torch, fn, [()])
        swept[f"{name} {tag}"] = ms
        log(f"sweep {name} {tag}: {ms:.4f} ms, "
            f"{bounds[name] / ms:.1%} of the bound")
    log("sweep: " + json.dumps(swept))
    span_want = cg.span_gather_plain(table, starts, plan.span)
    out["span_gather"]["wait_ab"] = time_wait_ab(
        torch, cg, "span_gather", f"at depth {depths['span_gather']}",
        lambda: torch.equal(cg.span_gather(
            table, starts, span=plan.span, depth=depths["span_gather"]),
            span_want),
        runs["span_gather"])
    del span_want
    before = work.clone()
    sa_want = sa.scatter_add_unique_plain(before.clone(), uniq, summed)
    out["scatter_add"]["wait_ab"] = time_wait_ab(
        torch, sa, "scatter_add", f"at {k6_blocks} blocks an SM x {k6_slots} "
        "slots",
        lambda: torch.equal(sa.scatter_add_unique(
            before.clone(), uniq, summed, depth=depths["scatter_add"]),
            sa_want),
        runs["scatter_add"])
    del before, sa_want
    out["stream_triad"]["walk_ab"] = time_triad_walk(torch, b, c, s,
                                                     triad_plan.item_rows)
    return out


def sync_wall_ms(torch, fn, calls=11) -> float:
    """Host wall clock of one call of `fn` from an idle device to its work
    done (a sync before and after), median of `calls` calls (ms)."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_guarded_gups(torch, pairs) -> dict:
    """The GUPS kernels' guarded wrappers (the guard's checks, the scan's
    read of every row written, its sync) beside the launches they run
    without the guard, both timed by `sync_wall_ms`, in turns: launch,
    wrapper, wrapper, launch. `pairs` maps a kernel to (wrapper call,
    launch thunk). Logs GUPS through the wrappers and through the bare
    launches on the same clock."""
    times = {name: {"launch": [], "wrapper": []} for name in pairs}
    for which in ("launch", "wrapper", "wrapper", "launch"):
        for name, (wrapper, launch) in pairs.items():
            fn = wrapper if which == "wrapper" else launch
            times[name][which].append(sync_wall_ms(torch, fn))
    out = {name: {k: statistics.median(v) for k, v in t.items()}
           for name, t in times.items()}
    for name, t in out.items():
        t["runs"] = times[name]
        t["guard_ms"] = t["wrapper"] - t["launch"]
    gups = {which: GUPS["n"] / (sum(t[which] for t in out.values()) * 1e-3)
            / 1e9 for which in ("launch", "wrapper")}
    log(f"guarded GUPS kernels at the path's shapes (ms a call, sync to "
        f"sync): {json.dumps(out)}; GUPS through the wrappers "
        f"{gups['wrapper']:.4f}, through the bare launches "
        f"{gups['launch']:.4f} (same clock)")
    out["gups"] = gups
    return out


KERNELS = ROOT / "src" / "repro_torch" / "kernels"
WAIT_INLINE = "repro::cp_async_wait_range<0, repro::kMaxDepth - 1>(depth - 1);"
WAIT_CALLED = "repro::cp_async_wait_pending(depth - 1);"
# The sources that inline their ring wait (K5b, K6), and the indent of its
# line: phase 9 times each against a copy that calls the header's wait
WAITS = {"span_gather": ("coro_gather/csrc/coro_gather.cu", 6),
         "scatter_add": ("coro_scatter_add/csrc/scatter_add.cu", 4)}
TRIAD_SOURCE = "stream_copy/csrc/triad.cu"


def triad_persistent_edits(per_sm: int):
    """The edits that put K7 on a persistent grid of `per_sm` blocks an SM,
    block g walking items g, g + grid, ... through its one slot (the
    mbarrier's phase flips each item; the block reads the slot before it
    is refilled)."""
    return [
        ("                 int item_bytes) {\n  const int tid = threadIdx.x;\n",
         "                 int item_bytes, int64_t items) {\n"
         "  const int tid = threadIdx.x;\n"
         "  for (int64_t item = blockIdx.x, k = 0; item < items; "
         "item += gridDim.x, ++k) {\n"),
        ("  const int64_t off = static_cast<int64_t>(blockIdx.x) * units;",
         "  const int64_t off = item * units;"),
        ("      repro::mbar_init(full, 1);\n      repro::mbar_fence_init();\n",
         "      if (k == 0) {\n        repro::mbar_init(full, 1);\n"
         "        repro::mbar_fence_init();\n      }\n"),
        ("    repro::mbar_wait(full, 0);",
         "    repro::mbar_wait(full, static_cast<uint32_t>(k & 1));"),
        ("      repro::st_global_cs(a + off + u, repro::axpy_unit<T, V, true>"
         "(bs[u], cs[u], s));\n  }\n}",
         "      repro::st_global_cs(a + off + u, repro::axpy_unit<T, V, true>"
         "(bs[u], cs[u], s));\n    __syncthreads();\n  }\n  }\n}"),
        ("  kernel<<<static_cast<unsigned>(items), kThreads, smem, stream>>>(\n"
         "      static_cast<const V*>(b), static_cast<const V*>(c), "
         "static_cast<V*>(a), s, item_bytes);",
         "  int dev = 0, sms = 0;\n  cudaGetDevice(&dev);\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
         f"  const int64_t cap = static_cast<int64_t>(sms) * {per_sm};\n"
         "  const int64_t grid = items < cap ? items : cap;\n"
         "  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(\n"
         "      static_cast<const V*>(b), static_cast<const V*>(c), "
         "static_cast<V*>(a), s, item_bytes, items);"),
    ]


def patched_copy(tmp: Path, name: str, rel: str, edits) -> Path:
    """A copy of the kernels tree under `tmp` / `name` (the sources include
    ../../csrc/coro_ring.cuh) with `edits`, (text, replacement) pairs, made
    to the source `rel`; each text must occur exactly once. Returns the
    edited source's path."""
    import shutil

    tree = tmp / name
    shutil.copytree(KERNELS, tree, ignore=shutil.ignore_patterns(
        "*.py", "__pycache__"))
    src = tree / rel
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: the text to change occurs "
                                 f"{text.count(old)} times in {rel}: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return src


def time_wait_ab(torch, mod, name: str, label: str, check, run):
    """`run()` with the ring wait of `mod.SOURCE` inlined (the source) and
    with the header's called wait (a copy of the source, built in a
    temporary directory), timed in turns: called, inlined, inlined,
    called. `name` is the kernel's key in `WAITS`; `check()`, the kernel
    against its plain version, must hold before each time. Returns
    {"called": ms, "inlined": ms}, each a median."""
    import tempfile

    from repro_torch.kernels import build

    rel, indent = WAITS[name]
    inline = mod.SOURCE
    times = {"called": [], "inlined": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        called = patched_copy(Path(tmp), "called", rel,
                              [(" " * indent + WAIT_INLINE,
                                " " * indent + WAIT_CALLED)])
        build.build([called])
        for wait in ("called", "inlined", "inlined", "called"):
            mod.SOURCE = called if wait == "called" else inline
            try:
                if not check():
                    raise AssertionError(f"{name} ({wait} wait) differs "
                                         "from its plain version")
                times[wait].append(median_ms(torch, run, [()]))
            finally:
                mod.SOURCE = inline
    log(f"{name} wait {label}: called "
        f"{times['called'][0]:.5f}/{times['called'][1]:.5f} ms, inlined "
        f"{times['inlined'][0]:.5f}/{times['inlined'][1]:.5f} ms")
    return {k: statistics.median(v) for k, v in times.items()}


def time_triad_walk(torch, b, c, s, item_rows):
    """K7 at phase 8's shape in items of `item_rows` rows: one pass a block
    (the source) and copies of the source on persistent grids of
    `TRIAD_PERSISTENT` blocks an SM (built in a temporary directory), each
    checked bitwise against the plain version and timed in turns: the
    source, the copies, the copies in reverse, the source."""
    import tempfile

    from repro_torch.kernels import build
    from repro_torch.kernels.stream_copy import stream_copy as sc

    source = sc.SOURCE
    want = sc.triad_plain(b, c, s)
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        copies = {f"persistent {k} blocks an SM": patched_copy(
            Path(tmp), f"persistent{k}", TRIAD_SOURCE,
            triad_persistent_edits(k)) for k in TRIAD_PERSISTENT}
        build.build(list(copies.values()))
        names = ["one pass a block", *copies]
        for name in names + names[::-1]:
            sc.SOURCE = copies.get(name, source)
            try:
                if not torch.equal(sc.triad_at(b, c, s, item_rows=item_rows),
                                   want):
                    raise AssertionError(f"stream_triad ({name}) differs "
                                         "from its plain version")
                times.setdefault(name, []).append(median_ms(
                    torch, lambda: sc.triad_at(b, c, s, item_rows=item_rows),
                    [()]))
            finally:
                sc.SOURCE = source
    log("stream_triad walk in items of " + str(item_rows) + " rows: " +
        ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms"
                  for name, ts in times.items()))
    return {k: statistics.median(v) for k, v in times.items()}


# ----------------------------------------------------------------- phase 10


def guard_operands(torch):
    """Small operands for each of the nine guarded wrappers (K4's backward
    among them), f32 on the card: {kernel: thunk calling its wrapper
    once}."""
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.stream_copy import stream_copy as sc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    paged = paged_problem(torch, gen, [17, 40], h=8, kh=2, d=64, blk=16,
                          dtype=torch.float32, device="cuda")
    q = torch.randn(2, 8, 64, generator=gen, device="cuda")
    k, v = (torch.randn(2, 80, 2, 64, generator=gen, device="cuda")
            for _ in range(2))
    tokens = torch.randn(2, 16, 64, generator=gen, device="cuda")
    w = torch.randn(2, 64, 256, generator=gen, device="cuda")
    ssd = ssd_operands(torch, gen, 1, 128, 2, 64, 64, dtype=torch.float32)
    dy = torch.randn(1, 128, 2, 64, generator=gen, device="cuda")
    table = torch.randn(256, 128, generator=gen, device="cuda")
    idx = torch.randint(0, 256, (64,), generator=gen, device="cuda",
                        dtype=torch.int32)
    starts = torch.arange(0, 128, 16, device="cuda", dtype=torch.int32)
    uniq = torch.randperm(256, generator=gen, device="cuda")[:64].int()
    upd = torch.randn(64, 128, generator=gen, device="cuda")
    b, c = (torch.randn(256, 64, generator=gen, device="cuda")
            for _ in range(2))
    return {
        "paged_decode": lambda: da.paged_flash_decode(*paged),
        "moe_gmm": lambda: mg.gmm(tokens, w),
        "flash_decode": lambda: da.flash_decode(q, k, v, 70),
        "ssd_scan": lambda: ss.ssd_scan(*ssd, chunk=64),
        "ssd_scan_bwd": lambda: ss.ssd_scan_bwd(*ssd, dy, chunk=64),
        "row_gather": lambda: cg.row_gather(table, idx),
        "span_gather": lambda: cg.span_gather(table, starts, span=8),
        "scatter_add": lambda: sa.scatter_add_unique(table.clone(), uniq, upd),
        "stream_triad": lambda: sc.triad(b, c, 2.5, rows=128),
    }


def _guard_delta(before: dict) -> dict:
    from repro_torch.core import guard

    now = guard.stats()
    return {k: now[k] - before[k] for k in before
            if isinstance(before[k], int) and not isinstance(before[k], bool)}


def check_sentinel(torch) -> None:
    """(a) With the sentinel on full, each of the nine guarded wrappers
    once, eagerly: a parity check each against the plain versions on the
    card, no mismatch, one launch each."""
    from repro_torch.core import guard
    from repro_torch.kernels import launch_counts, reset_launch_counts

    calls = guard_operands(torch)
    guard.set_parity("full")
    before = guard.stats()
    reset_launch_counts()
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    delta, counts = _guard_delta(before), launch_counts()
    guard.set_parity("off")
    if delta["parity_checks"] != len(calls) or \
            delta["parity_mismatches"] or \
            delta["clean_calls"] != len(calls) or \
            any(counts[k] != 1 for k in calls):
        raise AssertionError(f"sentinel over the {len(calls)} wrappers: "
                             f"{delta}, launches {counts}")
    log(f"guard (a) sentinel full over {sorted(calls)}: {json.dumps(delta)}")


def check_poisoned_plain(torch) -> None:
    """(b) A deliberately wrong plain version around K5a's real attempt
    (`row_gather_at` at each rung's split): every rung mismatches, the
    ladder halves to 1, every depth is quarantined, `KernelParityError`."""
    from repro_torch.core import autotune, guard
    from repro_torch.kernels.coro_gather import coro_gather as cg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    table = torch.randn(1024, 128, generator=gen, device="cuda")
    idx = torch.randint(0, 1024, (512,), generator=gen, device="cuda",
                        dtype=torch.int32)

    def attempt(d):
        blocks, slots = cg.row_gather_split(d, table)
        return cg.row_gather_at(table, idx, blocks_per_sm=blocks, slots=slots)

    guard.set_parity("full")
    try:
        guard.guarded_call(cg.row_gather_spec(8, 128, torch.float32),
                           (table, idx), attempt, depth=8, n_tiles=64,
                           plain=lambda t, i: cg.row_gather_plain(t, i) + 1)
    except guard.KernelParityError as e:
        err = e
    else:
        raise AssertionError("a poisoned plain version raised no "
                             "KernelParityError")
    finally:
        guard.set_parity("off")
    ladder = guard.last_ladder("row_gather")
    quarantined = autotune.quarantined_depths("row_gather")
    if ladder != [8, 4, 2, 1] or quarantined != [1, 2, 4, 8]:
        raise AssertionError(f"poisoned plain: ladder {ladder}, quarantined "
                             f"{quarantined}")
    autotune.clear_quarantine("row_gather")
    log(f"guard (b) poisoned plain around row_gather_at: "
        f"{type(err).__name__}, ladder {ladder}, quarantined {quarantined}")


def check_resource_ladder(torch) -> None:
    """(c) K6 asked for rings that `check_smem` refuses (64 and 32 slots of
    8 KiB): the ladder lands on 16 slots, the table equals the plain
    version's bitwise, the refused depths are quarantined and
    `choose_depth` does not propose them."""
    from repro_torch.core import autotune, guard
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    table = torch.randn(4096, 128, generator=gen, device="cuda")
    idx = torch.randperm(4096, generator=gen, device="cuda")[:1024].int()
    upd = torch.randn(1024, 128, generator=gen, device="cuda")
    want = sa.scatter_add_unique_plain(table.clone(), idx, upd)
    spec = sa.scatter_add_spec(8, 128, torch.float32)
    res = guard.guarded_call(
        spec, (table, idx, upd),
        lambda d: sa.scatter_add_at(table, idx, upd, blocks_per_sm=1,
                                    slots=d),
        depth=64, n_tiles=128, plain=sa.updated_rows, in_place=True,
        written=lambda t: t.index_select(0, idx),
        finite=lambda t: sa.rows_finite(t, idx))
    ladder = guard.last_ladder("scatter_add")
    refused = autotune.quarantined_depths("scatter_add")
    proposed = autotune.choose_depth(spec.profile(), kernel="scatter_add",
                                     vars=spec.all_vars())
    if ladder != [64, 32, 16] or res.depth != 16 or refused != [32, 64] \
            or proposed in refused or not torch.equal(table, want):
        raise AssertionError(f"resource ladder: {ladder}, landed "
                             f"{res.depth}, quarantined {refused}, proposed "
                             f"{proposed}, equal "
                             f"{bool(torch.equal(table, want))}")
    autotune.clear_quarantine("scatter_add")
    log(f"guard (c) scatter_add resource ladder {ladder} (check_smem "
        f"refused {refused}), bitwise equal to plain, choose_depth then "
        f"proposes {proposed}")


def check_capture(torch) -> None:
    """(d) With the sentinel on full, a dense decode `StepGraph` of reduced
    yi-6b (f32): the first step runs eagerly (policed: one check per
    layer's flash-decode) and captures; its replays add no parity check."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import guard
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import jit_decode_step, make_prompts
    from repro_torch.models import build_model

    cfg = get_config("yi-6b").reduced().replace(dtype="float32",
                                                param_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    params = model.init(gen, "cuda")
    prompts, text = make_prompts(cfg, 2, 24, np.random.default_rng(24),
                                 "cuda")
    cache, logits = model.prefill(params, prompts, pad_to=text + 8)
    tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    decode = jit_decode_step(model)
    guard.set_parity("full")
    reset_launch_counts()
    before = guard.stats()
    checks = []
    for _ in range(4):
        logits, cache = decode(params, cache, {"tokens": tokens})
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        checks.append(_guard_delta(before)["parity_checks"])
    guard.set_parity("off")
    delta, counts = _guard_delta(before), launch_counts()
    if decode.graph.captures != 1 or decode.graph.replays != 3 or \
            checks != [cfg.n_layers] * 4 or delta["parity_mismatches"] or \
            counts["flash_decode"] != 4 * cfg.n_layers or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"capture under the sentinel: captures "
                             f"{decode.graph.captures}, replays "
                             f"{decode.graph.replays}, checks after each "
                             f"step {checks}, {delta}, launches {counts}")
    log(f"guard (d) dense decode StepGraph under the sentinel: 1 capture, 3 "
        f"replays, parity checks after each step {checks} (the eager step's "
        f"{cfg.n_layers} only), launches {counts['flash_decode']}")


def check_chaos(torch) -> None:
    """(e) `launch.chaos_serve` on reduced yi-6b on the card, seed 0, 20
    rounds: every request terminal, no parity mismatch (the harness
    asserts both)."""
    from repro_torch.core import autotune, guard
    from repro_torch.launch import chaos_serve

    summary = chaos_serve.main(["--seed", "0", "--rounds", "20"])
    guard.set_parity("off")
    autotune.clear_quarantine()
    if summary["device"] != "cuda" or summary["substrate"][
            "parity_mismatches"]:
        raise AssertionError(f"chaos: {summary}")
    log("guard (e) chaos_serve yi-6b reduced on the card: "
        + json.dumps(summary))


def guard_phase(torch) -> dict:
    """Phase 10, (a)-(e) and the guard's host cost; prints and returns
    `guard.stats()`."""
    from repro_torch.core import guard

    check_sentinel(torch)
    check_poisoned_plain(torch)
    check_resource_ladder(torch)
    check_capture(torch)
    check_chaos(torch)
    guard_host_cost(torch)
    stats = guard.stats()
    log("guard stats: " + json.dumps(stats))
    return stats


def wall_us_per_call(torch, fn, calls=200, repeats=5) -> float:
    """Host wall clock of one call of `fn` followed by a device sync,
    median of `repeats` runs of `calls` calls (µs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


def guard_host_cost(torch) -> dict:
    """The guard's own cost per eager call at a small K5a shape (a 256 x 128
    f32 table, 64 rows), each call followed by a device sync: the
    unguarded launch (the wrapper's, `path_launch`), the guard without its
    scan (a guarded call whose checked view is empty), the wrapper (guard
    and scan), the wrapper with the sentinel on full. Timed in turns,
    twice."""
    from repro_torch.core import guard
    from repro_torch.kernels.coro_gather import coro_gather as cg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    table = torch.randn(256, 128, generator=gen, device="cuda")
    idx = torch.randint(0, 256, (64,), generator=gen, device="cuda",
                        dtype=torch.int32)
    spec = cg.row_gather_spec(8, 128, torch.float32)
    launch = path_launch(cg.row_gather, table, idx, depth=8)[1]

    def no_scan():
        return guard.guarded_call(spec, (table, idx), lambda d: launch(),
                                  depth=8, n_tiles=8,
                                  plain=cg.row_gather_plain,
                                  written=lambda out: ())

    def wrapper():
        return cg.row_gather(table, idx, depth=8)

    def sentinel():
        guard.set_parity("full")
        try:
            return wrapper()
        finally:
            guard.set_parity("off")

    fns = {"unguarded_launch": launch, "guard_no_scan": no_scan,
           "guard_scan": wrapper, "guard_scan_parity_full": sentinel}
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(wall_us_per_call(torch, fns[name]))
    out = {name: statistics.median(ts) for name, ts in times.items()}
    log("guard host cost per eager call (µs, a call plus a device sync; "
        f"K5a at 256x128 f32, 64 rows): {json.dumps(times)}")
    return out


def check_gups_breakdown(torch, st) -> dict:
    """(g) The GUPS kernels through `launch.gups.observed` at phase 8's
    shapes, three calls each (a kernel's first sample at a tile count is
    dropped as warm-up), then `obs.stall_breakdown()`: every GUPS kernel
    is there with its recorded tile profile, and its compute, transfer
    and gap sum to its observed per-tile time."""
    from repro_torch import obs
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.stream_copy import stream_copy as sc
    from repro_torch.launch.gups import observed

    table, idx, plan = st["table"], st["idx"], st["plan"]
    starts = torch.as_tensor(plan.span_starts, device="cuda")
    uniq = torch.unique(idx)[:(torch.unique(idx).numel() // 8) * 8]
    upd = torch.zeros(uniq.numel(), table.shape[1], device="cuda")
    b, c = st["b"], st["c"]
    for _ in range(3):
        observed("row_gather", idx.numel() // 8, cg.row_gather, table, idx)
        observed("span_gather", starts.numel(), cg.span_gather, table,
                 starts, span=plan.span)
        observed("scatter_add", uniq.numel() // 8, sa.scatter_add_unique,
                 st["updated"], uniq, upd)
        observed("stream_triad", b.shape[0] // 128, sc.triad, b, c,
                 GUPS["scalar"])
    report = obs.stall_breakdown()
    out = {}
    for name in ("row_gather", "span_gather", "scatter_add", "stream_triad"):
        bd = report["kernels"].get(name)
        if bd is None or bd.get("unattributed"):
            raise AssertionError(f"stall breakdown has no attributed "
                                 f"{name}: {report}")
        parts = bd["compute_us"] + bd["transfer_us"] + bd["gap_us"]
        fracs = bd["compute_frac"] + bd["transfer_frac"] + bd["gap_frac"]
        if abs(parts - bd["observed_us"]) > 2e-3 or abs(fracs - 1) > 1e-3:
            raise AssertionError(f"{name}: the split {bd} does not sum to "
                                 f"its observed time")
        out[name] = bd
    log(f"guard (g) stall breakdown of the GUPS kernels ({report['machine']}"
        f"): {json.dumps(out)}")
    return out


# ----------------------------------------------------------------- phase 11

# Training (the port's `runtime.train_loop.train`): granite-moe-1b-a400m at
# full width, f32 parameters and bf16 compute, batch 8 x seq 512 (4096
# tokens a step) on the Markov task, AdamW, 20 steps. Each step launches K2
# 9 times a layer: 3 forward and, for each, its d tokens and d weights.
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
# The data and the optimizer (PERF.md §6, training, and
# scripts/train_sweep.py, for the runs behind them):
# the chain runs over the model's first 512 token ids (over all 49155, 20
# steps of 4096 tokens visit each id's successors about twice and the loss
# stays at 11.2-11.3); and the global-norm clip is off: under the
# reference's init (each stacked leaf's fan-in is its shape[-2], the heads
# for wq/wk/wv, so those weights are 8x the per-layer fan-in's scale) the
# 24-layer stack's gradient norm is ~1e13 at the first step, so a clip at
# 1.0 scales every update under AdamW's eps and the loss stays flat;
# without it AdamW's per-leaf normalisation trains
TRAIN_DATA_VOCAB, TRAIN_LR, TRAIN_CLIP = 512, 1e-2, 0.0
# The SSM and hybrid families at the same settings, through K4's forward
# and backward kernels (a call each a layer a step); hymba (1.5 B
# parameters) takes fewer steps
SSM_TRAIN = (("mamba2-130m", 20), ("hymba-1.5b", 10))
K4_FWD_KERNELS = ("chunk_state_kernel", "state_pass_kernel",
                  "chunk_scan_kernel")
K4_BWD_KERNELS = ("bwd_state_kernel", "bwd_pass_kernel", "bwd_chunk_kernel",
                  "bwd_reduce_kernel")


def gmm_train_products(cfg, t: int):
    """K2's six products in a training step at `t` tokens: (name, E, C,
    dm, f, tokens shared by every expert). The backward of out = x @ w is
    d x = d out @ w^T and d w = x^T @ d out (`kernels/moe_gmm/ops.py`)."""
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return (("forward gate/up", e, t, d, ff, True),
            ("forward down", e, t, ff, d, False),
            ("d tokens gate/up", e, t, ff, d, False),
            ("d tokens down", e, t, d, ff, False),
            ("d weights gate/up", e, d, t, ff, True),
            ("d weights down", e, ff, t, d, False))


def gmm_grads(torch, tokens, w, up, via, depth=None):
    """(out, d tokens, d weights) of out = moe_gmm(tokens, w) under the
    upstream gradient `up`: through K2 (`via` "kernel") or through the
    plain version's autograd."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.moe_gmm.ops import moe_gmm

    t = tokens.detach().clone().requires_grad_(True)
    wt = w.detach().clone().requires_grad_(True)
    if via == "kernel":
        out = moe_gmm(t, wt, depth=depth)
    else:
        out = mg.gmm_plain(t.expand(wt.shape[0], -1, -1), wt)
    out.backward(up)
    return out.detach(), t.grad, wt.grad


def check_gmm_grads(torch, cfg) -> float:
    """Phase 11a: K2's gradients at the training step's six products
    (the gate/up forward, on one token block shared by the experts, and
    the down forward, on per-expert tokens, each with its two backward
    products) against the plain version's autograd on the card: f32 at
    2e-3, bf16 at 3e-2 + 3e-2 x |value|, depths 1, 2 and solved."""
    from repro_torch.kernels import launch_counts

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    t = TRAIN_BATCH * TRAIN_SEQ
    worst = 0.0
    for name, e, c, dm, f, shared in gmm_train_products(cfg, t)[:2]:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            tokens = torch.randn(1 if shared else e, c, dm, generator=gen,
                                 device="cuda").to(dtype)
            w = (torch.randn(e, dm, f, generator=gen, device="cuda")
                 * dm ** -0.5).to(dtype)
            up = (torch.randn(e, c, f, generator=gen, device="cuda")
                  * c ** -0.5).to(dtype)
            want = gmm_grads(torch, tokens, w, up, "plain")
            for depth in (1, 2, None):
                before = launch_counts()["moe_gmm"]
                got = gmm_grads(torch, tokens, w, up, "kernel", depth)
                torch.cuda.synchronize()
                if launch_counts()["moe_gmm"] - before != 3:
                    raise AssertionError(f"moe_gmm grads {name}: "
                                         f"{launch_counts()['moe_gmm'] - before}"
                                         " launches, not 3")
                for part, a, b in zip(("out", "d tokens", "d weights"), got,
                                      want):
                    worst = max(worst, _close(
                        f"moe_gmm grads {name} {part} [{e},{c},{dm}]x"
                        f"[{dm},{f}] shared={shared} {dtype_name} "
                        f"depth={depth}", a, b, TOL[dtype_name]))
                del got
            del tokens, w, up, want
    torch.cuda.empty_cache()
    return worst


def check_train_step_card_vs_cpu(torch, arch: str = TRAIN_ARCH) -> None:
    """Phase 11b: a reduced f32 step of `arch` on the card against the same
    step on the CPU, from the same parameters and batch: loss, every
    gradient leaf and the AdamW update (params, mu, nu) at 2e-3, with the
    step's kernel launches (granite-moe: K2, 9 a layer; mamba2 and hymba:
    a K4 forward and a K4 backward call a layer) and none on the CPU; for
    granite-moe then the card's state through a checkpoint and back,
    bitwise, on the card."""
    import tempfile

    from repro_torch.checkpointing import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.runtime.steps import value_and_grad

    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             param_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, "cpu")
    batch = MarkovTask(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4)).batch_for_step(0)
    opt = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree.map_tree(lambda x: x.to(dev), params)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        reset_launch_counts()
        loss, grads = value_and_grad(model, p, b)
        state, metrics = apply_updates(init_state(p), grads, opt)
        out[dev] = (loss, grads, state, launch_counts())
    want = {k: 0 for k in out["cuda"][3]}
    if cfg.moe:
        want["moe_gmm"] = 9 * cfg.n_layers
    else:
        want["ssd_scan"] = want["ssd_scan_bwd"] = cfg.n_layers
    if any(out["cpu"][3].values()) or out["cuda"][3] != want:
        raise AssertionError(f"train step {arch}: launches cpu "
                             f"{out['cpu'][3]}, card {out['cuda'][3]}, want "
                             f"none and {want}")
    worst = _close(f"train step {arch} reduced f32 loss card vs cpu",
                   out["cuda"][0].reshape(1).cpu(), out["cpu"][0].reshape(1),
                   2e-3)
    for label, i in (("grad", 1), ("update", 2)):
        for (path, a), b in zip(tree.paths(out["cuda"][i]),
                                tree.leaves(out["cpu"][i])):
            if a.dtype.is_floating_point:
                worst = max(worst, _close_quiet(
                    f"train step {arch} {label} {'/'.join(path)}", a.cpu(), b,
                    2e-3))
    launched = {k: v for k, v in out["cuda"][3].items() if v}
    log(f"train step {arch} reduced f32 card == cpu: loss "
        f"{float(out['cuda'][0]):.6f} / {float(out['cpu'][0]):.6f}, every "
        f"gradient leaf and the AdamW update within 2e-3 (max abs err "
        f"{worst:.3e}), launches {json.dumps(launched)}")
    if arch != TRAIN_ARCH:
        return
    state = out["cuda"][2]
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(state, d, 1)
        back = checkpoint.restore(d, tree.map_tree(torch.zeros_like, state))
    for (path, a), b in zip(tree.paths(back), tree.leaves(state)):
        if a.device != b.device or a.dtype != b.dtype or \
                not torch.equal(a, b):
            raise AssertionError(f"checkpoint round trip: {'/'.join(path)} "
                                 "differs")
    log(f"checkpoint round trip on the card: {len(tree.leaves(state))} "
        f"leaves bitwise, on {back['step'].device}")


def _close_quiet(name, got, want, tol) -> float:
    """`_close` without a log line per tensor (a step has many leaves)."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or \
            not bool(torch.allclose(got, want, rtol=tol, atol=tol)):
        raise AssertionError(f"{name}: card disagrees with the CPU, "
                             f"max_abs_err={err:.3e}")
    return err


def ssd_train_shape(arch: str):
    """(b, s, nh, p, n, chunk) of K4 in `arch`'s training step."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssm_dims

    cfg = get_config(arch)
    d = ssm_dims(cfg)
    return TRAIN_BATCH, TRAIN_SEQ, d["nh"], d["p"], d["n"], cfg.ssm_chunk


def ssd_grad_operands(torch, gen, arch, dtype, with_dh=False, weak=False):
    """K4's backward operands at `arch`'s training shape: x, B and C slices
    of one joint projection, dt f32 (`ssd_operands`, `weak`: a decay weak
    enough that the gradient carried across a chunk counts), dy in x's
    type, and dh_final (f32) or None, as in training."""
    b, s, nh, p, n, _ = ssd_train_shape(arch)
    args = ssd_operands(torch, gen, b, s, nh, p, n, dtype=dtype, weak=weak)
    dy = torch.randn(b, s, nh, p, generator=gen, device="cuda").to(dtype)
    dh = torch.randn(b, nh, p, n, generator=gen, device="cuda") \
        if with_dh else None
    return args, dy, dh


def check_k4_grads(torch) -> float:
    """Phase 11c: K4's backward kernel (`ssd_scan_bwd`) at mamba2-130m's and
    hymba-1.5b's full training shapes (b 8, s 512, chunk 256) against its
    plain version on the card: dx, ddt, dA, dB and dC, f32 at 2e-3 + 2e-3 x
    |value| and bf16 at 3e-2 + 3e-2 x |value|, depths 1, 2 and solved (the
    heads a block walks), dh_final None (as in training); and at the
    solved depth under a weak decay with dh_final given (at the path's
    decay a 64-row chunk keeps under 1e-9 of its state, so the gradient
    carried back across chunks would not show); one count a call, and no
    forward launch."""
    from repro_torch.core import autotune
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    worst = 0.0
    for arch, _ in SSM_TRAIN:
        chunk = ssd_train_shape(arch)[-1]
        for dtype_name in ("float32", "bfloat16"):
            for with_dh in (False, True):     # and, given, a weak decay
                args, dy, dh = ssd_grad_operands(
                    torch, gen, arch, getattr(torch, dtype_name), with_dh,
                    weak=with_dh)
                want = ss.ssd_scan_bwd_plain(*args, dy, dh, chunk=chunk)
                for depth in ((1, 2, None) if not with_dh else (None,)):
                    before = launch_counts()
                    got = ss.ssd_scan_bwd(*args, dy, dh, chunk=chunk,
                                          depth=depth)
                    torch.cuda.synchronize()
                    after = launch_counts()
                    moved = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
                    if moved != {"ssd_scan_bwd": 1}:
                        raise AssertionError(f"ssd_scan_bwd {arch}: launches "
                                             f"{moved}, not one call")
                    ran = autotune.last_choice("ssd_scan_bwd")
                    for part, a, b in zip(("dx", "ddt", "dA", "dB", "dC"),
                                          got, want):
                        worst = max(worst, _close(
                            f"ssd_scan_bwd {arch} train shape {part} "
                            f"{dtype_name} depth={depth} (ran {ran}) "
                            f"{'weak decay, dh_final given' if with_dh else 'dh_final None'}",
                            a, b, TOL[dtype_name]))
                    del got
                del args, dy, dh, want
                gc_collect(torch)
    return worst


def train_full_width(torch, arch: str = TRAIN_ARCH,
                     steps: int = TRAIN_STEPS) -> dict:
    """Phase 11d: `train` on `arch` at full width for `steps` steps. Every
    loss finite and the mean of the last 5 below the mean of the first 5;
    exactly the step's kernel launches (granite-moe: 9 K2 a
    layer; mamba2 and hymba: a K4 forward and a K4 backward call a layer)
    and nothing else launched. Then a fresh state's steps for the profile
    (device busy share; K2's share, or K4's forward and backward ms a
    step) and the guard's cost a step (checked against unchecked)."""
    from repro_torch.configs import get_config
    from repro_torch.core import step_graph
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.train_loop import train

    cfg = get_config(arch)
    if (cfg.dtype, cfg.param_dtype) != ("bfloat16", "float32"):
        raise AssertionError(f"{arch}: {cfg.dtype}/{cfg.param_dtype}")
    model = build_model(cfg)
    data = DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=steps, warmup_steps=2,
                      grad_clip=TRAIN_CLIP)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    rep = train(model, steps=steps, data_cfg=data, opt=opt, log_every=1,
                device="cuda")
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [rep.losses[i] for i in range(steps)]
    per_step = {k: 0 for k in counts}
    if cfg.moe:
        per_step["moe_gmm"] = 9 * cfg.n_layers
    else:
        per_step["ssd_scan"] = per_step["ssd_scan_bwd"] = cfg.n_layers
    want = {k: v * steps for k, v in per_step.items()}
    per_step = {k: v for k, v in per_step.items() if v}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = statistics.median(rep.step_s)
    step_ms = [s * 1e3 for s in rep.step_s]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"train {arch} full width ({model.n_params()} parameters, f32 "
        f"params, bf16 compute, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"{steps} steps, Markov task over {TRAIN_DATA_VOCAB} ids, lr "
        f"{TRAIN_LR:g}, clip {TRAIN_CLIP:g}): "
        f"losses {json.dumps([round(x, 4) for x in losses])}, mean of the "
        f"first 5 {first:.4f}, of the last 5 {last:.4f}"
        f" ({'fell' if last < first else 'did not fall'})")
    log(f"train {arch}: step p50 {p50 * 1e3:.1f} ms (steps "
        f"{json.dumps([round(s, 1) for s in step_ms])} ms), "
        f"{tokens / p50:.0f} tokens/s, peak memory {peak_gb:.2f} GB, "
        f"launches {json.dumps({k: counts[k] for k in per_step})} "
        f"({json.dumps(per_step)} a step), wall {rep.wall_s:.1f} s")
    if counts != want:
        raise AssertionError(f"train {arch}: launches {counts}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: losses {losses}")
    if not last < first:
        raise AssertionError(f"train {arch}: loss did not fall: {losses}")
    del rep
    gc_collect(torch)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = init_state(model.init(gen, "cuda"))
    step = make_train_step(model, opt)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in MarkovTask(data).batch_for_step(0).items()}
    busy, by_kernel, wall_ms = profile_steps(
        torch, lambda: step(state, batch), 2,
        f"{arch} train step (B {TRAIN_BATCH} x {TRAIN_SEQ})",
        step_graph.stats())
    out = {"losses": losses, "loss_first5": first, "loss_last5": last,
           "step_ms_p50": p50 * 1e3, "step_ms": step_ms,
           "tokens_per_s": tokens / p50, "peak_memory_gb": peak_gb,
           "busy_share": busy, "launches": {k: counts[k] for k in per_step},
           "launches_a_step": per_step}
    if cfg.moe:
        log_gmm_share(f"{arch} train step", by_kernel, wall_ms)
    else:
        device_ms = sum(by_kernel.values())
        for part, names in (("forward", K4_FWD_KERNELS),
                            ("backward", K4_BWD_KERNELS)):
            ms = sum(t for key, t in by_kernel.items()
                     if kernel_name(key) in names)
            out[f"k4_{part}_ms_a_step"] = ms
            log(f"{arch} train step: K4 {part} {ms:.3f} ms of {device_ms:.3f}"
                f" ms device time ({ms / device_ms:.1%}), "
                f"{per_step['ssd_scan']} calls")
    guard = eager_guard_cost(torch, lambda: step(state, batch),
                             f"{arch} train step", turns=1)
    out["guard_ms_a_step"] = guard["guard_ms"]
    del state, batch
    gc_collect(torch)
    return out


def gc_collect(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def time_gmm_train(torch, cfg) -> dict:
    """Phase 11e: K2 at the six training products in bf16, the launch the
    path runs (no guard) against the plain version, torch.bmm and the
    bound, in turns: kernel, plain, bmm, kernel."""
    from repro_torch.core import autotune
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    out = {}
    for name, e, c, dm, f, shared in gmm_train_products(
            cfg, TRAIN_BATCH * TRAIN_SEQ):
        args = []
        for _ in range(2):
            tok = torch.randn(1 if shared else e, c, dm, generator=gen,
                              device="cuda").to(torch.bfloat16)
            w = (torch.randn(e, dm, f, generator=gen, device="cuda")
                 * dm ** -0.5).to(torch.bfloat16)
            args.append((tok.expand(e, c, dm), w))
        tokens, w = args[0]
        got, run = path_launch(mg.gmm, tokens, w)
        depth = autotune.last_choice("moe_gmm")
        grid = mg.grid_for(tokens, w, depth)
        launches = [(run,), (path_launch(mg.gmm, *args[1])[1],)]
        err = _close(f"moe_gmm train {name} at the path's shape", got,
                     mg.gmm_plain(tokens, w), TOL["bfloat16"])
        del got
        kernel_a = median_ms(torch, run_thunk, launches, repeats=11)
        plain_ms = median_ms(torch, mg.gmm_plain, args, repeats=11)
        library_ms = median_ms(torch, torch.bmm, args, repeats=11)
        kernel_b = median_ms(torch, run_thunk, launches, repeats=11)
        ms = statistics.median([kernel_a, kernel_b])
        bound_ms, bound_by = gmm_bound(e, c, dm, f, shared=shared)
        shape = {"E": e, "C": c, "dm": dm, "f": f, "shared": shared,
                 "dtype": "bfloat16", "ran_depth": depth, "grid": grid,
                 "tiles": mg.walk(e, c, dm, f, 2, grid).tiles}
        log(f"times moe_gmm train {name} {json.dumps(shape)}: kernel "
            f"{kernel_a:.4f}/{kernel_b:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.bmm {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of the bound")
        out[f"train {name}"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": shape}
        del args, tokens, w, launches, run
        gc_collect(torch)
    # a layer runs each gate/up product twice (gate and up), down once
    layer_ms = sum(t["ms"] * (2 if "gate/up" in k else 1)
                   for k, t in out.items())
    log(f"times moe_gmm train: 9 launches a layer {layer_ms:.3f} ms, "
        f"{layer_ms * cfg.n_layers:.1f} ms a step ({cfg.n_layers} layers)")
    return out


def ssd_bwd_bound(b, s, nh, p, n, dtype_name):
    """The least time of K4's backward at a shape: the larger of its bytes
    (x, dy, B, C, dt and A read once; dx, dB, dC, ddt and dA written once)
    over 3.35 TB/s and its operations (`ssd_scan.bwd_flops`: the causal
    half of each product at the kernel's 64-row chunks, the products with
    the heads' shared B and C once a chunk) over the peak of the inputs'
    type."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    isz = 2 if dtype_name == "bfloat16" else 4
    nbytes = (3 * b * s * nh * p * isz          # x, dy in; dx out
              + 4 * b * s * n * isz             # B, C in; dB, dC out
              + 2 * b * s * nh * 4 + 2 * nh * 4)  # dt, A in; ddt, dA out
    flops = ss.bwd_flops(ss.BWD_CHUNK, nh, p, n) * b * -(-s // ss.BWD_CHUNK)
    bytes_s, ops_s = nbytes / HBM_BW, flops / PEAK[dtype_name]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes, flops)


def time_ssd_bwd(torch) -> dict:
    """Phase 11e: K4's backward alone at mamba2-130m's and hymba-1.5b's
    training shapes (bf16 and f32, dh_final None), the launch the path runs
    (no guard; each of its four launches by name) against the plain
    version and the bound, in turns: kernel, plain, kernel. No single
    PyTorch call computes it: no library time."""
    from repro_torch.core import autotune
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    out = {}
    for arch, _ in SSM_TRAIN:
        b, s, nh, p, n, chunk = ssd_train_shape(arch)
        for dtype_name in ("bfloat16", "float32"):
            sets = [ssd_grad_operands(torch, gen, arch,
                                      getattr(torch, dtype_name))
                    for _ in range(2)]
            runs = [path_launch(ss.ssd_scan_bwd, *args, dy, dh, chunk=chunk)
                    for args, dy, dh in sets]
            depth = autotune.last_choice("ssd_scan_bwd")
            got = runs[0][0]
            args, dy, dh = sets[0]
            want = ss.ssd_scan_bwd_plain(*args, dy, dh, chunk=chunk)
            err = max(_close(f"ssd_scan_bwd {arch} timing shape {part} "
                             f"{dtype_name}", a, w, TOL[dtype_name])
                      for part, a, w in zip(("dx", "ddt", "dA", "dB", "dC"),
                                            got, want))
            del got, want
            launches = [(run,) for _, run in runs]
            plain_args = [(*a, d_y, d_h) for a, d_y, d_h in sets]

            def plain(*a):
                return ss.ssd_scan_bwd_plain(*a, chunk=chunk)

            kernel_a = median_ms(torch, run_thunk, launches, repeats=11)
            plain_ms = median_ms(torch, plain, plain_args, repeats=5)
            kernel_b = median_ms(torch, run_thunk, launches, repeats=11)
            ms = statistics.median([kernel_a, kernel_b])
            per_launch = launch_ms(torch, launches[0][0])
            bound_ms, bound_by, nbytes, flops = ssd_bwd_bound(
                b, s, nh, p, n, dtype_name)
            run = ss.bwd_plan(b, s, nh, p, n, depth)
            shape = {"b": b, "s": s, "nh": nh, "p": p, "n": n,
                     "chunk": chunk, "dtype": dtype_name, "dt": "float32",
                     **run._asdict()}
            log(f"times ssd_scan_bwd {arch} train {json.dumps(shape)}: "
                f"kernel {kernel_a:.4f}/{kernel_b:.4f} ms "
                f"({json.dumps(per_launch)}), plain {plain_ms:.4f} ms, no "
                f"library call, bound {bound_ms:.5f} ms ({bound_by}, "
                f"{nbytes} B, {flops:.4g} flop), {bound_ms / ms:.1%} of the "
                f"bound")
            out[f"{arch} train {dtype_name}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "launch_ms": per_launch,
                "shape": shape}
            del sets, runs, launches, plain_args
            gc_collect(torch)
    return out


def train_phase(torch) -> dict:
    """Phase 11: (a) K2's gradients, (b) reduced steps card == CPU
    (granite-moe, mamba2, hymba) and a checkpoint round trip, (c) K4's
    gradients at the two SSM training shapes, (d) granite-moe, mamba2 and
    hymba trained at full width, (e) K2's times at the training products
    and K4's backward's at the SSM training shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core import guard

    guard.set_parity("off")
    cfg = get_config(TRAIN_ARCH)
    check_gmm_grads(torch, cfg)
    for arch in (TRAIN_ARCH, *(a for a, _ in SSM_TRAIN)):
        check_train_step_card_vs_cpu(torch, arch)
    check_k4_grads(torch)
    run = train_full_width(torch)
    run["ssm"] = {arch: train_full_width(torch, arch, steps)
                  for arch, steps in SSM_TRAIN}
    run["gmm_times"] = time_gmm_train(torch, cfg)
    run["ssd_bwd_times"] = time_ssd_bwd(torch)
    return run


def ssd_bwd_entry(trained) -> dict:
    """The kernels line's entry of K4's backward: launches (calls) in the
    mamba2-130m training run, its time at mamba2's training shape in bf16
    (the path's type) and at the others beside it."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    times = trained["ssd_bwd_times"]
    main_key = f"{SSM_TRAIN[0][0]} train bfloat16"
    return {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:60",
        "tpu": "none of its own: the backward of "
               "kernels/ssd_scan/ssd_scan.py:ssd_scan, which the reference "
               "differentiates through its jnp ssd_chunked "
               "(models/ssm.py:48)",
        "launches": trained["ssm"][SSM_TRAIN[0][0]]["launches"]
        ["ssd_scan_bwd"],
        "launches_by_path": {f"{arch} train": t["launches"]["ssd_scan_bwd"]
                             for arch, t in trained["ssm"].items()},
        "launches_a_train_step": {
            arch: t["launches_a_step"]["ssd_scan_bwd"]
            for arch, t in trained["ssm"].items()},
        "parity": "ok",
        **{k: times[main_key][k] for k in keys},
        "launch_ms": times[main_key]["launch_ms"],
        "shape": times[main_key]["shape"],
        "at_other_shapes": {name: {k: t[k] for k in keys + (
            "launch_ms", "shape")} for name, t in times.items()
            if name != main_key},
    }


# --------------------------------------------------------------------- main


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--gmm-host-time"]:
        card_info(torch)
        print(json.dumps({"gmm_host_ms": gmm_host_times(torch)}), flush=True)
        return 0
    if sys.argv[1:] == ["--dense-first-step"]:
        card_info(torch)
        print(json.dumps({"dense_first_step": dense_first_steps(torch)}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--train"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card_info(torch)
        build_kernels()
        run = train_phase(torch)
        print(json.dumps({"train": run}), flush=True)
        return 0
    if sys.argv[1:] == ["--ssd-time"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        card_info(torch)
        print(json.dumps({"ssd_ms": ssd_times(torch)}), flush=True)
        return 0
    # f32 results are compared on the card: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SERVING_OVERRIDES
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    repro_torch.reset()
    from repro_torch.core import guard
    # the sentinel is off outside phase 10, whatever REPRO_PARITY says, so
    # that phases 1-9 measure the kernels and paths without the plain
    # versions beside them
    log(f"REPRO_PARITY={os.environ.get(guard.PARITY_ENV)!r}: sentinel "
        f"{guard.parity_mode()!r} at start, off until phase 10")
    guard.set_parity("off")
    card = card_info(torch)
    build_kernels()
    check_parity(torch)
    check_gmm_parity(torch)
    check_dense_parity(torch)
    check_gups_parity(torch)
    for arch in ("yi-6b", "granite-moe-1b-a400m"):
        check_engine_card_vs_cpu(torch, arch)
    bench_paged_rows(torch, card)
    for arch in ("yi-6b", "mamba2-130m"):
        check_dense_engine_card_vs_cpu(torch, arch)
    # yi-6b's weights, drawn once (seed 0, as the engine would draw them)
    # for the paged path, its profile and the dense path
    yi_cfg = get_config("yi-6b").replace(**SERVING_OVERRIDES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    yi_params = build_model(yi_cfg).init(gen, "cuda")
    cfg, stats, counts = serve_main_path(torch, "yi-6b", yi_params)
    timing = time_kernel(torch, cfg, stats)
    _, by_kernel, _ = profile_decode_rounds(torch, cfg, stats["round_width"],
                                            params=yi_params)
    log_decode_share("yi-6b paged decode round", by_kernel)
    profile_prefill_chunks(torch, cfg, yi_params)
    log(f"depths: solved {stats['solved_depth']}, round width "
        f"{stats['round_width']}")
    log(f"phases 1-7 done at {time.perf_counter() - t_start:.1f} s")

    # the dense engine: yi-6b on the same weights, then mamba2-130m
    _, _, dense_counts = serve_dense_path(torch, "yi-6b", yi_params)
    s = DENSE_SERVE["yi-6b"]["prompt_len"] + DENSE_SERVE["yi-6b"]["gen"]
    yi_k3 = (cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim, s, s - 16,
             cfg.n_layers)
    fd_timing = time_flash_decode(torch, 8, *yi_k3, sweep=True)
    fd_b1 = time_flash_decode(torch, 1, *yi_k3)
    _, by_kernel, _ = profile_dense_steps(torch, yi_cfg, yi_params)
    log_decode_share("yi-6b dense decode step", by_kernel)
    del yi_params
    gc.collect()
    torch.cuda.empty_cache()
    ssm_cfg = get_config("mamba2-130m").replace(**SERVING_OVERRIDES)
    gen.manual_seed(0)
    ssm_params = build_model(ssm_cfg).init(gen, "cuda")
    _, _, ssm_counts = serve_dense_path(torch, "mamba2-130m", ssm_params)
    ssd_timing = time_ssd_scan(torch, ssm_cfg, sweep=True)
    ssd_f32 = time_ssd_scan(torch, ssm_cfg, "float32")
    profile_dense_steps(torch, ssm_cfg, ssm_params)
    del ssm_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 5c-6c done at {time.perf_counter() - t_start:.1f} s")

    # the hybrid, enc-dec and VLM families, after the paths above so that
    # those run as they did before: their kernels' parity and card-vs-CPU
    # tokens, each at full width, then K3 at their shapes and serve_batched
    check_family_parity(torch)
    for arch in FAMILY_ARCHS:
        check_dense_engine_card_vs_cpu(torch, arch)
    family = {arch: serve_family(torch, arch) for arch in FAMILY_ARCHS}
    fd_family = {label: time_flash_decode(torch, *shape, label=label)
                 for label, shape in family_k3_shapes().items()}
    serve_batched_run(torch)
    log(f"phases 3d-6e done at {time.perf_counter() - t_start:.1f} s")

    # the MoE path: qwen3-moe at full width, after yi-6b is freed
    gc.collect()
    torch.cuda.empty_cache()
    moe_cfg = get_config(MOE_ARCH).replace(**SERVING_OVERRIDES)
    model = build_model(moe_cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    log(f"{MOE_ARCH}: {model.n_params()} parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    moe_cfg, moe_stats, moe_counts = serve_main_path(torch, MOE_ARCH, params)
    width = moe_stats["round_width"]
    gmm_times = time_gmm(torch, params, width)
    busy, by_kernel, wall_ms = profile_decode_rounds(torch, moe_cfg, width,
                                                     params=params)
    log_decode_share(f"{MOE_ARCH} paged decode round", by_kernel)
    log_gmm_share(f"{MOE_ARCH} decode round (B={width})", by_kernel, wall_ms)
    log(f"{MOE_ARCH} decode round: busy {busy:.1%}; floor "
        f"{round_floor_ms(moe_cfg, params):.3f} ms (weights read once over "
        f"3.35 TB/s)")
    _, by_kernel, wall_ms = profile_prefill_chunks(torch, moe_cfg, params)
    log_gmm_share(f"{MOE_ARCH} prefill chunk", by_kernel, wall_ms)
    w = params["layers"]["moe"]["w_gate"][0].clone()
    tokens = torch.randn(1, width, w.shape[1], generator=gen,
                         device="cuda").to(torch.bfloat16)
    gmm_case = (tokens.expand(w.shape[0], -1, -1), w,
                gmm_times["decode gate/up"]["bound_ms"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 5b-7b done at {time.perf_counter() - t_start:.1f} s")

    gups = gups_main_path(torch)
    gups_times = time_gups_kernels(torch, gups, gmm_case)
    check_gups_breakdown(torch, gups)
    gups_counts = gups["counts"]
    del gups, gmm_case
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 8-9 done at {time.perf_counter() - t_start:.1f} s")

    guard_phase(torch)
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
    trained = train_phase(torch)
    log(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{
        "name": "paged_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:163",
        "tpu": "kernels/decode_attention/decode_attention.py:paged_flash_decode",
        "launches": counts["paged_decode"],
        "launches_by_path": {"yi-6b": counts["paged_decode"],
                             MOE_ARCH: moe_counts["paged_decode"]},
        "parity": "ok",
        **{k: timing[k] for k in keys},
        "splits": timing["splits"],
        "shape": timing["shape"],
        "at_other_shapes": {"B=1": {k: timing["b1"][k] for k in
                                    keys + ("splits", "shape")}},
    }, {
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:63",
        "tpu": "kernels/decode_attention/decode_attention.py:flash_decode",
        "launches": dense_counts["flash_decode"],
        "launches_by_path": {"yi-6b": dense_counts["flash_decode"], **{
            arch: family[arch]["counts"]["flash_decode"]
            for arch in FAMILY_ARCHS}},
        "parity": "ok",
        **{k: fd_timing[k] for k in keys},
        "splits": fd_timing["splits"],
        "shape": fd_timing["shape"],
        "at_other_shapes": {"B=1": {k: fd_b1[k] for k in
                                    keys + ("splits", "shape")}, **{
            label: {k: t[k] for k in keys + ("splits", "shape")}
            for label, t in fd_family.items()}},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:60",
        "tpu": "kernels/ssd_scan/ssd_scan.py:ssd_scan",
        "launches": ssm_counts["ssd_scan"],
        "launches_by_path": {
            "mamba2-130m": ssm_counts["ssd_scan"],
            "hymba-1.5b": family["hymba-1.5b"]["counts"]["ssd_scan"], **{
                f"{arch} train": t["launches"]["ssd_scan"]
                for arch, t in trained["ssm"].items()}},
        "parity": "ok",
        **{k: ssd_timing[k] for k in keys},
        "launch_ms": ssd_timing["launch_ms"],
        "launch_bound_ms": ssd_timing["launch_bound_ms"],
        "shape": ssd_timing["shape"],
        "at_other_shapes": {name: {k: t[k] for k in keys + (
            "launch_ms", "launch_bound_ms", "shape")} for name, t in (
                ("float32", ssd_f32),
                ("hymba-1.5b prefill", family["hymba-1.5b"]["ssd"]))},
    }, {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:48",
        "tpu": "kernels/moe_gmm/moe_gmm.py:gmm",
        "launches": moe_counts["moe_gmm"],
        "launches_by_path": {
            MOE_ARCH: moe_counts["moe_gmm"],
            f"{TRAIN_ARCH} train": trained["launches"]["moe_gmm"]},
        "launches_a_train_step": trained["launches_a_step"]["moe_gmm"],
        "parity": "ok",
        **{k: gmm_times["decode gate/up"][k] for k in keys},
        "shape": gmm_times["decode gate/up"]["shape"],
        "at_other_shapes": {name: {k: t[k] for k in keys + ("shape",)}
                            for name, t in {**gmm_times,
                                            **trained["gmm_times"]}.items()
                            if name != "decode gate/up"},
    }, ssd_bwd_entry(trained)]
    for name, source, replaces in GUPS_KERNELS:
        t = gups_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": gups_counts[name],
            "parity": "ok",
            **{k: t[k] for k in keys},
            "shape": t["shape"],
            **{k: t[k] for k in ("wait_ab", "walk_ab", "guarded") if k in t},
        })
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"train": {k: v for k, v in trained.items()
                                if not k.endswith("_times")}}), flush=True)
    print(json.dumps({"substrate": guard.stats()}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
