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
     2e-3, then three steps through `jit_train_step` on each device (on
     the card the eager step and its capture, then two replays): the
     loss, learning rate and gradient norm of each step and the state
     within 2e-3, one capture, two replays, each launching the eager
     step's kernels; and the card's state through a checkpoint and back,
     bitwise; then the same for mamba2-130m and hymba-1.5b (a K4 forward
     and a K4 backward call a layer);
     (c) K4's backward kernel (`ssd_scan_bwd`, four launches a call, on
     tensor cores) against its plain version at mamba2's and hymba's full
     training shapes (b 8, s 512, chunk 256; x/B/C slices of one
     projection, dt f32), f32 (2e-3 + 2e-3 x |value|) and bf16 (3e-2 +
     3e-2 x |value|), depths 1, 2 and solved, dh_final None and given, one
     count a call, a second call at the solved depth bitwise the same;
     (d) granite-moe-1b-a400m (20 steps), mamba2-130m (20) and hymba-1.5b
     (10) trained at full width (f32 parameters, bf16 compute, batch 8 x
     seq 512, AdamW) through `train`, whose step is one CUDA graph
     (`train_step`): one capture and steps - 1 replays; every loss
     finite, the mean of the last 5 below the mean of the first 5,
     exactly the step's launches (216 K2; or 24 / 32 K4 forward and
     backward calls) and no other kernel, the eager step's and each
     replay's the same; the first step (eager step and capture) apart
     from the replays' p50, tokens a second, peak memory allocated and
     reserved, then a profile of replayed steps (device busy share; K2's
     share, or K4's forward and backward ms a step) and the guard's cost
     in the eager step before a capture; `memory_reserved` before and
     after each arch, which must drop back; (e) K2's times at the six
     products beside torch.bmm and the bound, and K4's backward's at the
     two SSM training shapes (by launch) beside its plain version and
     the bound; (f) for each of the three archs, from one init and the
     same three batches, three eager `make_train_step` steps against
     three `jit_train_step` steps (the eager step and two replays): the
     losses, gradient norms and every leaf of params, mu and nu within
     2e-3, the largest difference printed;
 12. serving on a device mesh, data 1 x model 2: two ranks (processes)
     that share the card through gloo (NCCL refuses two ranks on one
     device; gloo moves CUDA tensors through the host, so its walls are
     not a mesh of cards'): (a) K3 with its lse against its plain version
     at the per-shard shapes (yi-6b's and granite-moe's S 1056 split in
     two), bf16 and f32, a shard fully live, partly and empty (out 0, lse
     -inf), timed with and without the lse beside the bound, and K2 at
     the mesh's per-rank granite-moe shapes (16 local experts; the
     prefill's [16, 2560, 1024] capacity buffers, the decode's [1, 8,
     1024] at expert stride 0) beside its plain version, torch.bmm and
     the bound; (b) reduced f32 yi-6b and granite-moe served on the
     card's mesh give the tokens of the same mesh on CPU ranks; (c) yi-6b
     and granite-moe-1b-a400m served at full width on the card's mesh
     (bf16, serving layout, batch 8, 1024 + 32, strict): every request
     finishes, both ranks generate the same tokens and launch exactly K3
     once a layer a decode step and K2 three times a MoE layer a prefill
     or step (counts zeroed just before each serve), each rank holds half
     the experts' and the KV caches' single-card bytes, and for each rank
     the prefill seconds, per-step p50/p99, tok/s, peak memory and the
     collectives' calls, bytes and share of the decode steps;
 13. training on a device mesh, two gloo ranks sharing the card: (a)
     reduced f32 granite-moe (a capacity factor that drops tokens) and
     mamba2-130m, three `jit_train_step` steps on the card's (1, 2) mesh
     against the same steps on CPU ranks from the same draw: every step's
     loss, learning rate and gradient norm and every state leaf a rank
     holds within 2e-3, the launches exact; (b) granite-moe-1b-a400m at
     full width on (1, 2), each rank half the experts, and (c)
     mamba2-130m at full width on (2, 1), each rank 4 of the batch's 8
     rows, both through `train` with phase 11d's settings (f32 parameters
     and AdamW, bf16 compute, seq 512, lr 1e-2, the clip off) for 5 eager
     steps: the loss finite, falling and the same on every rank, each rank
     launching exactly `train_launches` a step (K2 12 times a MoE layer,
     or two K4 forward calls and a K4 backward call a layer, under remat;
     counts zeroed just before each run), and for each rank the first
     step apart from the p50, tokens a second, peak memory and the
     collectives' calls, bytes and share of the steps (timed sync to
     sync);
 14. the paged engine on a device mesh, two gloo ranks sharing the card
     at (1, 2), each running the whole engine in lockstep: (a) reduced
     f32 granite-moe (a capacity factor at which no token drops) and
     yi-6b through `serve_paged` on the card's mesh give the tokens of
     the same mesh on CPU ranks and of one card's engine; (b)
     granite-moe-1b-a400m at full width under phase 5's traffic (bf16,
     serving layout, strict): every request finishes, both ranks
     generate the same tokens, capture no graph and launch exactly K1
     once a layer a decode round and K2 three times a MoE layer a round
     and a prefill chunk, each rank holds half the experts and the whole
     KV pools of one card's engine, and for each rank TTFT, TBT, tok/s,
     prefix hits, forks and the collectives' calls, bytes and share of
     the rounds and of the chunks; (c) K2 on a chunk's capacity buffers
     and at a round's stride-0 shape over the 16 local experts, and K1
     at the round, each against its plain version and timed;
 15. the dry-run (`launch.dryrun`, on the CPU, no device): (a) every
     arch x shape on the 256-rank `single` and 512-rank `multi` meshes at
     full width under the h100 profile, traced on meta tensors in 8
     processes, a line a cell (status, dominant term, useful FLOPs ratio,
     argument and temp GiB a chip) and the count of ok, skipped and error
     cells (an error fails); (b) the dry-run of phase 5c's dense yi-6b
     decode step (B 8, a cache of 1056, one card, bf16) and of phase 11d's
     granite-moe train step (8 x 512, f32 state, remat on): its argument
     bytes equal, exactly, the bytes of the params, cache or state and
     batch the phase holds; its argument plus temp bytes beside the
     `max_memory_allocated` of one eager step there, and its roofline
     terms beside the phase's step p50 (printed, no gate);
 16. the placed serving step (weights and caches by their rules, attention
     and the MLP tensor-parallel over `model`, each layer gathered over
     `data`; `launch.serve.serve_placed`: `runtime.steps.jit_prefill_step`
     and `jit_decode_step`), two gloo ranks sharing the card: (a) reduced
     f32 yi-6b, granite-moe, mamba2-130m and hymba-1.5b on (1, 2) and
     (2, 1), card ranks == CPU ranks, each card rank launching exactly K3
     once an attention layer a step, K2 three times a MoE layer a step
     and in the prefill, K4 once an SSM layer in the prefill; (b) yi-6b at
     full width on (1, 2) (f32 weights, bf16 compute, phase 12's traffic
     and prompts): each rank holds 12,122,603,520 bytes of weights; on
     the seed-0 draw with `wq` and `wk` scaled to a fan-in of d_model
     (`soften_attention`: the plain draw's attention is near one-hot, and
     its logits chaotic over 32 layers), at all 32 layers on the first 4
     of its prompts: in f32 the placed prefill's and first step's logits
     within 2e-3 of the held layout's, tokens equal; in bf16 compute the
     placed prefill's and first step's logits no farther from their f32
     logits than twice the held layout's bf16 serving run's (phase 12's
     weights, prompts and mesh, rerun first on the same ranks), a bound
     that must itself lie under a tenth of the largest f32 logit; the
     first tokens' agreement printed; and per rank the peak memory,
     decode p50/p99, the collectives a step by kind (calls, bytes,
     seconds) and the launches;
     (c) granite-moe-1b-a400m at full width on (1, 2), K2 on each rank;
 17. `guard.stats()` on one JSON line, the mesh's record on one, the mesh
     training's on one, the paged mesh's on one, the placed step's on one,
     one JSON line describing
     every kernel (nine: K4's backward has its own entry; K1's, K2's,
     K3's and K4's launches by path, the meshes' among them, and K2's
     times at the training products and the meshes' shapes, K1's at the
     paged mesh's round, and K3's at the new families' shapes and with
     its lse at the mesh's shard shapes, among them), then the result
     line.

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

builds the kernels and runs only phase 11 (training, (a) to (f)), then
prints its record as one JSON line.

    python3 chip_smoke.py --ssd-time

likewise times only the SSD scan (K4) at phase 6c's shape in bf16 and f32
(each checked against its plain version) and prints one JSON line.

    python3 chip_smoke.py --k3-time

builds only K1's and K3's source and times K3 (without its lse) at phase
6c's dense yi-6b shape, B 8 and B 1, for the package of the checkout the
script sits in (copy it into another checkout to compare), and prints one
JSON line.

    python3 chip_smoke.py --mesh

builds the kernels and runs only phase 12 (serving on the (1, 2) mesh,
two gloo ranks sharing the card), then prints its record as one JSON line.

    python3 chip_smoke.py --mesh-train

builds the kernels and runs only phase 13 (training with the state placed
by its rules on the (1, 2) and (2, 1) meshes, two gloo ranks sharing the
card), then prints its record as one JSON line.

    python3 chip_smoke.py --dryrun

runs only phase 15: (a), then (b) on yi-6b's bf16 weights and a
granite-moe f32 state drawn for it (building only the sources of K3 and
K2, which those steps launch), with the p50 of five eager steps in place
of the phases' step p50, and prints its record as one JSON line.

    python3 chip_smoke.py --placed

builds the kernels and runs only phase 16 (the placed serving step on
the (1, 2) and (2, 1) meshes, two gloo ranks sharing the card), then
prints its record as one JSON line.

    python3 chip_smoke.py --mesh-paged

builds the kernels and runs only phase 14 (the paged engine on the (1, 2)
mesh, two gloo ranks sharing the card), then prints its record as one
JSON line.

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
    3.35 TB/s, or the flops over 989 TFLOP/s (bf16) if larger: the
    kernel's own count (`decode_attention.paged_decode_cost`), which the
    dry-run reads too."""
    from repro_torch.kernels.decode_attention import decode_attention as da

    flops, nbytes = da.paged_decode_cost(len(lengths), h, kh, d, m,
                                         sum(lengths), 2)
    bytes_s, ops_s = nbytes / HBM_BW, flops / PEAK["bfloat16"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes, flops)


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


def paged_layers(torch, cfg, lengths, blk, m):
    """K1's operands at a decode round of `cfg` with `lengths`, one layer's
    bf16 pools a call (each `len(lengths) x m + 1` pages of `blk` rows,
    shuffled tables `m` wide), and SDPA's over the same K/V gathered (and
    masked) beforehand."""
    width = len(lengths)
    h, kh, d = cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
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
    return layers, gathered


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
    m = -(-(SERVE["prompt_len"] + SERVE["gen"]) // blk)
    layers, gathered = paged_layers(torch, cfg, lengths, blk, m)
    kh = cfg.kv_heads
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


def eager_guard_cost(torch, fresh_step, label, turns=3,
                     what="eager step plus capture") -> dict:
    """The guard's cost in the eager step a serving run makes before each
    capture (one a key): `fresh_step()`, a step at a new key (run eagerly,
    then captured; or, as `what` says, the eager step alone), on the host
    clock from an idle device to its work done, with the guard as it is
    ("checked") and with its checks of each
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
    log(f"guard eager cost {label}: {what} "
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
    2 E C dm f on the tensor cores (the kernel's own count,
    `moe_gmm.cost`, which the dry-run reads too)."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    flops, nbytes = mg.cost(e, c, dm, f, itemsize, shared)
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


def flash_decode_bound(b, h, kh, d, pos, dtype_name="bfloat16"):
    """(bound ms, bound_by, bytes, flops) of dense decode attention in
    `dtype_name`: the live K/V rows, q and the output, each element of the
    type's size, over 3.35 TB/s, or the flops over the type's peak
    (989 TFLOP/s bf16, 67 f32) if larger (the kernel's own count,
    `decode_attention.flash_decode_cost`, which the dry-run reads too)."""
    from repro_torch.kernels.decode_attention import decode_attention as da

    isz = 2 if dtype_name == "bfloat16" else 4
    flops, nbytes = da.flash_decode_cost(b, h, kh, d, pos + 1, isz)
    bytes_s, ops_s = nbytes / HBM_BW, flops / PEAK[dtype_name]
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
    # x in, y out, B, C, dt and A (f32), h_final out (f32); the reference
    # spec's flops: the kernel's own count, which the dry-run reads too
    flops, nbytes = ss.cost(b, s, nh, p, n, chunk, isz)
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


def _bound_ms(cost):
    """The bound of a GUPS-path kernel's (flops, bytes) `cost`, its own
    count (which the dry-run reads too), f32 operations outside the
    tensor cores."""
    flops, nbytes = cost
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
            bound=_bound_ms(cg.row_gather_cost(n, row_bytes)),
            shape={"table": list(table.shape), "n": n, "rows_per_tile": 8,
                   "dtype": "float32", "blocks_per_sm": k5a_blocks,
                   "slots_a_block": k5a_slots, "grid": k5a_grid}),
        "span_gather": dict(
            plain=lambda: cg.span_gather_plain(table, starts, plan.span),
            library=(torch.index_select, (table, 0, span_rows)),
            bound=_bound_ms(cg.span_gather_cost(t, plan.span, row_bytes)),
            shape={"table": list(table.shape), "spans": t, "span": plan.span,
                   "dtype": "float32"}),
        "scatter_add": dict(
            plain=lambda: sa.scatter_add_unique_plain(work, uniq, summed),
            library=(lambda i, v: work.index_add_(0, i, v),
                     (uniq.long(), summed)),
            bound=_bound_ms(sa.scatter_add_cost(u, d, table.element_size())),
            shape={"table": list(table.shape), "n": u, "rows_per_tile": 8,
                   "dtype": "float32", "blocks_per_sm": k6_blocks,
                   "slots_a_block": k6_slots, "grid": k6_grid}),
        "stream_triad": dict(
            plain=lambda: sc.triad_plain(b, c, s),
            library=(lambda x, y: torch.add(x, y, alpha=s), (b, c)),
            bound=_bound_ms(sc.triad_cost(nt, 4)),
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
# 12 times a layer: 3 forward and, for each, its d tokens and d weights,
# and the 3 forward again in the backward's recompute (remat).
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20


def train_launches(cfg) -> dict:
    """The kernels' launches of one train step of `cfg`: K2 9 times a MoE
    layer (3 forward, a d tokens and a d weights for each), or a K4
    forward and a K4 backward call a layer; under the reference's remat
    (``cfg.remat``) the backward recomputes each layer's forward first: K2's
    3 forward products again (kept under policy "dots"), K4's forward
    again."""
    again = int(cfg.remat)
    if cfg.moe:
        again *= cfg.remat_policy != "dots"
        return {"moe_gmm": (9 + 3 * again) * cfg.n_layers}
    return {"ssd_scan": (1 + again) * cfg.n_layers,
            "ssd_scan_bwd": cfg.n_layers}
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
# steps through the graph train step that phases 11b and 11f compare with
# eager steps: the eager step and its capture, then replays
GRAPH_STEPS = 3
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
    step's kernel launches (`train_launches`: granite-moe K2, 12 a layer
    under remat; mamba2 and hymba two K4 forward calls and a K4 backward
    call a layer) and none on the CPU;
    then `check_graph_steps_card_vs_cpu`; for granite-moe then the card's
    state through a checkpoint and back, bitwise, on the card."""
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
    want.update(train_launches(cfg))
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
    check_graph_steps_card_vs_cpu(torch, arch, model, params, opt, want)
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


def check_graph_steps_card_vs_cpu(torch, arch, model, params, opt,
                                  per_step) -> None:
    """Phase 11b: `GRAPH_STEPS` reduced f32 steps of `arch` through
    `jit_train_step` on the card (the eager step and its capture, then
    replays) and on the CPU (eager), from the same parameters and Markov
    batches: the loss, learning rate and gradient norm of every step and
    every state leaf at 2e-3; on the card one capture and steps - 1
    replays, the step's launches `per_step` recorded by the capture, the
    run's launches `per_step` a step; none on the CPU."""
    from repro_torch.core import step_graph, tree
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import init_state
    from repro_torch.runtime.steps import jit_train_step

    cfg = model.cfg
    task = MarkovTask(DataConfig(vocab=cfg.vocab, seq_len=32,
                                 global_batch=4))
    runs = {}
    for dev in ("cpu", "cuda"):
        # a copy on each device: the step updates the state in place
        state = init_state(tree.map_tree(
            lambda x: x.to(dev, copy=True), params))
        step = jit_train_step(model, opt)
        since = step_graph.stats()
        reset_launch_counts()
        metrics = []
        for i in range(GRAPH_STEPS):
            batch = {k: torch.as_tensor(v)
                     for k, v in task.batch_for_step(i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[dev] = (state, metrics, launch_counts(), graph_delta(since),
                     dict(step.graph.launches))
        del step
    state, metrics, counts, graphs, recorded = runs["cuda"]
    per_step = {k: v for k, v in per_step.items() if v}
    want_graphs = {"train_step": {"captures": 1, "replays": GRAPH_STEPS - 1}}
    if any(runs["cpu"][2].values()) or runs["cpu"][3] or \
            {k: v for k, v in counts.items() if v} != {
                k: GRAPH_STEPS * v for k, v in per_step.items()} or \
            recorded != per_step or {
                name: {k: g[k] for k in ("captures", "replays")}
                for name, g in graphs.items()} != want_graphs:
        raise AssertionError(
            f"graph steps {arch}: cpu launches {runs['cpu'][2]} graphs "
            f"{runs['cpu'][3]}; card launches {counts}, graphs {graphs}, a "
            f"replay's launches {recorded}; want none, and {per_step} a "
            f"step, {want_graphs}")
    worst = 0.0
    for i, (got, ref) in enumerate(zip(metrics, runs["cpu"][1])):
        for k in ("loss", "lr", "grad_norm"):
            worst = max(worst, _close_quiet(
                f"graph step {i} {arch} {k}", torch.tensor([got[k]]),
                torch.tensor([ref[k]]), 2e-3))
    for (path, a), b in zip(tree.paths(state), tree.leaves(runs["cpu"][0])):
        if a.dtype.is_floating_point:
            worst = max(worst, _close_quiet(
                f"graph steps {arch} state {'/'.join(path)}", a.cpu(), b,
                2e-3))
    if int(state["step"]) != GRAPH_STEPS:
        raise AssertionError(f"graph steps {arch}: step {state['step']}")
    log(f"train step graph {arch} reduced f32 card == cpu over "
        f"{GRAPH_STEPS} `jit_train_step` steps (eager step, capture, "
        f"{GRAPH_STEPS - 1} replays): losses "
        f"{json.dumps([round(m['loss'], 6) for m in metrics])} / "
        f"{json.dumps([round(m['loss'], 6) for m in runs['cpu'][1]])}, "
        f"lr, grad norm and every state leaf within 2e-3 (max abs err "
        f"{worst:.3e}); graphs {json.dumps(graphs)}, a replay's launches "
        f"{json.dumps(recorded)}")


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
    heads' tiles a block keeps in flight, clamped to shared memory),
    dh_final None (as in training); and at the solved depth under a weak
    decay with dh_final given (at the path's decay a 64-row chunk keeps
    under 1e-9 of its state, so the gradient carried back across chunks
    would not show); one count a call, and no forward launch; and a second
    call at the solved depth gives the same bits."""
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
                    label = (f"{dtype_name} depth={depth} (ran {ran}) "
                             f"{'weak decay, dh_final given' if with_dh else 'dh_final None'}")
                    for part, a, b in zip(("dx", "ddt", "dA", "dB", "dC"),
                                          got, want):
                        worst = max(worst, _close(
                            f"ssd_scan_bwd {arch} train shape {part} {label}",
                            a, b, TOL[dtype_name]))
                    if depth is None:
                        again = ss.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
                        torch.cuda.synchronize()
                        differ = [part for part, a, b in zip(
                            ("dx", "ddt", "dA", "dB", "dC"), got, again)
                            if not torch.equal(a, b)]
                        if differ:
                            raise AssertionError(
                                f"ssd_scan_bwd {arch} {label}: a second call "
                                f"differs in {differ}")
                        log(f"ssd_scan_bwd {arch} {label}: a second call "
                            f"gives the same bits")
                        del again
                    del got
                del args, dy, dh, want
                gc_collect(torch)
    return worst


def train_full_width(torch, arch: str = TRAIN_ARCH,
                     steps: int = TRAIN_STEPS) -> dict:
    """Phase 11d: `train` on `arch` at full width for `steps` steps, its
    step one CUDA graph: one capture and steps - 1 replays. Every loss
    finite and the mean of the last 5 below the mean of the first 5;
    exactly the step's kernel launches (granite-moe: 9 K2 a layer; mamba2
    and hymba: a K4 forward and a K4 backward call a layer) and nothing
    else launched. The first step (the eager step and the capture) apart
    from the replays' p50; peak memory allocated and reserved. Then a
    fresh state through a fresh `jit_train_step`: the eager step's and a
    replay's launches, both the step's, a profile of replayed steps
    (device busy share; K2's share, or K4's forward and backward ms a
    step), the memory reserved while the state and the graph live; then,
    the graph dropped, the guard's cost in the eager step the graph step
    runs before its capture (that function alone, checked against
    unchecked) and that step's peak memory. `memory_reserved` must drop
    back to what it was before the arch (the graph's pool is freed with
    its step)."""
    from repro_torch.configs import get_config
    from repro_torch.core import step_graph
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime.steps import jit_train_step
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
    reserved_before = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    since = step_graph.stats()
    rep = train(model, steps=steps, data_cfg=data, opt=opt, log_every=1,
                device="cuda")
    counts = launch_counts()
    graphs = graph_delta(since)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    losses = [rep.losses[i] for i in range(steps)]
    per_step = {k: 0 for k in counts}
    per_step.update(train_launches(cfg))
    want = {k: v * steps for k, v in per_step.items()}
    per_step = {k: v for k, v in per_step.items() if v}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    first_s = rep.step_s[0]
    p50 = statistics.median(rep.step_s[1:])
    step_ms = [s * 1e3 for s in rep.step_s]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"train {arch} full width ({model.n_params()} parameters, f32 "
        f"params, bf16 compute, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"{steps} steps, Markov task over {TRAIN_DATA_VOCAB} ids, lr "
        f"{TRAIN_LR:g}, clip {TRAIN_CLIP:g}): "
        f"losses {json.dumps([round(x, 4) for x in losses])}, mean of the "
        f"first 5 {first:.4f}, of the last 5 {last:.4f}"
        f" ({'fell' if last < first else 'did not fall'})")
    log(f"train {arch}: first step (eager step + capture) "
        f"{first_s * 1e3:.1f} ms; replayed step p50 {p50 * 1e3:.1f} ms "
        f"(steps {json.dumps([round(s, 1) for s in step_ms])} ms), "
        f"{tokens / p50:.0f} tokens/s, peak memory {peak_gb:.2f} GB "
        f"allocated, {peak_reserved_gb:.2f} GB reserved, graphs "
        f"{json.dumps(graphs)}, launches "
        f"{json.dumps({k: counts[k] for k in per_step})} "
        f"({json.dumps(per_step)} a step), wall {rep.wall_s:.1f} s")
    if counts != want:
        raise AssertionError(f"train {arch}: launches {counts}, want {want}")
    got_graphs = {name: (g["captures"], g["replays"])
                  for name, g in graphs.items()}
    if got_graphs != {"train_step": (1, steps - 1)}:
        raise AssertionError(f"train {arch}: graphs {graphs}, want one "
                             f"capture and {steps - 1} replays")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: losses {losses}")
    if not last < first:
        raise AssertionError(f"train {arch}: loss did not fall: {losses}")
    del rep
    gc_collect(torch)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = init_state(model.init(gen, "cuda"))
    batch = {k: torch.as_tensor(v)
             for k, v in MarkovTask(data).batch_for_step(0).items()}
    step = jit_train_step(model, opt)
    launched = []
    for _ in range(2):                  # the eager step and capture; a replay
        before = launch_counts()
        step(state, batch)
        after = launch_counts()
        launched.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    if launched != [per_step, per_step] or step.graph.launches != per_step:
        raise AssertionError(f"train {arch}: the eager step launched "
                             f"{launched[0]}, a replay {launched[1]} "
                             f"(recorded {step.graph.launches}), want "
                             f"{per_step}")
    log(f"train {arch}: the eager step and a replay each launch "
        f"{json.dumps(per_step)}, nothing else")
    busy, by_kernel, wall_ms = profile_steps(
        torch, lambda: step(state, batch), 2,
        f"{arch} replayed train step (B {TRAIN_BATCH} x {TRAIN_SEQ})",
        step_graph.stats())
    out = {"losses": losses, "loss_first5": first, "loss_last5": last,
           "first_step_ms": first_s * 1e3, "step_ms_p50": p50 * 1e3,
           "step_ms": step_ms, "tokens_per_s": tokens / p50,
           "peak_memory_gb": peak_gb,
           "peak_memory_reserved_gb": peak_reserved_gb, "graphs": graphs,
           "busy_share": busy, "launches": {k: counts[k] for k in per_step},
           "launches_a_step": per_step}
    if cfg.moe:
        log_gmm_share(f"{arch} replayed train step", by_kernel, wall_ms)
    else:
        device_ms = sum(by_kernel.values())
        for part, names in (("forward", K4_FWD_KERNELS),
                            ("backward", K4_BWD_KERNELS)):
            ms = sum(t for key, t in by_kernel.items()
                     if kernel_name(key) in names)
            out[f"k4_{part}_ms_a_step"] = ms
            log(f"{arch} replayed train step: K4 {part} {ms:.3f} ms of "
                f"{device_ms:.3f} ms device time ({ms / device_ms:.1%}), "
                f"{per_step['ssd_scan']} calls")
    out["memory_reserved_with_graph_gb"] = torch.cuda.memory_reserved() / 1e9
    log(f"train {arch}: {out['memory_reserved_with_graph_gb']:.2f} GB "
        f"reserved while the state and the step's graph live")
    eager_fn = step.graph.fn            # the function the graph captured
    del step                            # and its graph's pool
    gc_collect(torch)
    values = [batch[k].cuda() for k in sorted(batch)]
    torch.cuda.reset_peak_memory_stats()
    guard = eager_guard_cost(
        torch, lambda: eager_fn(state, *values),
        f"{arch} train step", turns=2,
        what="the eager step the graph step runs before its capture")
    out["guard_ms_eager_step"] = guard["guard_ms"]
    out["eager_step_peak_gb"] = [torch.cuda.max_memory_allocated() / 1e9,
                                 torch.cuda.max_memory_reserved() / 1e9]
    log(f"train {arch}: the eager step alone peaks at "
        f"{out['eager_step_peak_gb'][0]:.2f} GB allocated, "
        f"{out['eager_step_peak_gb'][1]:.2f} GB reserved")
    if arch == TRAIN_ARCH:              # phase 15 (b): this step's dry-run
        named = dict(zip(sorted(batch), values))
        out["dryrun"] = dryrun_tie(
            torch, f"{arch} train step (B {TRAIN_BATCH} x {TRAIN_SEQ}, f32 "
            f"state, remat {cfg.remat_policy})",
            lambda st, b: eager_fn(st, *(b[k] for k in sorted(b))),
            (state, named), lambda: eager_fn(state, *values), p50 * 1e3)
    del state, batch, values, eager_fn
    gc_collect(torch)
    out["memory_reserved_gb"] = log_reserved(torch, arch, reserved_before)
    return out


def log_reserved(torch, label, before) -> list:
    """Logs `memory_reserved` before and after a phase (the collector run
    and the cache emptied; `memory_allocated` after beside it) and fails
    if more than 64 MiB stayed reserved: a CUDA graph's pool that
    outlived its step (tens of GB at these widths) or a tensor kept."""
    after = torch.cuda.memory_reserved()
    log(f"memory_reserved {label}: {before / 1e9:.3f} GB before, "
        f"{after / 1e9:.3f} GB after "
        f"({torch.cuda.memory_allocated() / 1e9:.3f} GB allocated)")
    if after > before + 2 ** 26:
        raise AssertionError(f"{label}: {after - before} bytes stayed "
                             "reserved")
    return [before / 1e9, after / 1e9]


def graph_against_eager(torch, arch: str) -> dict:
    """Phase 11f: `arch` at full width (phase 11d's settings), from one
    init (seed 2, drawn again) and the same `GRAPH_STEPS` Markov batches:
    eager `make_train_step` steps against `jit_train_step` steps (the
    eager step and its capture, then replays). The losses, gradient norms
    and every leaf of params, mu and nu at 2e-3; the largest difference
    logged (no kernel of the port uses atomics, so 0 is expected of
    them)."""
    from repro_torch.configs import get_config
    from repro_torch.core import step_graph, tree
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime.steps import jit_train_step, make_train_step

    cfg = get_config(arch)
    model = build_model(cfg)
    task = MarkovTask(DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH))
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=2,
                      grad_clip=TRAIN_CLIP)
    batches = [{k: torch.as_tensor(v)
                for k, v in task.batch_for_step(i).items()}
               for i in range(GRAPH_STEPS)]

    def fresh_state():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        return init_state(model.init(gen, "cuda"))

    gc_collect(torch)
    reserved_before = torch.cuda.memory_reserved()
    state, eager = fresh_state(), make_train_step(model, opt)
    eager_metrics = []
    for b in batches:
        state, m = eager(state, {k: v.cuda() for k, v in b.items()})
        eager_metrics.append({k: float(v) for k, v in m.items()})
    want = tree.map_tree(lambda t: t.cpu(), state)
    del state, m
    gc_collect(torch)
    since = step_graph.stats()
    state, step = fresh_state(), jit_train_step(model, opt)
    graph_metrics = []
    for b in batches:
        state, m = step(state, b)
        graph_metrics.append({k: float(v) for k, v in m.items()})
    graphs = graph_delta(since)
    if {n: (g["captures"], g["replays"]) for n, g in graphs.items()} != \
            {"train_step": (1, GRAPH_STEPS - 1)}:
        raise AssertionError(f"graph against eager {arch}: graphs {graphs}")
    del step, m                         # the graph's pool, before comparing
    gc_collect(torch)
    worst = {}
    for i, (got, ref) in enumerate(zip(graph_metrics, eager_metrics)):
        for k in ("loss", "grad_norm"):
            worst[f"{k} {i}"] = _close_quiet(
                f"graph against eager {arch} step {i} {k}",
                torch.tensor([got[k]]), torch.tensor([ref[k]]), 2e-3)
    for part in ("params", "mu", "nu"):
        for (path, a), b in zip(tree.paths(state[part]),
                                tree.leaves(want[part])):
            worst[f"{part}/{'/'.join(path)}"] = _close_quiet(
                f"graph against eager {arch} {part}/{'/'.join(path)}", a,
                b.to(a.device), 2e-3)
    top = max(worst, key=worst.get)
    log(f"graph against eager {arch} full width, {GRAPH_STEPS} steps from "
        f"one init: losses {json.dumps([m['loss'] for m in graph_metrics])}"
        f" / {json.dumps([m['loss'] for m in eager_metrics])}, grad norms, "
        f"and all {len(worst) - 2 * GRAPH_STEPS} leaves of params, mu and "
        f"nu within 2e-3; largest difference {worst[top]:.3e} ({top}), "
        f"{sum(1 for v in worst.values() if v)} of {len(worst)} compared "
        f"values not bitwise equal; graphs {json.dumps(graphs)}")
    del state, want, a, b               # a: the last leaf, on the card
    gc_collect(torch)
    return {"max_abs_diff": worst[top], "at": top,
            "not_bitwise": [k for k, v in worst.items() if v],
            "memory_reserved_gb": log_reserved(
                torch, f"{arch} graph against eager", reserved_before)}


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
    type (the kernel's own count, `ssd_scan.bwd_cost`, which the dry-run
    reads too)."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    isz = 2 if dtype_name == "bfloat16" else 4
    flops, nbytes = ss.bwd_cost(b, s, nh, p, n, isz)
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
    from repro_torch.kernels import ring
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
            run = ss.bwd_plan(b, s, nh, p, n, 2 if dtype_name == "bfloat16"
                              else 4, depth, sms=ring.sm_count(
                                  args[0].device))
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
    """Phase 11: (a) K2's gradients, (b) reduced steps card == CPU, eager
    and through the graph step (granite-moe, mamba2, hymba), and a
    checkpoint round trip, (c) K4's gradients at the two SSM training
    shapes, (d) granite-moe, mamba2 and hymba trained at full width
    through graph replays, (e) K2's times at the training products and
    K4's backward's at the SSM training shapes, (f) the graph step against
    the eager step at full width."""
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
    run["graph_against_eager"] = {
        arch: graph_against_eager(torch, arch)
        for arch in (TRAIN_ARCH, *(a for a, _ in SSM_TRAIN))}
    return run


def ssd_bwd_entry(trained, mesh_paths=None) -> dict:
    """The kernels line's entry of K4's backward: launches (calls) in the
    mamba2-130m training run (and by path: each SSM family's, and
    `mesh_paths`, phase 13's ranks'), its device ms in a profiled step of
    each SSM family, its time at mamba2's training shape in bf16 (the
    path's type) and at the others beside it."""
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
        "launches_by_path": {**{
            f"{arch} train": t["launches"]["ssd_scan_bwd"]
            for arch, t in trained["ssm"].items()}, **(mesh_paths or {})},
        "launches_a_train_step": {
            arch: t["launches_a_step"]["ssd_scan_bwd"]
            for arch, t in trained["ssm"].items()},
        "ms_a_train_step": {arch: t["k4_backward_ms_a_step"]
                            for arch, t in trained["ssm"].items()},
        "parity": "ok",
        **{k: times[main_key][k] for k in keys},
        "launch_ms": times[main_key]["launch_ms"],
        "shape": times[main_key]["shape"],
        "at_other_shapes": {name: {k: t[k] for k in keys + (
            "launch_ms", "shape")} for name, t in times.items()
            if name != main_key},
    }


# ----------------------------------------------------------------- phase 12

# Serving on a device mesh: data 1 x model 2, two ranks (processes) that
# share the one card through gloo, which NCCL refuses. Each rank holds half
# the experts and half of every KV cache; gloo moves CUDA tensors through
# the host, so the mesh's walls are a two-rank, one-card gloo figure, not
# that of a mesh of cards.
MESH_SHAPE = (1, 2)
MESH_ARCHS = ("yi-6b", "granite-moe-1b-a400m")
MESH_SERVE = dict(batch=8, prompt_len=1024, gen=32)
MESH_REDUCED = dict(batch=4, prompt_len=16, gen=8)   # 24 cache rows: 2 x 12
MESH_TIMEOUT_S = 480.0
# K3 with its lse at the per-shard shapes of MESH_SERVE (S 1056 in two
# shards of 528): (label, B, H, KH, D, S_l); and the local positions of a
# shard fully live (shard 0 at pos 1040), partly (shard 1 at 1040) and
# empty (shard 1 at an early pos, 100)
MESH_K3_SHAPES = (("yi-6b shard", 8, 32, 4, 128, 528),
                  ("granite-moe shard", 8, 16, 8, 64, 528))
MESH_K3_POS = (("full", 1040), ("partly", 512), ("empty", -428))


def time_flash_decode_lse(torch) -> dict:
    """(a) K3 with its lse against its plain version at the mesh's
    per-shard shapes, bf16 and f32, a shard fully live, partly and empty
    (out 0, lse -inf), and its time with and without the lse (8 layers'
    caches a batch, as phase 6c), beside the bound; at each shape's partly
    live bf16 case also the plain version and SDPA (which gives no lse)
    over the live rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as da

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    out = {}
    for label, b, h, kh, d, s in MESH_K3_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            layers = [tuple(torch.randn(*shape, generator=gen, device="cuda")
                            .to(dt) for shape in ((b, h, d), (b, s, kh, d),
                                                  (b, s, kh, d)))
                      for _ in range(8)]
            for state, pos in MESH_K3_POS:
                dev_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
                args = [(*a, dev_pos) for a in layers]
                (o, lse), run = path_launch(da.flash_decode, *args[0],
                                            return_lse=True)
                want, want_lse = da.flash_decode_plain(*args[0],
                                                       return_lse=True)
                name = f"flash_decode with lse {label} {state} {dtype_name}"
                if state == "empty":
                    if o.any() or not bool((lse == float("-inf")).all()):
                        raise AssertionError(f"{name}: wanted out 0, lse "
                                             f"-inf")
                    err = 0.0
                    log(f"parity {name}: out 0, lse -inf ok")
                else:
                    err = _close(name, o, want, *DECODE_TOL[dtype_name])
                    _close(f"{name} (lse)", lse, want_lse,
                           *DECODE_TOL[dtype_name])
                if not torch.equal(o, da.flash_decode(*args[0])):
                    raise AssertionError(f"{name}: out differs without lse")
                with_lse = [(path_launch(da.flash_decode, *a,
                                         return_lse=True)[1],) for a in args]
                without = [(path_launch(da.flash_decode, *a)[1],)
                           for a in args]
                t = {"ms": median_ms(torch, run_thunk, with_lse),
                     "ms_without_lse": median_ms(torch, run_thunk, without)}
                live = max(0, min(pos + 1, s))
                isz = 2 if dtype_name == "bfloat16" else 4
                bound_ms, bound_by, _, _ = flash_decode_bound(
                    b, h, kh, d, live - 1, dtype_name) if live else (
                        2 * b * h * d * isz / HBM_BW * 1e3, "bytes", 0, 0)
                t.update(max_abs_err=err, bound_ms=bound_ms,
                         bound_by=bound_by, plain_ms=None, library_ms=None)
                if state == "partly" and dtype_name == "bfloat16":
                    t["plain_ms"] = median_ms(
                        torch, lambda *a: da.flash_decode_plain(
                            *a, return_lse=True), args)
                    sliced = [(q[:, :, None], k[:, :live].transpose(1, 2),
                               v[:, :live].transpose(1, 2))
                              for q, k, v in layers]
                    t["library_ms"] = median_ms(
                        torch, lambda q, k, v: F.scaled_dot_product_attention(
                            q, k, v, enable_gqa=True), sliced)
                t["shape"] = {"B": b, "H": h, "KH": kh, "D": d, "S": s,
                              "pos": pos, "dtype": dtype_name}
                log(f"times {name} {json.dumps(t['shape'])}: with lse "
                    f"{t['ms']:.6f} ms, without {t['ms_without_lse']:.6f} ms"
                    f", plain {t['plain_ms']}, sdpa {t['library_ms']}, bound "
                    f"{bound_ms:.7f} ms ({bound_by})")
                out[f"{label} {state} {dtype_name}"] = t
                del with_lse, without, run, o, lse
    return out


def time_gmm_mesh(torch) -> dict:
    """K2 at the mesh's per-rank granite-moe shapes (16 local experts of
    32): the prefill's capacity buffers [16, n C = 2560, dm] (4096 local
    tokens, C 1280) and the decode's [1, 8, dm] at expert stride 0, gate/up
    and down: the kernel against its plain version, and its time beside
    the plain version's, torch.bmm's and the bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    cfg = get_config("granite-moe-1b-a400m")
    tokens = MESH_SERVE["batch"] * MESH_SERVE["prompt_len"] // MESH_SHAPE[1]
    c = moe_mod._capacity(tokens, cfg)
    return time_gmm_rank(torch, cfg, MESH_SHAPE[1], "mesh", (
        ("prefill", MESH_SHAPE[1] * c, False),
        ("decode", MESH_SERVE["batch"], True)))


def time_gmm_rank(torch, cfg, n_model: int, tag: str, cases) -> dict:
    """K2 at a mesh rank's shapes of `cfg` (its E / `n_model` experts),
    gate/up and down for each (phase, token rows, shared) of `cases`: a
    prefill's capacity buffers [E_l, rows, dm], a decode's [1, rows, dm]
    at expert stride 0. The kernel against its plain version in bf16, and
    its time beside the plain version's, torch.bmm's and the bound; keyed
    "`tag` phase proj"."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.models import moe as moe_mod

    e_l = cfg.n_experts // n_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    out = {}
    for phase, rows, shared in cases:
        for proj, dm, f in (("gate/up", cfg.d_model, cfg.d_ff_expert),
                            ("down", cfg.d_ff_expert, cfg.d_model)):
            args = [gmm_operands(torch, gen, e_l, rows, dm, f,
                                 shared and proj == "gate/up",
                                 torch.bfloat16) for _ in range(2)]
            got, run = path_launch(mg.gmm, *args[0])
            err = _close(f"moe_gmm {tag} {phase} {proj}", got,
                         mg.gmm_plain(*args[0]), TOL["bfloat16"],
                         TOL["bfloat16"])
            launches = [(run,), (path_launch(mg.gmm, *args[1])[1],)]
            kernel_a = median_ms(torch, run_thunk, launches)
            plain_ms = median_ms(torch, mg.gmm_plain, args)
            library_ms = median_ms(torch, torch.bmm, args)
            kernel_b = median_ms(torch, run_thunk, launches)
            bound_ms, bound_by = gmm_bound(e_l, rows, dm, f,
                                           shared=shared and proj == "gate/up")
            # where the reference's FFN would reach its Pallas kernel: its
            # token block as it passes it ([1, T, d] in decode), its weights
            meta = lambda *shape: torch.empty(shape, device="meta")  # noqa
            xs = meta(e_l, rows, cfg.d_model) if phase == "prefill" else \
                meta(1, rows, cfg.d_model)
            wg = meta(e_l, cfg.d_model, cfg.d_ff_expert)
            shape = {"E": e_l, "C": rows, "dm": dm, "f": f,
                     "shared": shared and proj == "gate/up",
                     "dtype": "bfloat16",
                     "reference_gmm": moe_mod._gmm_eligible(
                         xs, wg, wg, meta(e_l, cfg.d_ff_expert,
                                          cfg.d_model))}
            log(f"times moe_gmm {tag} {phase} {proj} {json.dumps(shape)}: "
                f"kernel {kernel_a:.4f}/{kernel_b:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.bmm {library_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({bound_by})")
            out[f"{tag} {phase} {proj}"] = {
                "max_abs_err": err, "ms": statistics.median([kernel_a,
                                                             kernel_b]),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape}
            del args, got, run, launches
    return out


def mesh_rank(ctx, reduced_only: bool = False) -> dict:
    """One rank of phase 12 (spawned; `ctx` its running mesh): reduced f32
    yi-6b and granite-moe, then (unless `reduced_only`) each at full width
    in the serving layout under strict mode, every `serve` with the launch
    counts zeroed just before it and read just after."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    def to_device(tree):
        return {k: (to_device(v) if isinstance(v, dict) else
                    v.to(ctx.device)) for k, v in tree.items()}

    out = {}
    for arch in MESH_ARCHS:
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 param_dtype="float32")
        # drawn on the CPU (a CUDA generator draws other numbers), this
        # rank's shard moved to its device: the same weights on both meshes
        gen = torch.Generator()
        gen.manual_seed(0)
        params = to_device(build_model(cfg, ctx).init(gen, "cpu"))
        reset_launch_counts()
        stats = serve(cfg, ctx=ctx, device=ctx.device.type, params=params,
                      **MESH_REDUCED)
        out[f"{arch} reduced"] = {"stats": stats, "counts": launch_counts()}
    if reduced_only:
        return out
    for arch in MESH_ARCHS:
        reset_launch_counts()
        stats = serve(get_config(arch), ctx=ctx, device="cuda",
                      layout="serving", strict=True, **MESH_SERVE)
        out[arch] = {"stats": stats, "counts": launch_counts()}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_full_bytes(arch: str) -> dict:
    """What one card serving MESH_SERVE holds of `arch`'s experts and KV
    caches (bf16), from its config."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    s = MESH_SERVE["prompt_len"] + MESH_SERVE["gen"]
    kv = 2 * cfg.n_layers * MESH_SERVE["batch"] * s * cfg.kv_heads \
        * cfg.resolved_head_dim * 2
    experts = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model \
        * cfg.d_ff_expert * 2 if cfg.moe else 0
    return {"experts": experts, "kv_cache": kv}


def mesh_launches(cfg, kw: dict) -> dict:
    """Each rank's launches of one mesh `serve`: K3 once a layer a decode
    step, K2 three times a MoE layer in the prefill and in each step."""
    want = {"flash_decode": cfg.n_layers * (kw["gen"] - 1)}
    if cfg.moe:
        want["moe_gmm"] = 3 * cfg.n_layers * kw["gen"]
    return want


def check_mesh_run(arch: str, ranks, kw: dict, *, full: bool) -> None:
    """Every request finished, every rank generated the same tokens, each
    rank launched what `mesh_launches` wants and nothing else, and at full
    width holds half the experts' and the KV caches' single-card bytes."""
    from repro_torch.configs import get_config

    cfg = get_config(arch) if full else get_config(arch).reduced()
    want = {name: 0 for name in ranks[0]["counts"]}
    want.update(mesh_launches(cfg, kw))
    for r, run in enumerate(ranks):
        st = run["stats"]
        if tuple(st["generated_shape"]) != (kw["batch"], kw["gen"]) or \
                st["generated"] != ranks[0]["stats"]["generated"]:
            raise AssertionError(f"mesh {arch} rank {r}: generated "
                                 f"{st['generated_shape']}, or tokens that "
                                 f"differ from rank 0's")
        if run["counts"] != want:
            raise AssertionError(f"mesh {arch} rank {r}: launches "
                                 f"{run['counts']}, want {want}")
        if full:
            single = mesh_full_bytes(arch)
            for key, whole in single.items():
                if st["held_bytes"][key] * MESH_SHAPE[1] != whole:
                    raise AssertionError(
                        f"mesh {arch} rank {r}: holds {st['held_bytes'][key]}"
                        f" B of {key}, one card {whole}")


def mesh_phase(torch) -> dict:
    """Phase 12: (a) K3 with its lse, and K2, at the mesh's per-shard
    shapes; (b) reduced f32 yi-6b and granite-moe served on the card's
    (1, 2) mesh give the tokens of the same mesh on CPU ranks; (c) yi-6b
    and granite-moe-1b-a400m served at full width on the card's mesh
    (bf16, serving layout, batch 8, 1024 + 32): every request finishes,
    each rank holds half the experts and half the KV caches, and for each
    rank the prefill seconds, per-step p50/p99, tok/s, peak memory and the
    collectives' share of the decode steps."""
    import functools
    import gc

    from repro_torch.launch.mesh import spawn

    lse = time_flash_decode_lse(torch)
    gmm = time_gmm_mesh(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card = spawn(mesh_rank, MESH_SHAPE, device="cuda", backend="gloo",
                 timeout_s=MESH_TIMEOUT_S)
    t_card = time.perf_counter() - t0
    cpu = spawn(functools.partial(mesh_rank, reduced_only=True), MESH_SHAPE,
                device="cpu", backend="gloo", timeout_s=MESH_TIMEOUT_S)
    log(f"mesh {MESH_SHAPE}: gloo ranks on the card ran in {t_card:.1f} s, "
        f"on the CPU in {time.perf_counter() - t0 - t_card:.1f} s")
    runs = {}
    for arch in MESH_ARCHS:
        key = f"{arch} reduced"
        check_mesh_run(arch, [c[key] for c in card], MESH_REDUCED,
                       full=False)
        got = card[0][key]["stats"]["generated"]
        want = cpu[0][key]["stats"]["generated"]
        if got != want:
            raise AssertionError(f"mesh {key}: card tokens {got} != CPU "
                                 f"tokens {want}")
        log(f"mesh {key} f32 tokens card == cpu on {MESH_SHAPE}: {got[0]}")
    for arch in MESH_ARCHS:
        ranks = [c[arch] for c in card]
        check_mesh_run(arch, ranks, MESH_SERVE, full=True)
        per_rank = []
        for r, run in enumerate(ranks):
            st = run["stats"]
            coll = st["collectives"]
            shown = {k: st[k] for k in (
                "prefill_s", "decode_s", "p50_ms", "p99_ms",
                "decode_tok_per_s", "max_memory_allocated_gb",
                "decode_captures", "held_bytes", "kv_len")}
            shown["collectives"] = dict(coll, share_of_decode=coll["s"] / max(
                st["decode_s"], 1e-9))
            shown["launches"] = {k: v for k, v in run["counts"].items() if v}
            shown["substrate"] = {k: st["substrate"][k] for k in (
                "strict", "guarded_calls", "backoffs", "numerics_faults")}
            per_rank.append(shown)
            log(f"serve mesh {arch} full width {json.dumps(MESH_SERVE)} rank "
                f"{r} of {MESH_SHAPE} (gloo, one card): {json.dumps(shown)}")
        log(f"mesh {arch}: each rank holds {per_rank[0]['held_bytes']} of "
            f"one card's {mesh_full_bytes(arch)} (experts, KV caches)")
        runs[arch] = {"ranks": per_rank, "mesh": ranks[0]["stats"]["mesh"],
                      "sample_tokens": ranks[0]["stats"]["sample_tokens"]}
    return {"flash_decode_lse": lse, "gmm": gmm, "serve": runs,
            "launches": {arch: [c[arch]["counts"] for c in card]
                         for arch in MESH_ARCHS}}


# ----------------------------------------------------------------- phase 13

# Training on a device mesh: two ranks (processes) that share the one card
# through gloo, as phase 12 serves. Each rank holds its block of params, mu
# and nu placed by their rules (`state_shardings`) and the step computes on
# those blocks: each layer's leaves gathered over `data` inside its remat
# (and again in the recompute), attention, the MLP, the logits and the
# loss tensor-parallel over `model`, the gather's backward reduce-scattering
# each gradient into its block; no rank holds the whole parameters.
# granite-moe-1b-a400m on (1, 2): each rank a half of every leaf the rules
# split over `model` (experts, vocab, heads) and the whole batch, its
# heads' attention, its vocabulary's logits, its S / 2 positions of each
# MoE layer through the all_to_all and K2; granite-moe-1b-a400m on (2, 1):
# each rank half of every leaf (split over `data` by its `embed` axis),
# gathered a layer at a time, and its 4 of the batch's 8 rows, all 32
# experts through K2; mamba2-130m on (2, 1): half of every leaf, its 4
# rows, K4 and K4b a layer (the SSM's ``d_inner`` split is gathered before
# the layer, so K4's shapes are a rank's rows of the whole heads). The
# settings are phase 11d's (f32 parameters and AdamW, bf16 compute, seq
# 512, the Markov task over 512 ids, lr 1e-2, the clip off), three eager
# steps a run (gloo cannot be captured): the first apart, the p50 of two.
# The reduced f32 check runs both archs on (1, 2) and (2, 1), on the card
# and on CPU ranks, from the same draw, and a compressed granite step on
# (1, 2).
MESH_TRAIN = (("granite-moe-1b-a400m", (1, 2), 3),
              ("granite-moe-1b-a400m", (2, 1), 3),
              ("mamba2-130m", (2, 1), 3))
MESH_TRAIN_BATCH = 8
MESH_TRAIN_REDUCED = dict(archs=("granite-moe-1b-a400m", "mamba2-130m"),
                          shapes=((1, 2), (2, 1)), compress_shape=(1, 2),
                          batch=4, seq=32, steps=3, capacity_factor=0.5)
MESH_TRAIN_TIMEOUT_S = 600.0


def _mesh_tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def mesh_train_launches(cfg, steps: int) -> dict:
    """A rank's launches of `steps` train steps (`train_launches`)."""
    return {k: v * steps for k, v in train_launches(cfg).items()}


def mesh_train_shares(cfg, shape) -> dict:
    """Bytes of params (and so of mu and of nu) a rank of `shape` holds by
    the placed specs, and the whole's, from meta tensors (no memory)."""
    from repro_torch.core import tree
    from repro_torch.models import build_model
    from repro_torch.sharding import Mesh, ShardingCtx, block_shape

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), tuple(shape)))
    model = build_model(cfg, ctx)
    leaves = tree.leaves(model.abstract_params())
    specs = tree.leaves(model.param_partition_specs())
    share = sum(math.prod(block_shape(x.shape, sp, ctx)) * x.element_size()
                for x, sp in zip(leaves, specs))
    return {"share": share,
            "whole": sum(x.numel() * x.element_size() for x in leaves)}


def check_mesh_train_kernels(torch) -> dict:
    """The kernels of (b) and (c) at the shapes a rank gives them, against
    their plain versions on the card, in bf16 (the path's compute type):
    K2's gate/up and down products with their d tokens and d weights on a
    rank's capacity buffers of granite-moe on each of its meshes
    ([E / model, model C, d] from its B S / (data model) tokens), through
    `gmm_grads` against the plain version's autograd; K4 and K4b at a
    (2, 1) rank's batch of mamba2 (b B / 2, s 512, dh_final None, as in
    training). Each call's launches are counted; each max_abs_err is
    logged and returned."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.models import moe as moe_mod

    def moved(before):
        after = launch_counts()
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    tol = TOL["bfloat16"]
    out = {}
    for moe_arch, moe_shape, _ in MESH_TRAIN:
        cfg = get_config(moe_arch)
        if not cfg.moe:
            continue
        n = moe_shape[1]
        e_l = cfg.n_experts // n
        tokens_a_rank = MESH_TRAIN_BATCH * TRAIN_SEQ // moe_shape[0]
        rows = n * moe_mod._capacity(tokens_a_rank // n, cfg)
        for proj, dm, f in (("gate/up", cfg.d_model, cfg.d_ff_expert),
                            ("down", cfg.d_ff_expert, cfg.d_model)):
            tokens = torch.randn(e_l, rows, dm, generator=gen,
                                 device="cuda").bfloat16()
            w = (torch.randn(e_l, dm, f, generator=gen, device="cuda")
                 * dm ** -0.5).bfloat16()
            up = (torch.randn(e_l, rows, f, generator=gen, device="cuda")
                  * rows ** -0.5).bfloat16()
            want = gmm_grads(torch, tokens, w, up, "plain")
            before = launch_counts()
            got = gmm_grads(torch, tokens, w, up, "kernel")
            torch.cuda.synchronize()
            if moved(before) != {"moe_gmm": 3}:
                raise AssertionError(f"moe_gmm mesh train {proj}: launches "
                                     f"{moved(before)}, not 3")
            for part, a, b in zip(("out", "d tokens", "d weights"), got,
                                  want):
                out[f"moe_gmm {_mesh_tag(moe_shape)} {proj} {part}"] = \
                    _close(f"moe_gmm mesh train {moe_arch} {moe_shape} rank "
                           f"{proj} {part} [{e_l},{rows},{dm}]x[{dm},{f}] "
                           "bfloat16", a, b, tol)
            del tokens, w, up, want, got
    ssm_arch, ssm_shape, _ = MESH_TRAIN[-1]
    b = MESH_TRAIN_BATCH // ssm_shape[0]
    _, s, nh, p, nn, chunk = ssd_train_shape(ssm_arch)
    args = ssd_operands(torch, gen, b, s, nh, p, nn, dtype=torch.bfloat16)
    dy = torch.randn(b, s, nh, p, generator=gen,
                     device="cuda").bfloat16()
    tag = (f"{ssm_arch} {ssm_shape} rank [b={b},s={s},nh={nh},p={p},n={nn}]"
           f" chunk={chunk} x/B/C bfloat16 dt float32")
    ry, rh = ss.ssd_scan_plain(*args, chunk=chunk)
    before = launch_counts()
    y, h = ss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    if moved(before) != {"ssd_scan": 1}:
        raise AssertionError(f"ssd_scan mesh train: launches "
                             f"{moved(before)}, not one call")
    out["ssd_scan y"] = _close(f"ssd_scan mesh train {tag} y", y, ry, tol)
    out["ssd_scan h_final"] = _close(f"ssd_scan mesh train {tag} h_final",
                                     h, rh, TOL["float32"])
    want = ss.ssd_scan_bwd_plain(*args, dy, None, chunk=chunk)
    before = launch_counts()
    got = ss.ssd_scan_bwd(*args, dy, None, chunk=chunk)
    torch.cuda.synchronize()
    if moved(before) != {"ssd_scan_bwd": 1}:
        raise AssertionError(f"ssd_scan_bwd mesh train: launches "
                             f"{moved(before)}, not one call")
    for part, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        out[f"ssd_scan_bwd {part}"] = _close(
            f"ssd_scan_bwd mesh train {tag} {part} dh_final None", a, w, tol)
    del args, dy, y, h, ry, rh, got, want
    gc_collect(torch)
    return out


def mesh_train_reduced(ctx) -> dict:
    """(a) on one rank: each arch of MESH_TRAIN_REDUCED reduced in f32
    (granite-moe at a capacity factor that drops tokens), drawn whole on
    the CPU from seed 0 and placed by the rules (`Model.place`) on its
    device, three `jit_train_step` steps on its rows of the Markov
    batches: each step's metrics, the rank's blocks of the state after
    them (on the CPU) and the launches; on the compressed mesh, granite
    again with `compress=True` (the error state placed with the
    parameters)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.compression import init_error_state
    from repro_torch.runtime.steps import jit_train_step, local_batch

    # a new process: f32 compared with the CPU, so no TF32 here either
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = MESH_TRAIN_REDUCED
    runs = [(arch, False) for arch in kw["archs"]]
    if tuple(ctx.mesh.shape) == kw["compress_shape"]:
        runs.append((kw["archs"][0], True))
    out = {}
    for arch, compress in runs:
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 param_dtype="float32")
        if cfg.moe:
            cfg = cfg.replace(capacity_factor=kw["capacity_factor"])
        model = build_model(cfg, ctx)
        gen = torch.Generator()
        gen.manual_seed(0)
        state = init_state(tree.map_tree(lambda x: x.to(ctx.device),
                                         model.place(build_model(cfg).init(
                                             gen, "cpu"))))
        if compress:
            state["grad_error"] = init_error_state(state["params"])
        step = jit_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=kw["steps"]),
                              compress=compress)
        task = MarkovTask(DataConfig(vocab=cfg.vocab, seq_len=kw["seq"],
                                     global_batch=kw["batch"]))
        metrics = []
        reset_launch_counts()
        for i in range(kw["steps"]):
            batch = {k: torch.as_tensor(v)
                     for k, v in task.batch_for_step(i).items()}
            state, m = step(state, local_batch(ctx, batch))
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"{arch} compressed" if compress else arch] = {
            "metrics": metrics, "counts": launch_counts(),
            "state": {"/".join(path): x.cpu() for path, x in
                      tree.paths(state)}}
    return out


def mesh_train_full(ctx, arch: str, steps: int) -> dict:
    """(b), (c) on one rank: `train` on `arch` at full width on the mesh,
    `steps` steps, the launch counts zeroed just before it and read just
    after, the collectives timed sync to sync."""
    import torch

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import train

    cfg = get_config(arch)
    model = build_model(cfg, ctx)
    data = DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=TRAIN_SEQ,
                      global_batch=MESH_TRAIN_BATCH)
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=steps, warmup_steps=2,
                      grad_clip=TRAIN_CLIP)
    torch.cuda.reset_peak_memory_stats(ctx.device)
    sharding.reset_collective_stats(timed=True)
    reset_launch_counts()
    rep = train(model, steps=steps, data_cfg=data, opt=opt, log_every=1)
    counts = launch_counts()
    coll = sharding.collective_stats()
    sharding.reset_collective_stats()
    return {"losses": [rep.losses[i] for i in range(steps)],
            "step_s": rep.step_s, "wall_s": rep.wall_s, "counts": counts,
            "collectives": coll, "held_bytes": rep.held_bytes,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated(ctx.device) / 1e9,
            "max_memory_reserved_gb":
                torch.cuda.max_memory_reserved(ctx.device) / 1e9}


def mesh_train_rank(ctx, arch=None, steps: int = 0,
                    reduced: bool = True) -> dict:
    """One rank of phase 13: (a) when `reduced`, then `arch` (if given) at
    full width for `steps` steps."""
    out = {"coordinate": list(ctx.mesh.coordinate)}
    if reduced:
        out["reduced"] = mesh_train_reduced(ctx)
    if arch is not None:
        out["full"] = mesh_train_full(ctx, arch, steps)
    return out


def _error_flips(name, got, want) -> int:
    """The error state of a compressed step, card against CPU: an element
    more than 2e-3 apart is a rounding flip (g + e on two sides of a
    rounding boundary: the two errors one quantization step of the leaf
    apart, that step at least twice the largest error, within 2e-3), and
    at most 1% of a leaf's elements flip. Returns the flips."""
    diff = (got.float() - want.float()).abs()
    flips = diff > 2e-3
    step = 2 * float(want.abs().max())
    if bool(flips.any()) and (float(diff[flips].max()) > step + 2e-3
                              or int(flips.sum()) > 0.01 * diff.numel()):
        raise AssertionError(
            f"{name}: {int(flips.sum())} of {diff.numel()} elements off by "
            f"up to {float(diff.max()):.3e} (a flip is one step, <= "
            f"{step:.3e})")
    return int(flips.sum())


def check_mesh_train_reduced(torch, card, cpu, shape) -> float:
    """(a): the card's ranks against the CPU's, rank by rank: every step's
    loss, learning rate and gradient norm and every leaf of the blocks a
    rank holds within 2e-3 (a compressed run's error state up to rounding
    flips, `_error_flips`), the card's launches exactly the steps' and
    none on the CPU."""
    from repro_torch.configs import get_config

    overall = 0.0
    for key in card[0]["reduced"]:
        arch = key.split()[0]
        worst, flips = 0.0, 0
        cfg = get_config(arch).reduced()
        want = mesh_train_launches(cfg, MESH_TRAIN_REDUCED["steps"])
        for r, (c, h) in enumerate(zip(card, cpu)):
            got, ref = c["reduced"][key], h["reduced"][key]
            counts = {k: v for k, v in got["counts"].items() if v}
            if counts != want or any(ref["counts"].values()):
                raise AssertionError(
                    f"mesh train {key} reduced {shape} rank {r}: launches "
                    f"card {counts}, cpu {ref['counts']}, want {want} and "
                    "none")
            for i, (a, b) in enumerate(zip(got["metrics"], ref["metrics"])):
                for m in ("loss", "lr", "grad_norm"):
                    worst = max(worst, _close_quiet(
                        f"mesh train {key} {shape} rank {r} step {i} {m}",
                        torch.tensor([a[m]]), torch.tensor([b[m]]), 2e-3))
            for name, x in got["state"].items():
                if name.startswith("grad_error/"):
                    flips += _error_flips(f"mesh train {key} {shape} rank "
                                          f"{r} {name}", x, ref["state"][name])
                elif x.dtype.is_floating_point:
                    worst = max(worst, _close_quiet(
                        f"mesh train {key} {shape} rank {r} {name}", x,
                        ref["state"][name], 2e-3))
        log(f"mesh train {key} reduced f32 placed on {shape}: card ranks == "
            f"cpu ranks over {MESH_TRAIN_REDUCED['steps']} steps (losses "
            f"{[round(m['loss'], 6) for m in got['metrics']]}, grad norms "
            f"{[round(m['grad_norm'], 4) for m in got['metrics']]}), every "
            f"block of params, mu, nu within 2e-3 (max abs err {worst:.3e})"
            + (f", the error state up to {flips} rounding flips"
               if key.endswith("compressed") else "")
            + f", launches {json.dumps(want)} a rank")
        overall = max(overall, worst)
    return overall


def check_mesh_train_full(arch: str, shape, steps: int, ranks) -> dict:
    """(b), (c): every loss finite and the last below the first, the same
    on every rank; each rank launched exactly `mesh_train_launches` and
    nothing else, and holds exactly the placed specs' share of params, mu
    and nu; each rank's bytes held, step p50 (the first step apart),
    tokens a second, peak memory, the collectives' calls, bytes and share
    of the steps."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    want = mesh_train_launches(cfg, steps)
    shares = mesh_train_shares(cfg, shape)
    tokens = MESH_TRAIN_BATCH * TRAIN_SEQ
    per_rank = []
    for r, run in enumerate(ranks):
        full = run["full"]
        losses = full["losses"]
        counts = {k: v for k, v in full["counts"].items() if v}
        if counts != want:
            raise AssertionError(f"mesh train {arch} {shape} rank {r}: "
                                 f"launches {full['counts']}, want {want}")
        held = full["held_bytes"]
        if held != {k: shares["share"] for k in ("params", "mu", "nu")}:
            raise AssertionError(f"mesh train {arch} {shape} rank {r}: "
                                 f"holds {held}, the specs' share is "
                                 f"{shares['share']} a part")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"mesh train {arch} {shape} rank {r}: "
                                 f"losses {losses} (finite and falling "
                                 "wanted)")
        if losses != ranks[0]["full"]["losses"]:
            raise AssertionError(f"mesh train {arch} {shape}: rank {r} "
                                 f"logged {losses}, rank 0 "
                                 f"{ranks[0]['full']['losses']}")
        p50 = statistics.median(full["step_s"][1:])
        coll = full["collectives"]
        shown = {
            "coordinate": run["coordinate"],
            "held_gb": {k: v / 1e9 for k, v in held.items()},
            "whole_state_gb": 3 * shares["whole"] / 1e9,
            "held_state_gb": sum(held.values()) / 1e9,
            "specs_share_gb_a_part": shares["share"] / 1e9,
            "first_step_ms": full["step_s"][0] * 1e3,
            "step_ms_p50": p50 * 1e3,
            "step_ms": [x * 1e3 for x in full["step_s"]],
            "tokens_per_s": tokens / p50,
            "max_memory_allocated_gb": full["max_memory_allocated_gb"],
            "max_memory_reserved_gb": full["max_memory_reserved_gb"],
            "collectives": dict(coll, share_of_steps=coll["s"] / max(
                sum(full["step_s"]), 1e-9), calls_a_step=coll["calls"] /
                steps, gb_a_step=coll["bytes"] / steps / 1e9),
            "launches_a_step": {k: v // steps for k, v in counts.items()},
            "losses": losses}
        per_rank.append(shown)
        log(f"mesh train {arch} full width placed on {shape} (two gloo "
            f"ranks on one card; f32 params, bf16 compute, batch "
            f"{MESH_TRAIN_BATCH} x seq {TRAIN_SEQ}, {steps} eager steps, lr "
            f"{TRAIN_LR:g}, clip {TRAIN_CLIP:g}) rank {r}: "
            f"{json.dumps(shown)}")
    log(f"mesh train {arch} {shape}: each rank holds "
        f"{shares['share'] / 1e9:.3f} GB of params of "
        f"{shares['whole'] / 1e9:.3f} (and as much of mu and of nu), loss "
        f"{per_rank[0]['losses'][0]:.4f} -> {per_rank[0]['losses'][-1]:.4f} "
        f"(fell), {json.dumps(per_rank[0]['launches_a_step'])} a step on "
        "each rank")
    return {"ranks": per_rank, "shape": list(shape), "steps": steps,
            "launches": [run["full"]["counts"] for run in ranks]}


def mesh_train_phase(torch) -> dict:
    """Phase 13: K2, K4 and K4b against their plain versions at the shapes
    a rank of (b) and (c) gives them (`check_mesh_train_kernels`); (a)
    reduced f32 granite-moe and mamba2 steps, placed, on the card's (1, 2)
    and (2, 1) gloo meshes against the same steps on CPU ranks, and a
    compressed granite step on (1, 2); (b) granite-moe-1b-a400m at full
    width on (1, 2) and (2, 1); (c) mamba2-130m at full width on (2, 1);
    each run's launches, losses, bytes held and per-rank figures."""
    import functools
    import gc

    from repro_torch.launch.mesh import spawn

    gc.collect()
    torch.cuda.empty_cache()
    kernel_errs = check_mesh_train_kernels(torch)
    runs = {}
    t0 = time.perf_counter()
    left = [tuple(s) for s in MESH_TRAIN_REDUCED["shapes"]]
    for arch, shape, steps in MESH_TRAIN:
        t = time.perf_counter()
        reduced = shape in left
        if reduced:
            left.remove(shape)
        runs[(arch, shape)] = spawn(
            functools.partial(mesh_train_rank, arch=arch, steps=steps,
                              reduced=reduced), shape, device="cuda",
            backend="gloo", timeout_s=MESH_TRAIN_TIMEOUT_S)
        log(f"mesh train {arch} on {shape}: gloo ranks on the card ran in "
            f"{time.perf_counter() - t:.1f} s")
    out = {"kernels_at_rank_shapes_max_abs_err": kernel_errs,
           "reduced_max_abs_err": {}}
    for shape in MESH_TRAIN_REDUCED["shapes"]:
        t = time.perf_counter()
        cpu = spawn(mesh_train_rank, shape, device="cpu", backend="gloo",
                    timeout_s=MESH_TRAIN_TIMEOUT_S)
        log(f"mesh train reduced on CPU ranks {shape}: "
            f"{time.perf_counter() - t:.1f} s")
        card = next(r for (_, s), r in runs.items() if s == tuple(shape)
                    and "reduced" in r[0])
        out["reduced_max_abs_err"][_mesh_tag(shape)] = \
            check_mesh_train_reduced(torch, card, cpu, shape)
    log(f"phase 13 {time.perf_counter() - t0:.1f} s")
    for arch, shape, steps in MESH_TRAIN:
        out[f"{arch} {_mesh_tag(shape)}"] = check_mesh_train_full(
            arch, shape, steps, runs[(arch, shape)])
    return out


# ----------------------------------------------------------------- phase 14

# The paged engine on a device mesh: data 1 x model 2, two gloo ranks that
# share the card, as phase 12. Each rank runs the whole engine (pager,
# prefix cache, scheduler) in lockstep with the other, holds half of
# granite-moe's experts and the whole KV pools, and runs its rounds
# (`moe_ep_replicated`) and prefill chunks (`moe_ep_a2a`) eagerly: gloo's
# collectives cannot be captured.
MESH_PAGED_SHAPE = (1, 2)
MESH_PAGED_ARCH = "granite-moe-1b-a400m"
MESH_PAGED_REDUCED_ARCHS = ("granite-moe-1b-a400m", "yi-6b")
MESH_PAGED_REDUCED = dict(batch=4, prompt_len=40, gen=8, block_size=16)
MESH_PAGED_TIMEOUT_S = 300.0


def mesh_paged_reduced_cfg(arch: str):
    """Reduced f32 `arch`; a MoE arch at a capacity factor of E / top_k,
    at which an expert's buffer holds every token of a shard, so that no
    token drops and the mesh's tokens can be held against one card's."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             param_dtype="float32")
    if cfg.moe:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def mesh_paged_params(torch, cfg, ctx, device):
    """`cfg`'s weights drawn on the CPU from seed 0 (a CUDA generator
    draws other numbers), whole or this rank's shard of them, on
    `device`."""
    from repro_torch.core import tree
    from repro_torch.models import build_model

    gen = torch.Generator()
    gen.manual_seed(0)
    return tree.map_tree(lambda x: x.to(device),
                         build_model(cfg, ctx).init(gen, "cpu"))


def mesh_paged_rank(ctx, full: bool = True) -> dict:
    """One rank of phase 14 (spawned; `ctx` its running mesh): reduced f32
    granite-moe and yi-6b through `serve_paged`, then (with `full`)
    granite-moe-1b-a400m at full width in the serving layout under strict
    mode with phase 5's traffic, every run with the launch counts zeroed
    just before it and read just after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import guard
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SERVING_OVERRIDES, serve_paged

    out = {}
    for arch in MESH_PAGED_REDUCED_ARCHS:
        cfg = mesh_paged_reduced_cfg(arch)
        params = mesh_paged_params(torch, cfg, ctx, ctx.device)
        reset_launch_counts()
        stats = serve_paged(cfg, ctx=ctx, device=ctx.device.type,
                            params=params, **MESH_PAGED_REDUCED)
        out[f"{arch} reduced"] = {"stats": stats, "counts": launch_counts()}
    if full:
        cfg = get_config(MESH_PAGED_ARCH).replace(**SERVING_OVERRIDES)
        guard.set_strict(True)
        reset_launch_counts()
        try:
            stats = serve_paged(cfg, ctx=ctx, device="cuda", **SERVE)
            substrate = guard.stats()
        finally:
            guard.set_strict(False)
        out[MESH_PAGED_ARCH] = {"stats": stats, "counts": launch_counts(),
                                "substrate": substrate}
    return out


def mesh_paged_launches(cfg, stats) -> dict:
    """A rank's launches of one paged run: K1 once a layer a decode round,
    K2 three times a MoE layer a round and a prefill chunk."""
    want = {"paged_decode": cfg.n_layers * stats["decode_rounds"]}
    if cfg.moe:
        want["moe_gmm"] = 3 * cfg.n_layers * (stats["decode_rounds"]
                                              + stats["prefill_chunks"])
    return want


def check_mesh_paged_run(label: str, cfg, ranks, batch: int, *,
                         on_card: bool) -> None:
    """Every request finished on every rank, every rank generated the same
    tokens and ran no CUDA graph, and each launched what
    `mesh_paged_launches` wants on the card (nothing on the CPU)."""
    for r, run in enumerate(ranks):
        st = run["stats"]
        want = {name: 0 for name in run["counts"]}
        if on_card:
            want.update(mesh_paged_launches(cfg, st))
        if st["completed"] != batch or \
                any(x != "finished" for x in st["states"]):
            raise AssertionError(f"mesh paged {label} rank {r}: states "
                                 f"{st['states']}")
        if st["generated"] != ranks[0]["stats"]["generated"]:
            raise AssertionError(f"mesh paged {label} rank {r}: tokens "
                                 f"differ from rank 0's")
        if (st["decode_captures"], st["prefill_captures"]) != (0, 0):
            raise AssertionError(f"mesh paged {label} rank {r}: captured "
                                 f"a graph on a mesh")
        if run["counts"] != want:
            raise AssertionError(f"mesh paged {label} rank {r}: launches "
                                 f"{run['counts']}, want {want}")


def mesh_paged_single_bytes(cfg, stats) -> dict:
    """What one card's paged engine holds of `cfg` at the run's pool: its
    parameters, the experts among them, and the KV pools (every page and
    the garbage page, K and V, every layer)."""
    from repro_torch.models import build_model
    from repro_torch.models.params import torch_dtype
    from repro_torch.serve.engine import tensor_bytes

    params = build_model(cfg).abstract_params()
    moe = params["layers"].get("moe", {})
    pool = 2 * cfg.n_layers * (stats["num_blocks"] + 1) \
        * stats["block_size"] * cfg.kv_heads * cfg.resolved_head_dim \
        * torch_dtype(cfg.dtype).itemsize
    return {"params": tensor_bytes(params),
            "experts": sum(tensor_bytes(moe.get(k))
                           for k in ("w_gate", "w_up", "w_down")),
            "kv_pools": pool}


def check_mesh_paged_kernels(torch, cfg, stats) -> dict:
    """(c) K2 and K1 at the shapes a rank gives them in (b), bf16, each
    against its plain version, and their times: K2 on a 32-token chunk's
    capacity buffers [E / 2, 2 C, dm] (each rank's 16 positions, C from
    them) and on a decode round's [1, W, dm] at expert stride 0 over the
    E / 2 local experts; K1 at the round (W = the round width, every
    layer's pools whole, phase 6's mid-generation lengths)."""
    from repro_torch.models import moe as moe_mod

    n = MESH_PAGED_SHAPE[1]
    width = stats["round_width"]
    c = moe_mod._capacity(32 // n, cfg)
    gmm = time_gmm_rank(torch, cfg, n, "mesh paged", (
        ("prefill", n * c, False), ("decode", width, True)))
    blk = SERVE["block_size"]
    lens = sorted(stats["prompt_lens"])[-width:]
    lengths = [x + SERVE["gen"] // 2 for x in lens]
    m = -(-(SERVE["prompt_len"] + SERVE["gen"]) // blk)
    layers, gathered = paged_layers(torch, cfg, lengths, blk, m)
    k1 = time_paged(torch, layers, gathered, lengths, stats["solved_depth"])
    del layers, gathered
    return {"gmm": gmm, "paged_decode": k1}


def mesh_paged_phase(torch) -> dict:
    """Phase 14: (a) reduced f32 granite-moe and yi-6b through the paged
    engine on the card's (1, 2) mesh give the tokens of the same mesh on
    CPU ranks and of one card's engine; (b) granite-moe-1b-a400m at full
    width on the card's mesh under phase 5's traffic: every request
    finishes, each rank holds half the experts and the whole pools, and
    for each rank TTFT, TBT, tok/s, prefix hits, forks, bytes held, the
    collectives' share of the rounds and chunks, and K1's and K2's
    launches a round and a chunk; (c) K1 and K2 at a rank's shapes."""
    import functools
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import SERVING_OVERRIDES, serve_paged
    from repro_torch.sharding import NULL_CTX

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = spawn(mesh_paged_rank, MESH_PAGED_SHAPE, device="cuda",
                 backend="gloo", timeout_s=MESH_PAGED_TIMEOUT_S)
    t_card = time.perf_counter() - t0
    cpu = spawn(functools.partial(mesh_paged_rank, full=False),
                MESH_PAGED_SHAPE, device="cpu", backend="gloo",
                timeout_s=MESH_PAGED_TIMEOUT_S)
    log(f"mesh paged {MESH_PAGED_SHAPE}: gloo ranks on the card ran in "
        f"{t_card:.1f} s, on the CPU in "
        f"{time.perf_counter() - t0 - t_card:.1f} s")
    out = {"reduced": {}}
    for arch in MESH_PAGED_REDUCED_ARCHS:
        key = f"{arch} reduced"
        cfg = mesh_paged_reduced_cfg(arch)
        check_mesh_paged_run(key, cfg, [c[key] for c in card],
                             MESH_PAGED_REDUCED["batch"], on_card=True)
        check_mesh_paged_run(key, cfg, [c[key] for c in cpu],
                             MESH_PAGED_REDUCED["batch"], on_card=False)
        single = serve_paged(cfg, device="cuda", params=mesh_paged_params(
            torch, cfg, NULL_CTX, "cuda"), **MESH_PAGED_REDUCED)
        got = card[0][key]["stats"]["generated"]
        for name, want in (("CPU ranks", cpu[0][key]["stats"]["generated"]),
                           ("one card", single["generated"])):
            if got != want:
                raise AssertionError(f"mesh paged {key}: card ranks' tokens "
                                     f"{got} != {name}' {want}")
        out["reduced"][arch] = {"tokens": got[0],
                                "launches": card[0][key]["counts"]}
        log(f"mesh paged {key} f32 tokens: card ranks == CPU ranks == one "
            f"card on {MESH_PAGED_SHAPE}: {got[0]}; a card rank's launches "
            f"{ {k: v for k, v in card[0][key]['counts'].items() if v} }")

    cfg = get_config(MESH_PAGED_ARCH).replace(**SERVING_OVERRIDES)
    ranks = [c[MESH_PAGED_ARCH] for c in card]
    check_mesh_paged_run(MESH_PAGED_ARCH, cfg, ranks, SERVE["batch"],
                         on_card=True)
    single = mesh_paged_single_bytes(cfg, ranks[0]["stats"])
    per_rank = []
    for r, run in enumerate(ranks):
        st = run["stats"]
        held = st["held_bytes"]
        if held["experts"] * MESH_PAGED_SHAPE[1] != single["experts"] or \
                held["kv_pools"] != single["kv_pools"] or \
                held["params"] - held["experts"] != \
                single["params"] - single["experts"]:
            raise AssertionError(f"mesh paged rank {r}: holds {held}, one "
                                 f"card {single}")
        sub = run["substrate"]
        if sub["backoffs"] or sub["parity_mismatches"]:
            raise AssertionError(f"mesh paged rank {r}: strict serving "
                                 f"degraded: {sub}")
        launches = {k: v for k, v in run["counts"].items() if v}
        shown = {k: st[k] for k in (
            "ttft_p50_ms", "ttft_p99_ms", "tbt_p50_ms", "tbt_p99_ms",
            "p50_ms", "p99_ms", "decode_tok_per_s", "prefill_s", "decode_s",
            "round_width", "decode_rounds", "prefill_chunks", "rounds",
            "prefix_hits", "cow_forks", "preemptions",
            "max_memory_allocated_gb", "decode_captures", "prefill_captures",
            "held_bytes", "collectives")}
        shown["one_card_bytes"] = single
        shown["launches"] = launches
        # `check_mesh_paged_run` held the totals to these rates exactly
        shown["launches_a_round"] = {"paged_decode": cfg.n_layers,
                                     "moe_gmm": 3 * cfg.n_layers}
        shown["launches_a_chunk"] = {"paged_decode": 0,
                                     "moe_gmm": 3 * cfg.n_layers}
        shown["substrate"] = {k: sub[k] for k in (
            "strict", "guarded_calls", "backoffs", "numerics_faults")}
        per_rank.append(shown)
        log(f"serve mesh paged {MESH_PAGED_ARCH} full width "
            f"{json.dumps(SERVE)} rank {r} of {MESH_PAGED_SHAPE} (gloo, one "
            f"card): {json.dumps(shown)}")
    out["serve"] = {"ranks": per_rank, "mesh": ranks[0]["stats"]["mesh"],
                    "sample_tokens": ranks[0]["stats"]["sample_tokens"]}
    out["launches"] = [run["counts"] for run in ranks]
    gc.collect()
    torch.cuda.empty_cache()
    out["kernels"] = check_mesh_paged_kernels(torch, cfg, ranks[0]["stats"])
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14 took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------- main

# ----------------------------------------------------------------- phase 16

# The placed serving step: the weights and the caches held by their rules
# (the reference's placed layout: `Model.param_shardings`,
# `Model.cache_shardings`), attention and the MLP tensor-parallel over
# `model`, each layer's leaves gathered over `data` (`models.lm`), through
# `runtime.steps.jit_prefill_step` and `jit_decode_step`
# (`launch.serve.serve_placed`), on two gloo ranks sharing the card as
# phase 12 serves. (a) reduced f32 archs on (1, 2) and (2, 1): K3, K2 and
# K4 on the placed path, card ranks == CPU ranks; (b) yi-6b at full width
# (f32 weights, bf16 compute) on (1, 2) with phase 12's traffic and
# prompts, against the held layout on the same softened draw; (c)
# granite-moe-1b-a400m at full width on (1, 2). Full-width (2, 1) is not
# run: it gathers every layer's weights over `data` through the host each
# token; (a) covers that mesh.
PLACED_REDUCED_ARCHS = ("yi-6b", "granite-moe-1b-a400m", "mamba2-130m",
                        "hymba-1.5b")
PLACED_SHAPES = ((1, 2), (2, 1))
PLACED_REDUCED = dict(batch=4, prompt_len=16, gen=5)
PLACED_FULL_SHAPE = (1, 2)
PLACED_YI_BYTES = 12_122_603_520        # yi-6b's f32 weights, half a rank
# (b)'s bf16 bound must lie under this share of the largest f32 logit: a
# bound as large as the logits themselves would pass zeros
PLACED_BOUND_SHARE = 0.1
# (b)'s parity prefills take the first rows of phase 12's prompts: a row's
# logits are its own, and the four prefills through gloo cost half
PLACED_PARITY_ROWS = 4
PLACED_TIMEOUT_S = 480.0


def placed_launches(cfg, kw: dict) -> dict:
    """Each rank's launches of one `serve_placed`: the dense engine's
    (`dense_launches`) and K2 three times a MoE layer in the prefill and
    in each step."""
    want = dense_launches(cfg, kw["prompt_len"], kw["gen"])
    if cfg.moe:
        want["moe_gmm"] = 3 * cfg.n_layers * kw["gen"]
    return want


def soften_attention(params, cfg) -> None:
    """Scale `wq` and `wk` in place to a fan-in of d_model: the init draws
    them with the head count as their fan-in (the reference's, which the
    port keeps), so random weights give near one-hot attention whose
    logits part over 32 layers under a change of the order of summation
    or under bf16 rounding. A scalar a leaf: a rank's placed blocks stay
    the blocks of the softened whole."""
    attn = params["layers"]["attn"]
    attn["wq"].mul_((cfg.n_heads / cfg.d_model) ** 0.5)
    attn["wk"].mul_((cfg.kv_heads / cfg.d_model) ** 0.5)


def placed_rank(ctx, full: bool = True) -> dict:
    """One rank of phase 16 (spawned; `ctx` its running mesh): (a) the
    reduced f32 archs, each from one draw on the CPU (seed 0, this rank's
    placed blocks moved to its device); with `full`, (b) yi-6b at full
    width on the seed-0 draw softened (`soften_attention`), on the first
    `PLACED_PARITY_ROWS` of phase 12's prompts: the held layout's prefill
    and first step with phase 12's bf16 serving weights, then with f32
    weights in f32; then `serve_placed` on the placed f32 weights with
    phase 12's traffic, and on those weights the placed prefill and first
    step in f32 and in bf16 compute; and (c) granite-moe placed at full
    width; every `serve_placed` run with the launch counts zeroed just
    before it and read just after."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core import tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import (SERVING_OVERRIDES, make_prompts,
                                          serve_placed)
    from repro_torch.models import build_model
    from repro_torch.runtime.steps import (jit_decode_step,
                                           jit_prefill_step, local_batch)

    out = {}
    for arch in PLACED_REDUCED_ARCHS:
        cfg = get_config(arch).reduced().replace(dtype="float32",
                                                 param_dtype="float32")
        gen = torch.Generator()
        gen.manual_seed(0)
        params = tree.map_tree(lambda x: x.to(ctx.device), build_model(
            cfg, ctx).init(gen, "cpu", placed=True))
        reset_launch_counts()
        stats = serve_placed(cfg, ctx=ctx, device=ctx.device.type,
                             params=params, **PLACED_REDUCED)
        out[f"{arch} reduced"] = {"stats": stats, "counts": launch_counts()}
    if not full:
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (b) phase 12's prompts (their first rows), mesh and cache length, on
    # the softened draw
    gen = torch.Generator(device=ctx.device)
    base = get_config("yi-6b").replace(cache_update="row")
    prompts, text = make_prompts(base, MESH_SERVE["batch"],
                                 MESH_SERVE["prompt_len"],
                                 np.random.default_rng(0), ctx.device)
    prompts = {k: v[:PLACED_PARITY_ROWS]
               for k, v in local_batch(ctx, prompts).items()}
    pad = text + MESH_SERVE["gen"]
    suite = ShapeSuite("serve", pad, PLACED_PARITY_ROWS, "decode")

    def first_two(prefill, decode, params):
        """The prefill's last logits and the first step's, f32 on the CPU."""
        cache, logits = prefill(params, prompts)
        tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        step, _ = decode(params, cache, {"tokens": tokens})
        return logits[:, -1].float().cpu(), step[:, -1].float().cpu()

    f32 = dict(dtype="float32", param_dtype="float32")
    for tag, over in (("held bf16", SERVING_OVERRIDES), ("held f32", f32)):
        cfg = base.replace(**over)
        model = build_model(cfg, ctx)
        gen.manual_seed(0)
        params = model.init(gen, ctx.device)
        soften_attention(params, cfg)
        out[f"yi-6b {tag}"] = first_two(
            lambda p, b: model.prefill(p, b, pad_to=pad), model.decode_step,
            params)
        del params, model
        free()
    for arch, over in (("yi-6b", {"cache_update": "row"}),
                       ("granite-moe-1b-a400m", SERVING_OVERRIDES)):
        cfg = get_config(arch).replace(**over)
        gen.manual_seed(0)
        params = build_model(cfg, ctx).init(gen, ctx.device, placed=True)
        if arch == "yi-6b":
            soften_attention(params, cfg)
        reset_launch_counts()
        stats = serve_placed(cfg, ctx=ctx, params=params, **MESH_SERVE)
        out[arch] = {"stats": stats, "counts": launch_counts()}
        if arch == "yi-6b":
            for tag, c in (("placed f32", cfg.replace(**f32)),
                           ("placed bf16", cfg)):
                model = build_model(c, ctx)
                out[f"yi-6b {tag}"] = first_two(
                    jit_prefill_step(model, pad_to=pad),
                    jit_decode_step(model, suite), params)
        del params
        free()
    return out


def placed_against_held(r: int, run: dict) -> dict:
    """(b) for rank `r`, yi-6b at full width and all 32 layers on the
    softened draw. In f32: the placed prefill's and first step's logits
    within 2e-3 of the held layout's, their tokens equal. In bf16 compute:
    the placed run's distance from its f32 logits at most twice the held
    layout's bf16 serving run's from its own, and that bound under
    `PLACED_BOUND_SHARE` of the largest f32 logit (else it would pass
    logits that carry nothing). The first tokens' agreement printed."""
    import torch

    out = {}
    for i, what in enumerate(("prefill", "first step")):
        f32, held_f32 = run["yi-6b placed f32"][i], run["yi-6b held f32"][i]
        _close(f"placed yi-6b rank {r} f32 {what} against the held "
               f"layout's", f32, held_f32, TOL["float32"])
        if not torch.equal(f32.argmax(-1), held_f32.argmax(-1)):
            raise AssertionError(f"placed yi-6b rank {r}: f32 {what} tokens "
                                 f"differ from the held layout's")
        bf16, held = run["yi-6b placed bf16"][i], run["yi-6b held bf16"][i]
        d_held = float((held - held_f32).abs().max())
        d_placed = float((bf16 - f32).abs().max())
        top = float(f32.abs().max())
        key = what.replace(" ", "_")
        out[key] = {
            "max_abs_f32": top,
            "f32_placed_from_held": float((f32 - held_f32).abs().max()),
            "bf16_held_from_f32": d_held,
            "bf16_placed_from_f32": d_placed,
            "bf16_bound": 2 * d_held,
            "token_agreement": {
                "placed_bf16_held_bf16": float(
                    (bf16.argmax(-1) == held.argmax(-1)).float().mean()),
                "placed_bf16_f32": float(
                    (bf16.argmax(-1) == f32.argmax(-1)).float().mean())}}
        log(f"parity placed yi-6b rank {r} bf16 {what} logits: {d_placed:.4g} "
            f"from the f32 ones, the held layout's {d_held:.4g} (bound "
            f"{2 * d_held:.4g}, largest f32 logit {top:.4g}); "
            f"{json.dumps(out[key])}")
        if not 2 * d_held <= PLACED_BOUND_SHARE * top:
            raise AssertionError(f"placed yi-6b rank {r} {what}: the bf16 "
                                 f"bound {2 * d_held:.4g} is not under "
                                 f"{PLACED_BOUND_SHARE} of the largest f32 "
                                 f"logit {top:.4g}")
        if not d_placed <= 2 * d_held:
            raise AssertionError(f"placed yi-6b rank {r}: bf16 {what} logits "
                                 f"{d_placed:.4g} from the f32 ones, over "
                                 f"twice the held layout's {d_held:.4g}")
    return out


def check_placed_run(label: str, cfg, ranks, kw: dict, *,
                     on_card: bool) -> None:
    """Every rank generated the whole batch's tokens, the same on every
    rank, and launched what `placed_launches` wants on the card (nothing
    on the CPU)."""
    for r, run in enumerate(ranks):
        st = run["stats"]
        want = {name: 0 for name in run["counts"]}
        if on_card:
            want.update(placed_launches(cfg, kw))
        if tuple(st["generated_shape"]) != (kw["batch"], kw["gen"]) or \
                st["generated"] != ranks[0]["stats"]["generated"]:
            raise AssertionError(f"placed {label} rank {r}: generated "
                                 f"{st['generated_shape']}, or tokens that "
                                 f"differ from rank 0's")
        if run["counts"] != want:
            raise AssertionError(f"placed {label} rank {r}: launches "
                                 f"{run['counts']}, want {want}")


def placed_phase(torch) -> dict:
    """Phase 16: (a) the reduced f32 archs through the placed prefill and
    `jit_decode_step` on the card's (1, 2) and (2, 1) meshes give the
    tokens of the same meshes on CPU ranks, each card rank launching K3,
    K2 and K4 where its path runs them; (b) yi-6b at full width on the
    card's (1, 2) mesh: each rank holds 12,122,603,520 bytes of placed
    weights; at all 32 layers on the softened draw its f32 logits equal
    the held layout's within 2e-3 and its bf16 ones lie within the bf16
    bound of phase 12's held serving run (`placed_against_held`; its
    weights' layout, prompts and mesh, rerun here); and for each rank
    its peak memory, decode p50/p99, the collectives a step by kind
    (calls, bytes, seconds) and K3's launches; (c) granite-moe at full
    width on (1, 2), K2 on each rank."""
    import concurrent.futures
    import functools
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import SERVING_OVERRIDES

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reduced = functools.partial(placed_rank, full=False)
    # the full-width runs alone on the machine; the other meshes' card
    # ranks beside every CPU rank
    runs = {PLACED_FULL_SHAPE: spawn(
        placed_rank, PLACED_FULL_SHAPE, device="cuda", backend="gloo",
        timeout_s=PLACED_TIMEOUT_S)}
    log(f"placed {PLACED_FULL_SHAPE}: card ranks ran in "
        f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(PLACED_SHAPES)) as pool:
        cpus = {shape: pool.submit(spawn, reduced, shape, device="cpu",
                                   backend="gloo",
                                   timeout_s=PLACED_TIMEOUT_S)
                for shape in PLACED_SHAPES}
        for shape in PLACED_SHAPES:
            if shape not in runs:
                runs[shape] = spawn(reduced, shape, device="cuda",
                                    backend="gloo",
                                    timeout_s=PLACED_TIMEOUT_S)
        cpus = {shape: run.result() for shape, run in cpus.items()}
    log(f"placed: the other card ranks and the CPU ranks ran in "
        f"{time.perf_counter() - t1:.1f} s")
    for shape in PLACED_SHAPES:
        card, cpu = runs[shape], cpus[shape]
        for arch in PLACED_REDUCED_ARCHS:
            key = f"{arch} reduced"
            cfg = get_config(arch).reduced()
            check_placed_run(key, cfg, [c[key] for c in card],
                             PLACED_REDUCED, on_card=True)
            check_placed_run(key, cfg, [c[key] for c in cpu],
                             PLACED_REDUCED, on_card=False)
            got = card[0][key]["stats"]["generated"]
            want = cpu[0][key]["stats"]["generated"]
            if got != want:
                raise AssertionError(f"placed {key} on {shape}: card tokens "
                                     f"{got} != CPU tokens {want}")
            log(f"placed {key} f32 tokens card == cpu on {shape}: {got[0]}; "
                f"a card rank's launches "
                f"{ {k: v for k, v in card[0][key]['counts'].items() if v} }")
    card = runs[PLACED_FULL_SHAPE]
    out = {"reduced_launches": {
        f"{arch} {_mesh_tag(shape)} rank {r}": c[f"{arch} reduced"]["counts"]
        for shape, ranks in runs.items() for r, c in enumerate(ranks)
        for arch in PLACED_REDUCED_ARCHS}, "serve": {}}
    for arch, over in (("yi-6b", {"cache_update": "row"}),
                       ("granite-moe-1b-a400m", SERVING_OVERRIDES)):
        cfg = get_config(arch).replace(**over)
        ranks = [c[arch] for c in card]
        check_placed_run(arch, cfg, ranks, MESH_SERVE, on_card=True)
        per_rank = []
        for r, (run, c) in enumerate(zip(ranks, card)):
            st = run["stats"]
            shown = {k: st[k] for k in (
                "prefill_s", "decode_s", "p50_ms", "p99_ms",
                "decode_tok_per_s", "max_memory_allocated_gb",
                "held_bytes")}
            coll = st["collectives"]
            shown["collectives_a_step"] = {
                kind: {k: v / st["steps"] for k, v in by.items()}
                for kind, by in coll["by_kind"].items()}
            shown["collectives_share_of_decode"] = coll["s"] / max(
                st["decode_s"], 1e-9)
            shown["launches"] = {k: v for k, v in run["counts"].items() if v}
            if arch == "yi-6b":
                if st["held_bytes"]["params"] != PLACED_YI_BYTES:
                    raise AssertionError(
                        f"placed yi-6b rank {r}: holds "
                        f"{st['held_bytes']['params']} B of weights, want "
                        f"{PLACED_YI_BYTES}")
                shown["parity"] = placed_against_held(r, c)
            per_rank.append(shown)
            log(f"serve placed {arch} full width {json.dumps(MESH_SERVE)} "
                f"rank {r} of {PLACED_FULL_SHAPE} (gloo, one card): "
                f"{json.dumps(shown)}")
        out["serve"][arch] = {"ranks": per_rank,
                              "launches": [run["counts"] for run in ranks]}
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------- phase 15


def dryrun_sweep() -> dict:
    """Phase 15 (a): `launch.dryrun --arch all --shape all --mesh both` in
    a process of its own (8 cells traced at once, the h100 profile, no
    CUDA device visible: the dry-run allocates on none) into
    ``reports/dryrun``; a line a cell and the count of ok, skipped and
    error cells. An error cell, or a failed run, fails the phase."""
    import shutil

    out_dir = ROOT / "reports" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, REPRO_MACHINE="h100", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "all", "--mesh", "both", "--jobs", "8", "--out",
         str(out_dir)], env=env, capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    recs = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for r in recs:
        counts[r["status"]] += 1
        tag = f"dryrun {r['arch']} {r['shape']} {r['mesh']}: {r['status']}"
        if r["status"] == "ok":
            mem = r["memory"]
            log(f"{tag}, {r['dominant']}, useful "
                f"{r['useful_flops_ratio']:.4f}, args "
                f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f} GiB, temp "
                f"{mem['temp_size_in_bytes'] / 2 ** 30:.3f} GiB a chip, "
                f"traced {r['compile_s']} s")
        else:
            log(f"{tag} ({r.get('reason') or r.get('error')})")
    log(f"dryrun sweep: {json.dumps(counts)} of {len(recs)} cells in "
        f"{wall:.1f} s")
    if proc.returncode or counts["error"] or len(recs) != 80:
        raise AssertionError(f"dryrun sweep: rc {proc.returncode}, "
                             f"{counts}, {len(recs)} records; "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return {"counts": counts, "wall_s": wall}


def _nbytes(tensors) -> int:
    """The bytes of the distinct storages of `tensors`."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr() if t.device.type != "meta" else id(st)] = \
            st.nbytes()
    return sum(seen.values())


def dryrun_tie(torch, label, fn, args, run_eager, p50_ms) -> dict:
    """Phase 15 (b) for one step: the dry-run of `fn` on meta copies of
    the real `args` (a tuple of tensor trees) against the real ones: its
    argument bytes (what the step reads, as XLA counts a jitted step's)
    plus the bytes of the leaves it never reads (only ``positions`` may
    be one: the data pipeline's, which the model computes itself) must
    equal theirs exactly; its argument plus temp bytes are printed beside
    `max_memory_allocated` over `run_eager()` (one eager step on the real
    tensors), and its roofline terms (h100) beside the phase's step p50
    `p50_ms`."""
    from repro_torch import roofline
    from repro_torch.core.machine import machine_profile
    from repro_torch.launch.dryrun import trace_step

    leaves, metas = [], []

    def meta(x, name):
        if isinstance(x, dict):
            return {k: meta(v, k) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(meta(v, name) for v in x)
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            metas.append((name, torch.empty_like(x, device="meta")))
            return metas[-1][1]
        return x

    margs = meta(args, None)
    real = _nbytes(leaves)
    dry = trace_step(fn, margs)
    mem = dry["memory"]
    unread = sorted({name for name, t in metas
                     if not dry["counter"].read(t)}, key=str)
    if mem["argument_size_in_bytes"] + dry["counter"].unread_bytes != real \
            or set(unread) - {"positions"}:
        raise AssertionError(f"dryrun {label}: argument bytes "
                             f"{mem['argument_size_in_bytes']} read and "
                             f"{dry['counter'].unread_bytes} unread "
                             f"({unread}), the phase holds {real}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_eager()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    t = roofline.terms(dry["flops"], dry["bytes"], dry["collectives"],
                       machine=machine_profile("h100"))
    out = {"argument_bytes": real, "dry_memory": mem,
           "unread": unread, "unread_bytes": dry["counter"].unread_bytes,
           "dry_arg_plus_temp_gb": (mem["argument_size_in_bytes"]
                                    + mem["temp_size_in_bytes"]) / 1e9,
           "eager_peak_allocated_gb": peak / 1e9,
           "allocated_before_gb": base / 1e9,
           "eager_peak_above_before_gb": (peak - base) / 1e9,
           "flops": dry["flops"], "bytes": dry["bytes"],
           "kernels": {k: v["calls"] for k, v in dry["kernels"].items()},
           "terms_ms": {k: v * 1e3 for k, v in t.items()},
           "dominant": roofline.dominant(t), "step_p50_ms": p50_ms,
           "traced_s": dry["t_trace"]}
    log(f"dryrun {label}: argument bytes {mem['argument_size_in_bytes']}"
        f" read + {dry['counter'].unread_bytes} never read ({unread}) == "
        f"the phase's {real}; argument "
        f"+ temp {out['dry_arg_plus_temp_gb']:.3f} GB against "
        f"max_memory_allocated {out['eager_peak_allocated_gb']:.3f} GB over "
        f"one eager step ({out['allocated_before_gb']:.3f} GB before it); "
        f"terms {json.dumps({k: round(v, 4) for k, v in out['terms_ms'].items()})}"
        f" ms ({out['dominant']}, {dry['flops']:.4g} flop, "
        f"{dry['bytes']:.4g} B) against the step p50 {p50_ms:.3f} ms; "
        f"kernels {json.dumps(out['kernels'])}")
    return out


def dense_decode_tie(torch, cfg, params, p50_ms) -> dict:
    """Phase 15 (b), dense yi-6b: the decode step of phase 5c (B 8, a
    cache of prompt + gen = 1056 rows at pos 1040, one card, bf16) on
    `params`, a cache of zeros of those shapes and a batch of tokens."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core import tree
    from repro_torch.models import build_model

    kw = DENSE_SERVE[cfg.name]
    model = build_model(cfg)
    shape = ShapeSuite("dense", kw["prompt_len"] + kw["gen"], kw["batch"],
                       "decode")
    cache = tree.map_tree(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                                device="cuda"),
                          model.abstract_cache(shape))
    cache["pos"].fill_(kw["prompt_len"] + kw["gen"] // 2)
    batch = {"tokens": torch.zeros(kw["batch"], 1, dtype=torch.int32,
                                   device="cuda")}
    out = dryrun_tie(torch, f"dense {cfg.name} decode step (B "
                     f"{kw['batch']}, cache {shape.seq_len})",
                     model.decode_step, (params, cache, batch),
                     lambda: model.decode_step(params, cache, batch), p50_ms)
    del cache, batch
    return out


def dryrun_phase(torch) -> dict:
    """`--dryrun`: phase 15 alone. (a), then (b) on yi-6b's serving
    weights (bf16, seed 0) and a granite-moe f32 state (seed 1) drawn for
    it, each step's p50 over five eager steps after one."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.launch.serve import SERVING_OVERRIDES
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime.steps import make_train_step

    def p50_ms(fn):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core import tree
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    build.build([da.FLASH_SOURCE, mg.SOURCE])    # the two steps' kernels
    out = {"sweep": dryrun_sweep()}
    cfg = get_config("yi-6b").replace(**SERVING_OVERRIDES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = build_model(cfg).init(gen, "cuda")
    model = build_model(cfg)
    kw = DENSE_SERVE[cfg.name]
    tokens = {"tokens": torch.zeros(kw["batch"], 1, dtype=torch.int32,
                                    device="cuda")}
    cache = tree.map_tree(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                                device="cuda"),
                          model.abstract_cache(ShapeSuite(
                              "dense", kw["prompt_len"] + kw["gen"],
                              kw["batch"], "decode")))
    cache["pos"].fill_(kw["prompt_len"] + kw["gen"] // 2)
    ms = p50_ms(lambda: model.decode_step(params, cache, tokens))
    del cache, tokens
    out["dense yi-6b decode step"] = dense_decode_tie(torch, cfg, params, ms)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    gen.manual_seed(1)
    state = init_state(model.init(gen, "cuda"))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in MarkovTask(
        DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH)).batch_for_step(0).items()}
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR,
                                              grad_clip=TRAIN_CLIP))
    ms = p50_ms(lambda: step(state, batch))
    out[f"{TRAIN_ARCH} train step"] = dryrun_tie(
        torch, f"{TRAIN_ARCH} train step (B {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"f32 state, remat {cfg.remat_policy}; eager p50)", step,
        (state, batch), lambda: step(state, batch), ms)
    return out


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
    if sys.argv[1:] == ["--k3-time"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        card_info(torch)
        from repro_torch.core import guard
        from repro_torch.kernels import build
        from repro_torch.kernels.decode_attention import decode_attention as da
        build.build([da.FLASH_SOURCE])
        guard.set_parity("off")
        print(json.dumps({"k3": {
            f"B={b}": time_flash_decode(torch, b, 32, 4, 128, 1056, 1040, 32)
            for b in (8, 1)}}), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card_info(torch)
        build_kernels()
        from repro_torch.core import guard
        guard.set_parity("off")
        print(json.dumps({"mesh": mesh_phase(torch)}), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh-train"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card_info(torch)
        build_kernels()
        from repro_torch.core import guard
        guard.set_parity("off")
        print(json.dumps({"mesh_train": mesh_train_phase(torch)}), flush=True)
        return 0
    if sys.argv[1:] == ["--mesh-paged"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card_info(torch)
        build_kernels()
        from repro_torch.core import guard
        guard.set_parity("off")
        print(json.dumps({"mesh_paged": mesh_paged_phase(torch)}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--placed"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card_info(torch)
        build_kernels()
        from repro_torch.core import guard
        guard.set_parity("off")
        print(json.dumps({"placed": placed_phase(torch)}, default=str),
              flush=True)
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        card_info(torch)
        print(json.dumps({"dryrun": dryrun_phase(torch)}), flush=True)
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
    _, dense_stats, dense_counts = serve_dense_path(torch, "yi-6b",
                                                    yi_params)
    yi_tie = dense_decode_tie(torch, yi_cfg, yi_params,
                              dense_stats["p50_ms"])
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
    gc.collect()
    torch.cuda.empty_cache()
    guard.set_parity("off")
    meshed = mesh_phase(torch)
    log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    mesh_trained = mesh_train_phase(torch)
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    mesh_paged = mesh_paged_phase(torch)
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
    t15 = time.perf_counter()
    dryrun = {"sweep": dryrun_sweep(),
              "dense yi-6b decode step": yi_tie,
              f"{TRAIN_ARCH} train step": trained["dryrun"]}
    log(f"phase 15 done at {time.perf_counter() - t_start:.1f} s (the "
        f"sweep {time.perf_counter() - t15:.1f} s; (b) "
        f"{yi_tie['traced_s'] + trained['dryrun']['traced_s']:.1f} s of "
        f"traces in phases 5c and 11d)")
    placed = placed_phase(torch)
    log(f"phase 16 done at {time.perf_counter() - t_start:.1f} s "
        f"({placed['seconds']:.1f} s)")
    placed_paths = {}
    for path, c in placed["reduced_launches"].items():
        for name in ("flash_decode", "moe_gmm", "ssd_scan"):
            if c.get(name):
                placed_paths.setdefault(name, {})[
                    f"placed {path}"] = c[name]
    for arch, run in placed["serve"].items():
        for r, c in enumerate(run["launches"]):
            for name in ("flash_decode", "moe_gmm"):
                if c.get(name):
                    placed_paths.setdefault(name, {})[
                        f"placed {arch} 1x2 rank {r}"] = c[name]
    paged_ranks = {f"mesh paged {MESH_PAGED_ARCH} rank {r}": c
                   for r, c in enumerate(mesh_paged["launches"])}
    mesh_train_paths = {"moe_gmm": {}, "ssd_scan": {}, "ssd_scan_bwd": {}}
    for arch, shape, _ in MESH_TRAIN:
        tag = f"{arch} {_mesh_tag(shape)}"
        for name in mesh_train_launches(get_config(arch), 1):
            for r, c in enumerate(mesh_trained[tag]["launches"]):
                mesh_train_paths[name][f"mesh train {tag} rank {r}"] = \
                    c[name]
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
                             MOE_ARCH: moe_counts["paged_decode"], **{
                                 path: c["paged_decode"]
                                 for path, c in paged_ranks.items()}},
        "parity": "ok",
        **{k: timing[k] for k in keys},
        "splits": timing["splits"],
        "shape": timing["shape"],
        "at_other_shapes": {"B=1": {k: timing["b1"][k] for k in
                                    keys + ("splits", "shape")},
                            f"mesh paged {MESH_PAGED_ARCH} round": {
                                k: mesh_paged["kernels"]["paged_decode"][k]
                                for k in keys + ("splits", "shape")}},
    }, {
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:63",
        "tpu": "kernels/decode_attention/decode_attention.py:flash_decode",
        "launches": dense_counts["flash_decode"],
        "launches_by_path": {"yi-6b": dense_counts["flash_decode"], **{
            arch: family[arch]["counts"]["flash_decode"]
            for arch in FAMILY_ARCHS}, **{
            f"mesh {arch} rank {r}": c["flash_decode"]
            for arch, ranks in meshed["launches"].items()
            for r, c in enumerate(ranks)},
            **placed_paths["flash_decode"]},
        "parity": "ok",
        **{k: fd_timing[k] for k in keys},
        "splits": fd_timing["splits"],
        "shape": fd_timing["shape"],
        "at_other_shapes": {"B=1": {k: fd_b1[k] for k in
                                    keys + ("splits", "shape")}, **{
            label: {k: t[k] for k in keys + ("splits", "shape")}
            for label, t in fd_family.items()}, **{
            f"with lse, {label}": t
            for label, t in meshed["flash_decode_lse"].items()}},
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
                for arch, t in trained["ssm"].items()},
            **mesh_train_paths["ssd_scan"], **placed_paths["ssd_scan"]},
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
            f"{TRAIN_ARCH} train": trained["launches"]["moe_gmm"],
            **{f"mesh {TRAIN_ARCH} rank {r}": c["moe_gmm"]
               for r, c in enumerate(meshed["launches"][TRAIN_ARCH])},
            **mesh_train_paths["moe_gmm"],
            **{path: c["moe_gmm"] for path, c in paged_ranks.items()},
            **placed_paths["moe_gmm"]},
        "launches_a_train_step": trained["launches_a_step"]["moe_gmm"],
        "parity": "ok",
        **{k: gmm_times["decode gate/up"][k] for k in keys},
        "shape": gmm_times["decode gate/up"]["shape"],
        "at_other_shapes": {name: {k: t[k] for k in keys + ("shape",)}
                            for name, t in {**gmm_times,
                                            **trained["gmm_times"],
                                            **meshed["gmm"],
                                            **mesh_paged["kernels"]["gmm"]
                                            }.items()
                            if name != "decode gate/up"},
    }, ssd_bwd_entry(trained, mesh_train_paths["ssd_scan_bwd"])]
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
                                if not k.endswith("_times")
                                and k != "dryrun"}}), flush=True)
    print(json.dumps({"substrate": guard.stats()}), flush=True)
    print(json.dumps({"mesh": {k: meshed[k] for k in ("serve", "launches")}}),
          flush=True)
    print(json.dumps({"mesh_train": mesh_trained}), flush=True)
    print(json.dumps({"mesh_paged": {k: mesh_paged[k] for k in (
        "reduced", "serve", "launches", "seconds")}}), flush=True)
    print(json.dumps({"dryrun": dryrun}), flush=True)
    print(json.dumps({"placed": {k: placed[k] for k in (
        "serve", "reduced_launches", "seconds")}}, default=str), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
