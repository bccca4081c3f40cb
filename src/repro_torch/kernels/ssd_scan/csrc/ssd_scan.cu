// Chunked Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan.
// For each sequence b and head h, from a zero state, with a = A[h] < 0,
// x [b, s, nh, P], dt [b, s, nh], B and C [b, s, N] (one group: B and C are
// shared by every head):
//
//   state_t = state_{t-1} * exp(dt_t a) + dt_t x_t B_t^T      ([P, N], f32)
//   y_t     = state_t C_t                                     ([P])
//
// computed as the chunked SSD (Mamba-2, arXiv:2405.21060 section 6) made
// parallel over chunks of kL rows: within a chunk, cs = cumsum(dt a),
//   y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//       + exp(cs_i) C_i h_{c-1}                                   (inter)
//   S_c = sum_j exp(total - cs_j) dt_j x_j B_j^T                  (the chunk's own state)
//   h_c = h_{c-1} exp(total) + S_c                                (the state pass)
// in three launches, one call:
//   (a) chunk_state_kernel, a block per (sequence, chunk, group of heads):
//       the cumsum and S_c of each head of the group, into an f32
//       workspace [b, chunks, nh, P, N], and exp's argument `total`;
//   (b) state_pass_kernel, per (sequence, head, slice of the state): the
//       only sequential part, P x N per chunk; it overwrites the workspace
//       with the state entering each chunk and writes h_final;
//   (c) chunk_scan_kernel, a block per (sequence, chunk, group of heads):
//       C B^T once for the group, then each head's intra and inter terms,
//       y rounded once to x's type.
// The result does not depend on the chunk length but for rounding; the
// kernel's chunk is kL rows (128 in bf16, 64 in f32), whatever the caller's.
// No exponent of a positive argument is taken: exp(cs_i - cs_j) only for
// j <= i, and exp(total - cs_j), exp(cs_i), exp(total) are all of
// non-positive arguments (the Pallas body's exp(seg) * causal overflows
// above the diagonal once a chunk's decay passes ~88).
//
// What bounds it: bytes in bf16 (at mamba2's prefill shape ~117 MB in and
// out against ~14 GFLOP on tensor cores), operations in f32 (SIMT). What
// the design does about it:
//   * bf16 products run on tensor cores (mma.sync m16n8k16, f32
//     accumulators, operands by ldmatrix): C B^T, the intra term, the inter
//     term and S_c. x, B and C are exact in bf16; an operand carrying a
//     factor computed in f32 (the decayed scores, x exp(total - cs) dt, the
//     state) is split into a bf16 high part and a bf16 low part, two
//     products, so it keeps ~16 bits and the f32 state stays within 2e-3;
//   * f32 inputs take the same decomposition with f32 FMA products on CUDA
//     cores (register tiles of 4 x 4): no TF32 or bf16 rounding;
//   * C B^T does not depend on the head: a block of (c) computes it once
//     for a group of heads and keeps it in shared memory; per head, the
//     whole block turns it into the decayed scores (each exponent once) and
//     the entering state into its bf16 parts, in shared memory, so that the
//     warps' products read every operand by ldmatrix;
//   * each block keeps `depth` heads' tiles (x, dt and, in (c), the entering
//     state) in flight in a ring of shared-memory slots filled by cp.async
//     (the shared coro_ring.cuh), so the copies of head k + depth overlap
//     the products of head k, and starts the tiles of the head after into
//     L2; `depth` is solved by the host from the reference's CoroSpec and
//     clamped to shared memory and to the group (at mamba2's widths C, C B^T
//     and the scores leave room for one slot in (c): one 512-thread block
//     an SM, and its per-head phases, not its products, take most of (c)'s
//     time);
//   * rows past the sequence and padding columns are zeros in shared
//     memory (dt 0 there), so the last chunk needs no masked products.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/coro_ring.cuh"

namespace {

#include "../../csrc/ssd_common.cuh"

using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::cp_async_wait_pending;

constexpr int kThreads = 256;      // (a) and (b)
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 512;  // (c): 16 warps, the most its registers allow
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxState = 128;  // N
constexpr int kMaxHead = 128;   // P

// Rows of the kernel's chunk.
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kL = 128;
};
template <>
struct Chunk<float> {
  static constexpr int kL = 64;
};

// Shared-memory layout of (a) and (c), the same on the host and in the
// kernels (and in repro_torch/kernels/ssd_scan/ssd_scan.py:_layout). Tiles
// are row-major; strides in elements. bf16 (tensor cores): P and N padded
// to 16, rows 8 elements (16 bytes) longer than that, so that ldmatrix and
// the f32 fragment loads meet no bank conflict; the f32 state's rows are 12
// values longer (an odd number of 16-byte units), and hold its bf16 high
// and low parts after the state lands; f32: unpadded, C B^T rows 4 longer.
struct Smem {
  int Pp, Np, xs, bs, hs, cbs;
  size_t x, bc, h, cb, dtw, vec;
  bool tc;
  __host__ __device__ Smem(bool tensor_cores, int L, int P, int N) : tc(tensor_cores) {
    Pp = tc ? round16(P) : P;
    Np = tc ? round16(N) : N;
    const int isz = tc ? 2 : 4;
    xs = tc ? Pp + 8 : P;
    bs = tc ? Np + 8 : N;
    hs = tc ? Np + 12 : N;
    cbs = L + (tc ? 8 : 4);
    x = static_cast<size_t>(L) * xs * isz;    // x tile [L][xs]
    bc = static_cast<size_t>(L) * bs * isz;   // B or C tile [L][bs]
    h = static_cast<size_t>(Pp) * hs * 4;     // f32 state [Pp][hs]
    cb = static_cast<size_t>(L) * cbs * 4;    // f32 C B^T [L][cbs]
    dtw = static_cast<size_t>(L) * 4;         // dt, a 4-byte word a row
    vec = static_cast<size_t>(3 * L + 8) * 4; // cs, exp(cs) (or w), dt, scratch
  }
  // (a): B, x exp(total - cs) dt (bf16: high and low parts), vectors; a
  // slot: x and dt
  __host__ __device__ size_t fixed_a() const { return bc + (tc ? 2 : 1) * x + vec; }
  __host__ __device__ size_t slot_a() const { return x + dtw; }
  // (c): C, C B^T (B is staged there in bf16; f32 keeps B beside it), a
  // head's decayed scores (f32 [L][cbs]; bf16: high and low parts, each
  // [L][L + 8], the same bytes), vectors; a slot: x, the entering state and dt
  __host__ __device__ size_t fixed_c() const { return (tc ? 1 : 2) * bc + 2 * cb + vec; }
  __host__ __device__ size_t slot_c() const { return x + h + dtw; }
};

// The operands of one call.
struct ScanArgs {
  const void* x;
  int64_t x_sb, x_st;
  const void* dt;
  int64_t dt_sb, dt_st, dt_sh;
  const float* A;
  const void* B;
  int64_t b_sb, b_st;
  const void* C;
  int64_t c_sb, c_st;
  void* y;
  float* h_out;
  float* states;  // [b, chunks, nh, P, N]: S_c after (a), the entering state after (b)
  float* totals;  // [b, chunks, nh]: sum of dt a over the chunk
  int S, NH, P, N, chunks, group;
};

// Inclusive cumsum over the chunk's rows: row r's value on thread r (r < L,
// 0 past the sequence); returns thread tid's sum. Every thread calls it.
template <int L>
__device__ __forceinline__ float chunk_cumsum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31 && warp < L / 32) scratch[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp && w < L / 32; ++w) base += scratch[w];
  __syncthreads();  // scratch is free again
  return v + base;
}

// The dt of row tid of `head`'s slot (0 past the sequence and for threads
// past the chunk).
template <typename TD>
__device__ __forceinline__ float row_dt(const uint32_t* dtw, const TD* dtg, const ScanArgs& a,
                                        int head, int valid) {
  const int r = threadIdx.x;
  return r < valid ? DtUnit<TD>::read(dtw + r, dtg + head * a.dt_sh + r * a.dt_st) : 0.f;
}

// Where a block is: its sequence b, chunk c (rows t0 .. t0 + valid), and
// heads h0 .. h0 + nheads.
struct Place {
  int b, c, h0, nheads, t0, valid;
  __device__ Place(const ScanArgs& a, int L) {
    h0 = blockIdx.x * a.group;
    nheads = min(a.group, a.NH - h0);
    c = blockIdx.y;
    b = blockIdx.z;
    t0 = c * L;
    valid = min(L, a.S - t0);
  }
  __device__ size_t state(const ScanArgs& a, int head) const {
    return ((static_cast<size_t>(b) * a.chunks + c) * a.NH + head) * a.P * a.N;
  }
};

// (a) S_c = sum_j (x_j exp(total - cs_j) dt_j)^T B_j of each head of the
// block's group, into the workspace, and total = cs at the chunk's end.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(const ScanArgs a, int depth) {
  constexpr int L = Chunk<T>::kL;
  constexpr bool kTC = sizeof(T) == 2;
  const Place at(a, L);
  const Smem m(kTC, L, a.P, a.N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bt = reinterpret_cast<T*>(smem);                    // B [L][bs]
  T* xw = reinterpret_cast<T*>(smem + m.bc);             // x w [L][xs] (bf16: high, then low)
  float* cs_s = reinterpret_cast<float*>(smem + m.bc + (kTC ? 2 : 1) * m.x);
  float* w_s = cs_s + L;  // exp(total - cs) dt
  float* scratch = cs_s + 3 * L;
  unsigned char* ring = smem + m.fixed_a();
  auto x_slot = [&](int s) { return reinterpret_cast<T*>(ring + s * m.slot_a()); };
  auto dt_slot = [&](int s) { return reinterpret_cast<uint32_t*>(ring + s * m.slot_a() + m.x); };

  const T* xg = static_cast<const T*>(a.x) + at.b * a.x_sb + at.t0 * a.x_st;
  const TD* dtg = static_cast<const TD*>(a.dt) + at.b * a.dt_sb + at.t0 * a.dt_st;
  auto issue = [&](int k, int slot) {
    if (k >= at.nheads) return;
    const int head = at.h0 + k;
    copy_rows<kThreads>(x_slot(slot), m.xs, xg + head * a.P, a.x_st, at.valid, a.P);
    uint32_t* dw = dt_slot(slot);
    for (int r = tid; r < at.valid; r += kThreads)
      DtUnit<TD>::load(dw + r, dtg + head * a.dt_sh + r * a.dt_st);
  };

  zero_pad<kThreads>(bt, L, m.bs, at.valid, a.N);
  for (int s = 0; s < depth; ++s) zero_pad<kThreads>(x_slot(s), L, m.xs, at.valid, a.P);
  copy_rows<kThreads>(bt, m.bs, static_cast<const T*>(a.B) + at.b * a.b_sb + at.t0 * a.b_st, a.b_st,
            at.valid, a.N);
  for (int s = 0; s < depth; ++s) {
    issue(s, s);
    cp_async_commit();  // group 0 also holds B
  }

  for (int k = 0; k < at.nheads; ++k) {
    const int slot = k % depth;
    const int head = at.h0 + k;
    if (k + depth < at.nheads)  // the head this slot takes next, into L2
      prefetch_rows<kThreads>(xg + (head + depth) * a.P, a.x_st, at.valid, a.P);
    cp_async_wait_pending(depth - 1);
    __syncthreads();
    const float d = row_dt(dt_slot(slot), dtg, a, head, at.valid);
    const float cs = chunk_cumsum<L>(d * a.A[head], scratch);
    if (tid < L) cs_s[tid] = cs;
    __syncthreads();
    const float total = cs_s[L - 1];
    if (tid < L) w_s[tid] = expf(total - cs) * d;
    if (tid == 0) a.totals[(static_cast<size_t>(at.b) * a.chunks + at.c) * a.NH + head] = total;
    __syncthreads();
    const T* xs = x_slot(slot);
    float* out = a.states + at.state(a, head);
    if constexpr (kTC) {
      // x w as bf16 high and low parts, [L][xs] each
      T* lo = xw + L * m.xs;
      for_rows<kThreads>(L, m.Pp / 2, [&](int j, int pair) {
        const int p = 2 * pair;
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + j * m.xs + p));
        uint32_t hi32, lo32;
        split(v.x * w_s[j], v.y * w_s[j], &hi32, &lo32);
        *reinterpret_cast<uint32_t*>(xw + j * m.xs + p) = hi32;
        *reinterpret_cast<uint32_t*>(lo + j * m.xs + p) = lo32;
      });
      __syncthreads();
      // S [Pp x Np] = (x w)^T [Pp x L] B [L x Np]: a warp takes a 16-row
      // tile of p and four 8-column tiles of n at a time
      const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, tig = lane & 3;
      const int mt_n = m.Pp / 16, nt_n = m.Np / 8, units = mt_n * ((nt_n + 3) / 4);
      for (int u = warp; u < units; u += kWarps) {
        const int mt = u % mt_n, n_base = (u / mt_n) * 32;
        float acc[4][4] = {};
        for (int ks = 0; ks < L / 16; ++ks) {
          uint32_t ahi[4], alo[4];
          const int off = (ks * 16 + r8 + (q >> 1) * 8) * m.xs + mt * 16 + (q & 1) * 8;
          ldsm_x4_trans(ahi, xw + off);
          ldsm_x4_trans(alo, lo + off);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int n0 = n_base + np * 16;
            if (n0 >= m.Np) break;
            uint32_t bf[4];
            ldsm_x4_trans(bf, bt + (ks * 16 + r8 + (q & 1) * 8) * m.bs + n0 + (q >> 1) * 8);
            mma(acc[2 * np], ahi, bf[0], bf[1]);
            mma(acc[2 * np + 1], ahi, bf[2], bf[3]);
            mma(acc[2 * np], alo, bf[0], bf[1]);
            mma(acc[2 * np + 1], alo, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n_base + nt * 8 + 2 * tig;
          if (n >= a.N) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = mt * 16 + g + hf * 8;
            if (p < a.P)
              *reinterpret_cast<float2*>(out + p * a.N + n) =
                  make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
          }
        }
      }
    } else {
      // x w, then S [P x N] in 4 x 4 register tiles over the L rows
      for (int e = tid; e < L * (a.P / 4); e += kThreads) {
        const int j = e / (a.P / 4), p = 4 * (e - j * (a.P / 4));
        float4 v = *reinterpret_cast<const float4*>(xs + j * m.xs + p);
        const float wj = w_s[j];
        v.x *= wj; v.y *= wj; v.z *= wj; v.w *= wj;
        *reinterpret_cast<float4*>(xw + j * m.xs + p) = v;
      }
      __syncthreads();
      const int n4 = a.N / 4;
      for (int t = tid; t < (a.P / 4) * n4; t += kThreads) {
        const int p0 = (t / n4) * 4, n0 = (t - (t / n4) * n4) * 4;
        float acc[4][4] = {};
        for (int j = 0; j < L; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(xw + j * m.xs + p0);
          const float4 bv = *reinterpret_cast<const float4*>(bt + j * m.bs + n0);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xr[u], br[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(out + (p0 + u) * a.N + n0) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
    }
    __syncthreads();  // the slot and x w are free
    issue(k + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// (b) Along the chunks of one (sequence, head), 8 values of the state a
// thread: h_c = h_{c-1} exp(total_c) + S_c. The workspace's slot c (c > 0)
// is overwritten with the state entering chunk c; the last state is h_final.
__global__ void __launch_bounds__(kThreads) state_pass_kernel(const ScanArgs a) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int PN = a.P * a.N;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * 8;
  if (e0 >= PN) return;  // PN is a multiple of 16: a thread's 8 all exist
  const size_t step = static_cast<size_t>(a.NH) * PN;
  float* s = a.states + (static_cast<size_t>(b) * a.chunks * a.NH + head) * PN + e0;
  const float* tot = a.totals + static_cast<size_t>(b) * a.chunks * a.NH + head;
  float4 h[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  float4 nxt[2] = {reinterpret_cast<const float4*>(s)[0], reinterpret_cast<const float4*>(s)[1]};
  for (int c = 0; c < a.chunks; ++c) {
    const float4 cur[2] = {nxt[0], nxt[1]};
    if (c + 1 < a.chunks) {
      nxt[0] = reinterpret_cast<const float4*>(s + (c + 1) * step)[0];
      nxt[1] = reinterpret_cast<const float4*>(s + (c + 1) * step)[1];
    }
    const float decay = expf(tot[static_cast<size_t>(c) * a.NH]);
    if (c > 0) {
      reinterpret_cast<float4*>(s + c * step)[0] = h[0];
      reinterpret_cast<float4*>(s + c * step)[1] = h[1];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      h[k].x = fmaf(h[k].x, decay, cur[k].x);
      h[k].y = fmaf(h[k].y, decay, cur[k].y);
      h[k].z = fmaf(h[k].z, decay, cur[k].z);
      h[k].w = fmaf(h[k].w, decay, cur[k].w);
    }
  }
  float4* ho = reinterpret_cast<float4*>(a.h_out + (static_cast<size_t>(b) * a.NH + head) * PN + e0);
  ho[0] = h[0];
  ho[1] = h[1];
}

// (c) y of each head of the block's group: the intra term through C B^T
// (computed once for the group) and the inter term through the state
// entering the chunk, y rounded once to x's type.
template <typename T, typename TD>
__global__ void __launch_bounds__(kScanThreads) chunk_scan_kernel(const ScanArgs a, int depth) {
  constexpr int L = Chunk<T>::kL;
  constexpr bool kTC = sizeof(T) == 2;
  const Place at(a, L);
  const Smem m(kTC, L, a.P, a.N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  // [C][C B^T (bf16: B staged there first)][the decayed scores (bf16: high
  // and low parts, [L][L + 8] each)][f32: B]; then cs (log2 units),
  // exp(cs), dt
  T* ct = reinterpret_cast<T*>(smem);
  float* cbm = reinterpret_cast<float*>(smem + m.bc);
  float* pm = reinterpret_cast<float*>(smem + m.bc + m.cb);
  T* bt = reinterpret_cast<T*>(kTC ? smem + m.bc : smem + m.bc + 2 * m.cb);
  __nv_bfloat16* ps_hi = reinterpret_cast<__nv_bfloat16*>(pm);
  __nv_bfloat16* ps_lo = ps_hi + L * (L + 8);
  float* cs_s = reinterpret_cast<float*>(smem + m.fixed_c() - m.vec);
  float* ecs_s = cs_s + L;
  float* dtv_s = cs_s + 2 * L;
  float* scratch = cs_s + 3 * L;
  unsigned char* ring = smem + m.fixed_c();
  auto x_slot = [&](int s) { return reinterpret_cast<T*>(ring + s * m.slot_c()); };
  auto h_slot = [&](int s) { return reinterpret_cast<float*>(ring + s * m.slot_c() + m.x); };
  auto dt_slot = [&](int s) {
    return reinterpret_cast<uint32_t*>(ring + s * m.slot_c() + m.x + m.h);
  };

  const T* xg = static_cast<const T*>(a.x) + at.b * a.x_sb + at.t0 * a.x_st;
  const TD* dtg = static_cast<const TD*>(a.dt) + at.b * a.dt_sb + at.t0 * a.dt_st;
  const bool inter = at.c > 0;  // chunk 0 enters from a zero state
  auto issue = [&](int k, int slot) {
    if (k >= at.nheads) return;
    const int head = at.h0 + k;
    copy_rows<kScanThreads>(x_slot(slot), m.xs, xg + head * a.P, a.x_st, at.valid, a.P);
    if (inter)
      copy_rows<kScanThreads>(h_slot(slot), m.hs, a.states + at.state(a, head), a.N, a.P, a.N);
    uint32_t* dw = dt_slot(slot);
    for (int r = tid; r < at.valid; r += kScanThreads)
      DtUnit<TD>::load(dw + r, dtg + head * a.dt_sh + r * a.dt_st);
  };

  zero_pad<kScanThreads>(ct, L, m.bs, at.valid, a.N);
  zero_pad<kScanThreads>(bt, L, m.bs, at.valid, a.N);
  for (int s = 0; s < depth; ++s) {
    zero_pad<kScanThreads>(x_slot(s), L, m.xs, at.valid, a.P);
    zero_pad<kScanThreads>(h_slot(s), m.Pp, m.hs, a.P, a.N);
  }
  copy_rows<kScanThreads>(ct, m.bs, static_cast<const T*>(a.C) + at.b * a.c_sb + at.t0 * a.c_st, a.c_st,
            at.valid, a.N);
  copy_rows<kScanThreads>(bt, m.bs, static_cast<const T*>(a.B) + at.b * a.b_sb + at.t0 * a.b_st, a.b_st,
            at.valid, a.N);
  for (int s = 0; s < depth; ++s) {
    issue(s, s);
    cp_async_commit();  // group 0 also holds B and C
  }
  cp_async_wait_pending(depth - 1);
  __syncthreads();

  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, tig = lane & 3;
  // C B^T once for the group: bf16, the 16 x 16 blocks on and below the
  // diagonal on tensor cores, all in registers before B's bytes are
  // overwritten; f32, every entry in 4 x 4 register tiles
  if constexpr (kTC) {
    constexpr int kRB = L / 16;
    constexpr int kUnits = kRB * (kRB + 1) / 2;
    constexpr int kWarpsC = kScanThreads / 32;
    constexpr int kMine = (kUnits + kWarpsC - 1) / kWarpsC;
    float acc[kMine][2][4] = {};
#pragma unroll
    for (int k = 0; k < kMine; ++k) {
      const int u = warp + k * kWarpsC;
      if (u >= kUnits) break;
      int rb = 0;
      while ((rb + 1) * (rb + 2) / 2 <= u) ++rb;
      const int kb = u - rb * (rb + 1) / 2;
      for (int ks = 0; ks < m.Np / 16; ++ks) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, ct + (rb * 16 + r8 + (q & 1) * 8) * m.bs + ks * 16 + (q >> 1) * 8);
        ldsm_x4(bf, bt + (kb * 16 + r8 + (q >> 1) * 8) * m.bs + ks * 16 + (q & 1) * 8);
        mma(acc[k][0], af, bf[0], bf[1]);
        mma(acc[k][1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every read of B is done
#pragma unroll
    for (int k = 0; k < kMine; ++k) {
      const int u = warp + k * kWarpsC;
      if (u >= kUnits) break;
      int rb = 0;
      while ((rb + 1) * (rb + 2) / 2 <= u) ++rb;
      const int kb = u - rb * (rb + 1) / 2;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(cbm + (rb * 16 + g + hf * 8) * m.cbs + kb * 16 + nt * 8 +
                                     2 * tig) =
              make_float2(acc[k][nt][2 * hf], acc[k][nt][2 * hf + 1]);
    }
  } else {
    for (int t = tid; t < (L / 4) * (L / 4); t += kScanThreads) {
      const int i0 = (t / (L / 4)) * 4, j0 = (t % (L / 4)) * 4;
      float acc[4][4] = {};
      for (int n = 0; n < a.N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = *reinterpret_cast<const float4*>(ct + (i0 + u) * m.bs + n);
          bv[u] = *reinterpret_cast<const float4*>(bt + (j0 + u) * m.bs + n);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[u][v] = fmaf(cv[u].x, bv[v].x,
                             fmaf(cv[u].y, bv[v].y,
                                  fmaf(cv[u].z, bv[v].z, fmaf(cv[u].w, bv[v].w, acc[u][v]))));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(cbm + (i0 + u) * m.cbs + j0) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
  __syncthreads();

  for (int k = 0; k < at.nheads; ++k) {
    const int slot = k % depth;
    const int head = at.h0 + k;
    if (k + depth < at.nheads) {  // the head this slot takes next, into L2
      prefetch_rows<kScanThreads>(xg + (head + depth) * a.P, a.x_st, at.valid, a.P);
      if (inter && tid == 0)
        bulk_prefetch_l2(a.states + at.state(a, head + depth),
                         static_cast<uint32_t>(a.P) * a.N * 4);
    }
    if (k > 0) {
      cp_async_wait_pending(depth - 1);
      __syncthreads();
    }
    const T* xs = x_slot(slot);
    const float* hs = h_slot(slot);
    const float d = row_dt(dt_slot(slot), dtg, a, head, at.valid);
    const float cs = chunk_cumsum<L>(d * a.A[head], scratch);
    if (tid < L) {
      cs_s[tid] = cs * kLog2e;  // exp(cs_i - cs_j) = exp2(cs_s[i] - cs_s[j])
      ecs_s[tid] = expf(cs);
      dtv_s[tid] = d;
    }
    __syncthreads();
    T* yg = static_cast<T*>(a.y) + (static_cast<int64_t>(at.b) * a.S + at.t0) * a.NH * a.P +
            head * a.P;
    const int64_t y_st = static_cast<int64_t>(a.NH) * a.P;
    if constexpr (kTC) {
      // the decayed scores on and below the diagonal 16 x 16 blocks, once
      // a head, as bf16 high and low parts: (C_i . B_j) exp(cs_i - cs_j)
      // dt_j, 0 above the diagonal (never exponentiated)
      constexpr int kSS = L + 8;
      constexpr int kBlocks = (L / 16) * (L / 16 + 1) / 2;
      for (int e = tid; e < kBlocks * 128; e += kScanThreads) {
        const int blk = e >> 7;  // warp-uniform: 128 column pairs a block
        // the block's row: the largest rb with rb (rb + 1) / 2 <= blk
        // (sqrtf is exact on the perfect squares 8 blk + 1 of a row's start)
        const int rb = (static_cast<int>(sqrtf(8.f * blk + 1.f)) - 1) >> 1;
        const int i = rb * 16 + ((e >> 3) & 15);
        const int j = (blk - rb * (rb + 1) / 2) * 16 + 2 * (e & 7);
        const float2 cb = *reinterpret_cast<const float2*>(cbm + i * m.cbs + j);
        const float p0 = j <= i ? cb.x * exp2_neg(cs_s[i] - cs_s[j]) * dtv_s[j] : 0.f;
        const float p1 =
            j + 1 <= i ? cb.y * exp2_neg(cs_s[i] - cs_s[j + 1]) * dtv_s[j + 1] : 0.f;
        split(p0, p1, reinterpret_cast<uint32_t*>(ps_hi + i * kSS + j),
              reinterpret_cast<uint32_t*>(ps_lo + i * kSS + j));
      }
      // the entering state's f32 rows [p][n] become their bf16 high parts
      // (at n) and low parts (at Np + 8 + n) in place, zeros past N
      const int kHS = 2 * m.hs;  // a state row in bf16 elements
      __nv_bfloat16* h_hi = reinterpret_cast<__nv_bfloat16*>(const_cast<float*>(hs));
      if (inter) {
        constexpr int kMost = kMaxHead * kMaxState / 4 / kScanThreads;
        const int n4 = m.Np / 4, units = a.P * n4;
        // thread tid's t-th value: p = (tid + t kScanThreads) / n4, its n
        // the same for every t when n4 divides the block
        const bool even = kScanThreads % n4 == 0;
        const int p0 = tid / n4, n0 = 4 * (tid % n4), p_step = kScanThreads / n4;
        auto at = [&](int t, int* p, int* n) {
          const int e = tid + t * kScanThreads;
          *p = even ? p0 + t * p_step : e / n4;
          *n = even ? n0 : 4 * (e % n4);
          return e < units;
        };
        float4 v[kMost];
#pragma unroll
        for (int t = 0; t < kMost; ++t) {
          int p, n;
          v[t] = at(t, &p, &n) && n < a.N ? *reinterpret_cast<const float4*>(hs + p * m.hs + n)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();  // every value is read before any is overwritten
#pragma unroll
        for (int t = 0; t < kMost; ++t) {
          int p, n;
          if (!at(t, &p, &n)) break;
          uint32_t hi[2], lo[2];
          split(v[t].x, v[t].y, &hi[0], &lo[0]);
          split(v[t].z, v[t].w, &hi[1], &lo[1]);
          *reinterpret_cast<uint2*>(h_hi + p * kHS + n) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(h_hi + p * kHS + m.Np + 8 + n) = make_uint2(lo[0], lo[1]);
        }
      }
      __syncthreads();
      // warp w: row blocks r0 and 7 - r0 (r0 = w % 4; the causal work of
      // the pair is the same for every warp) and the 16-column pairs of
      // p tiles cg, cg + 4 (cg = w / 4): two row blocks x up to four
      // 8-column tiles
      constexpr int kRB = L / 16;
      const int r0 = warp & 3, cg = warp >> 2;
      const int rbs[2] = {r0, kRB - 1 - r0};
      const int pairs = m.Pp / 16;
      if (cg < pairs) {
        float yi[2][4][4] = {}, ye[2][4][4] = {};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rb = rbs[r];
          for (int kb = 0; kb <= rb; ++kb) {
            uint32_t ahi[4], alo[4];
            const int off = (rb * 16 + r8 + (q & 1) * 8) * kSS + kb * 16 + (q >> 1) * 8;
            ldsm_x4(ahi, ps_hi + off);
            ldsm_x4(alo, ps_lo + off);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              const int pair = cg + 4 * np;
              if (pair >= pairs) break;
              uint32_t bf[4];
              ldsm_x4_trans(bf, xs + (kb * 16 + r8 + (q & 1) * 8) * m.xs + pair * 16 +
                                    (q >> 1) * 8);
              mma(yi[r][2 * np], ahi, bf[0], bf[1]);
              mma(yi[r][2 * np + 1], ahi, bf[2], bf[3]);
              mma(yi[r][2 * np], alo, bf[0], bf[1]);
              mma(yi[r][2 * np + 1], alo, bf[2], bf[3]);
            }
          }
        }
        if (inter) {
          for (int ks = 0; ks < m.Np / 16; ++ks) {
            uint32_t af[2][4];
#pragma unroll
            for (int r = 0; r < 2; ++r)
              ldsm_x4(af[r], ct + (rbs[r] * 16 + r8 + (q & 1) * 8) * m.bs + ks * 16 + (q >> 1) * 8);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              const int pair = cg + 4 * np;
              if (pair >= pairs) break;
              // the state as B fragments (k = n, column = p) from its
              // [p][n] high and low parts
              const __nv_bfloat16* hp =
                  h_hi + (pair * 16 + r8 + (q >> 1) * 8) * kHS + ks * 16 + (q & 1) * 8;
              uint32_t bh[4], bl[4];
              ldsm_x4(bh, hp);
              ldsm_x4(bl, hp + m.Np + 8);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                mma(ye[r][2 * np], af[r], bh[0], bh[1]);
                mma(ye[r][2 * np + 1], af[r], bh[2], bh[3]);
              }
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                mma(ye[r][2 * np], af[r], bl[0], bl[1]);
                mma(ye[r][2 * np + 1], af[r], bl[2], bl[3]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int pair = cg + 4 * (nt >> 1);
            const int p = pair * 16 + (nt & 1) * 8 + 2 * tig;
            if (pair >= pairs || p >= a.P) continue;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = rbs[r] * 16 + g + hf * 8;
              if (i >= at.valid) continue;
              const float e = ecs_s[i];
              *reinterpret_cast<__nv_bfloat162*>(yg + i * y_st + p) = __floats2bfloat162_rn(
                  fmaf(e, ye[r][nt][2 * hf], yi[r][nt][2 * hf]),
                  fmaf(e, ye[r][nt][2 * hf + 1], yi[r][nt][2 * hf + 1]));
            }
          }
      }
    } else {
      // the decayed scores, then y in 4 x 4 register tiles (rows i, columns p)
      for (int e = tid; e < L * L; e += kScanThreads) {
        const int i = e / L, j = e - i * L;
        pm[i * m.cbs + j] = j <= i ? cbm[i * m.cbs + j] * exp2f(cs_s[i] - cs_s[j]) * dtv_s[j] : 0.f;
      }
      __syncthreads();
      const int p4 = a.P / 4;
      for (int t = tid; t < (L / 4) * p4; t += kScanThreads) {
        const int i0 = (t / p4) * 4, p0 = (t - (t / p4) * p4) * 4;
        float yi[4][4] = {}, ye[4][4] = {};
        for (int j = 0; j < i0 + 4; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + j * m.xs + p0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float s = pm[(i0 + u) * m.cbs + j];
            yi[u][0] = fmaf(s, xv.x, yi[u][0]);
            yi[u][1] = fmaf(s, xv.y, yi[u][1]);
            yi[u][2] = fmaf(s, xv.z, yi[u][2]);
            yi[u][3] = fmaf(s, xv.w, yi[u][3]);
          }
        }
        if (inter) {
          for (int n = 0; n < a.N; n += 4) {
            float4 cv[4], hv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              cv[u] = *reinterpret_cast<const float4*>(ct + (i0 + u) * m.bs + n);
              hv[u] = *reinterpret_cast<const float4*>(hs + (p0 + u) * m.hs + n);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                ye[u][v] = fmaf(cv[u].x, hv[v].x,
                                fmaf(cv[u].y, hv[v].y,
                                     fmaf(cv[u].z, hv[v].z, fmaf(cv[u].w, hv[v].w, ye[u][v]))));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          if (i >= at.valid) continue;
          const float e = ecs_s[i];
          *reinterpret_cast<float4*>(yg + i * y_st + p0) =
              make_float4(fmaf(e, ye[u][0], yi[u][0]), fmaf(e, ye[u][1], yi[u][1]),
                          fmaf(e, ye[u][2], yi[u][2]), fmaf(e, ye[u][3], yi[u][3]));
        }
      }
    }
    __syncthreads();  // the slot is free
    issue(k + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

template <typename T, typename TD>
cudaError_t launch(const ScanArgs& a, int Bsz, int depth, cudaStream_t stream) {
  constexpr int L = Chunk<T>::kL;
  const Smem m(sizeof(T) == 2, L, a.P, a.N);
  const size_t smem_a = m.fixed_a() + depth * m.slot_a();
  const size_t smem_c = m.fixed_c() + depth * m.slot_c();
  auto ka = chunk_state_kernel<T, TD>;
  auto kc = chunk_scan_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_a));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_c));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.NH + a.group - 1) / a.group, a.chunks, Bsz);
  ka<<<grid, kThreads, smem_a, stream>>>(a, depth);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = a.P * a.N;
  state_pass_kernel<<<dim3((PN + 8 * kThreads - 1) / (8 * kThreads), a.NH, Bsz), kThreads, 0,
                      stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<grid, kScanThreads, smem_c, stream>>>(a, depth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dt(int dt_dtype, const ScanArgs& a, int Bsz, int depth,
                        cudaStream_t stream) {
  if (dt_dtype == 0) return launch<T, float>(a, Bsz, depth, stream);
  if (dt_dtype == 1) return launch<T, __nv_bfloat16>(a, Bsz, depth, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C and y) and dt_dtype: 0 = float32, 1 = bfloat16. A is
// f32 [NH]; strides are in elements. Rows of x (P values) and of B and C
// (N values) must be whole 16-byte units at 16-byte aligned addresses (the
// wrapper checks). `states` is an f32 workspace of Bsz x chunks x NH x P x
// N values and `totals` of Bsz x chunks x NH, chunks = ceil(S / kL) (kL:
// 128 in bf16, 64 in f32). `group` heads share a block of (a) and of (c)
// (and its C B^T); `depth` heads' tiles are in flight in a block. Three launches on `stream`; returns the
// first failure's cudaError_t (0 on success).
extern "C" int repro_ssd_scan(const void* x, long long x_sb, long long x_st, const void* dt,
                              long long dt_sb, long long dt_st, long long dt_sh, const void* A,
                              const void* Bm, long long b_sb, long long b_st, const void* Cm,
                              long long c_sb, long long c_st, void* y, void* h_out,
                              void* states, void* totals, int Bsz, int S, int NH, int P, int N,
                              int depth, int group, int dtype, int dt_dtype, void* stream) {
  const int L = dtype == 1 ? Chunk<__nv_bfloat16>::kL : Chunk<float>::kL;
  if (Bsz < 1 || S < 1 || NH < 1 || P < 4 || P % 4 != 0 || P > kMaxHead || N < 4 ||
      N % 4 != 0 || N > kMaxState || depth < 1 || group < 1 || (dtype != 0 && dtype != 1) ||
      Bsz > 65535 || (S + L - 1) / L > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs a{x, x_sb, x_st, dt, dt_sb, dt_st, dt_sh, static_cast<const float*>(A), Bm, b_sb,
             b_st, Cm, c_sb, c_st, y, static_cast<float*>(h_out),
             static_cast<float*>(states), static_cast<float*>(totals), S, NH, P, N,
             (S + L - 1) / L, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_dt<float>(dt_dtype, a, Bsz, depth, s));
  return static_cast<int>(dispatch_dt<__nv_bfloat16>(dt_dtype, a, Bsz, depth, s));
}
