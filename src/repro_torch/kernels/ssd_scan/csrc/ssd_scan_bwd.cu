// Backward of the chunked Mamba-2 SSD scan for Hopper (sm_90a).
//
// The TPU reference has no backward kernel: it differentiates its jnp
// ssd_chunked (src/repro/models/ssm.py). This kernel is the backward of
// ssd_scan.cu's function (which replaces src/repro/kernels/ssd_scan/
// ssd_scan.py:ssd_scan), so that a model that runs the forward kernel can
// train on the card. For each sequence b and head h, with a = A[h] < 0, the
// forward (from a zero state) is
//
//   state_t = state_{t-1} * exp(dt_t a) + dt_t x_t B_t^T      ([P, N], f32)
//   y_t     = state_t C_t                                     ([P])
//
// Given dy [b, s, nh, P] and dh_final [b, nh, P, N] (or none), it returns
// dx, dB, dC (in x's type) and ddt, dA (f32), through the chunked
// decomposition (Mamba-2, arXiv:2405.21060 section 6) run backwards, over
// chunks of kL = 64 rows in both types. Within a chunk, cs = cumsum(dt a),
// total = cs at its end, w_j = exp(total - cs_j) dt_j, H the state entering
// the chunk and G the gradient of the state leaving it:
//
//   M_ij  = (C_i . B_j) exp(cs_i - cs_j) dt_j  (j <= i),  dM_ij = dy_i . x_j
//   dS_ij = dM_ij exp(cs_i - cs_j) dt_j,  R_ij = dM_ij (C_i . B_j) exp(cs_i - cs_j)
//   dx_j  = sum_i M_ij dy_i + w_j G B_j
//   dC_i  = sum_j dS_ij B_j + exp(cs_i) dy_i H          (summed over heads)
//   dB_j  = sum_i dS_ij C_i + w_j x_j G                 (summed over heads)
//   rc_k  = sum_{i >= k} (sum_{j < i} R_ij dt_j - dt_i sum_{l > i} R_li
//                         + exp(cs_i) C_i . (dy_i H))
//           + sum_{j < k} w_j x_j . (G B_j) + exp(total) <G, H>
//   ddt_j = sum_i R_ij + exp(total - cs_j) x_j . (G B_j) + a rc_j,
//   dA    = sum over (b, chunks, j) of dt_j rc_j
//
// and, along the chunks, G_{c-1} = G_c exp(total_c) + sum_i exp(cs_i) dy_i C_i^T
// from G_last = dh_final. rc_k is the gradient of cs summed back over the
// rows i >= k (the cumsum's backward); the diagonal's R_kk dt_k, which
// enters the gradient of cs_k once with each sign, and the w_j x_j . (G B_j)
// of the chunk-state terms, which enter it with a minus at row j and a plus
// at the last row, are left out of the sums they would cancel in (in f32,
// under a strong decay, that cancellation cost dA ~0.3%). Four launches,
// one call:
//   (a) bwd_state_kernel, a block per (sequence, chunk, head): the chunk's
//       own state S_c = sum_j w_j x_j B_j^T and D_c = sum_i exp(cs_i) dy_i C_i^T
//       into two f32 workspaces [b, chunks, nh, P, N], and total;
//   (b) bwd_pass_kernel, per (sequence, head, slice of the state): the only
//       sequential part, both passes along the chunks: the first workspace
//       becomes the state entering each chunk (forwards), the second the
//       gradient of the state leaving it (backwards from dh_final);
//   (c) bwd_chunk_kernel, a block per (sequence, chunk, group of `group`
//       heads): B and C once, then each head of the group in turn: dx,
//       ddt and the head's dA term written out, its dB and dC added into
//       the group's f32 partials (each element by the one thread that owns
//       it, in head order: no atomics);
//   (d) bwd_reduce_kernel: dB and dC, the sum of the groups' partials in
//       group order, rounded once to x's type; dA, the sum of its terms in
//       (sequence, chunk) order. The result is the same from run to run.
// No exponent of a positive argument is taken: exp(cs_i - cs_j) only for
// j <= i; exp(total - cs_j), exp(cs_i) and exp(total) are all of
// non-positive arguments.
//
// What bounds it: at the training shapes the function is bound by its bytes
// in bf16 (~43 MB at mamba2's, against ~9.0 GFLOP of causal products), and
// by its operations in f32. This first design is simple: every product runs
// in f32 on CUDA cores (register tiles of 4 x 4 over shared memory; bf16
// operands are widened once on load, so dx, dB and dC are rounded once from
// f32 sums), so it is bound by its f32 operations and shared-memory reads,
// at one or two blocks an SM (the tiles of (c) take ~220 KB at mamba2's
// widths). Tensor cores (as the forward's mma.sync with bf16 high and low
// parts) are the next step.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kL = 64;            // rows of the backward's chunk
constexpr int kThreads = 256;     // every launch; (c)'s kL x kL pass is 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr int kMaxState = 128;    // N
constexpr int kMaxHead = 128;     // P
static_assert(kL == 64 && kThreads == 256, "(c)'s kL x kL pass maps 16 x 16 threads");

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dot4(float4 u, float4 v) {
  return fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, u.w * v.w)));
}

// Shared-memory layout of (c), in floats, the same on the host and in the
// kernel (and in repro_torch/kernels/ssd_scan/ssd_scan.py:bwd_smem_bytes):
// row-major f32 tiles whose rows are 4 values longer than their width, so
// that rows 1 apart start 4 banks apart.
struct BwdSmem {
  int xs, ns, ls;
  size_t x, dy, b, c, h, g, m, ds, r, vec, floats;
  __host__ __device__ BwdSmem(int P, int N) {
    xs = P + 4;
    ns = N + 4;
    ls = kL + 4;
    x = 0;                                           // x [kL][xs]
    dy = x + static_cast<size_t>(kL) * xs;           // dy [kL][xs]
    b = dy + static_cast<size_t>(kL) * xs;           // B [kL][ns]
    c = b + static_cast<size_t>(kL) * ns;            // C [kL][ns]
    h = c + static_cast<size_t>(kL) * ns;            // H [P][ns]
    g = h + static_cast<size_t>(P) * ns;             // G [P][ns]
    m = g + static_cast<size_t>(P) * ns;             // M [kL][ls]
    ds = m + static_cast<size_t>(kL) * ls;           // dS [kL][ls]
    r = ds + static_cast<size_t>(kL) * ls;           // R [kL][ls], then row partials
    vec = r + static_cast<size_t>(kL) * ls;          // 13 vectors of kL, scratch
    floats = vec + 13 * kL + 40;
  }
};

// (a)'s shared memory in floats: x w and dy exp(cs) [kL][P], B and C
// [kL][N], w and exp(cs), scratch.
__host__ __device__ inline size_t state_floats(int P, int N) {
  return 2 * static_cast<size_t>(kL) * (P + N) + 2 * kL + 40;
}

// The operands of one call. Strides in elements.
struct BwdArgs {
  const void* x;
  int64_t x_sb, x_st;
  const void* dt;
  int64_t dt_sb, dt_st, dt_sh;
  const float* A;
  const void* B;
  int64_t b_sb, b_st;
  const void* C;
  int64_t c_sb, c_st;
  const void* dy;      // [b, S, NH, P], x's type, contiguous
  const float* dh;     // [b, NH, P, N] or null (zero)
  void* dx;            // [b, S, NH, P], x's type
  float* ddt;          // [b, S, NH]
  float* dA;           // [NH]
  void* dB;            // [b, S, N], x's type
  void* dC;
  float* states;       // [b, chunks, NH, P, N]: S_c after (a), H after (b)
  float* dstates;      // [b, chunks, NH, P, N]: D_c after (a), G after (b)
  float* totals;       // [b, chunks, NH]
  float* dA_part;      // [b, chunks, NH]
  float* dB_part;      // [groups, b, S, N]
  float* dC_part;      // [groups, b, S, N]
  int Bsz, S, NH, P, N, chunks, group, groups;
};

// Inclusive cumsum over the chunk's rows: row r's value on thread r (r < kL,
// anything on later threads); returns thread tid's sum. Every thread calls it.
__device__ __forceinline__ float chunk_cumsum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31 && warp < kL / 32) scratch[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp && w < kL / 32; ++w) base += scratch[w];
  __syncthreads();  // scratch is free again
  return v + base;
}

// Rows [0, rows) of `cols` values from global memory (row stride `gs`) into
// an f32 tile (row stride `ds`), rows at or past `valid` as zeros.
template <typename E>
__device__ __forceinline__ void load_rows(float* dst, int ds, const E* src, int64_t gs, int valid,
                                          int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ds + c] = r < valid ? to_f32(src[r * gs + c]) : 0.f;
  }
}

// The dt of row tid (0 past the sequence and for threads past the chunk).
template <typename TD>
__device__ __forceinline__ float row_dt(const BwdArgs& a, int b, int t0, int head, int valid) {
  const int r = threadIdx.x;
  if (r >= valid) return 0.f;
  const TD* g = static_cast<const TD*>(a.dt) + b * a.dt_sb + (t0 + r) * a.dt_st + head * a.dt_sh;
  return to_f32(*g);
}

// (a) S_c = sum_j w_j x_j B_j^T and D_c = sum_i exp(cs_i) dy_i C_i^T of one
// head, and total.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads) bwd_state_kernel(const BwdArgs a) {
  const int head = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kL, valid = min(kL, a.S - t0);
  const int P = a.P, N = a.N, tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* xw = smem;                 // x_j w_j [kL][P]
  float* dyw = xw + kL * P;         // dy_i exp(cs_i) [kL][P]
  float* bt = dyw + kL * P;         // B [kL][N]
  float* ct = bt + kL * N;          // C [kL][N]
  float* w_s = ct + kL * N;         // w [kL]
  float* ecs_s = w_s + kL;          // exp(cs) [kL]
  float* scratch = ecs_s + kL;      // 40

  load_rows(bt, N, static_cast<const T*>(a.B) + b * a.b_sb + t0 * a.b_st, a.b_st, valid, kL, N);
  load_rows(ct, N, static_cast<const T*>(a.C) + b * a.c_sb + t0 * a.c_st, a.c_st, valid, kL, N);
  const float d = row_dt<TD>(a, b, t0, head, valid);
  const float cs = chunk_cumsum(d * a.A[head], scratch);
  if (tid == kL - 1) scratch[32] = cs;
  __syncthreads();
  const float total = scratch[32];
  if (tid < kL) {
    w_s[tid] = expf(total - cs) * d;
    ecs_s[tid] = expf(cs);
  }
  if (tid == 0) a.totals[(static_cast<size_t>(b) * a.chunks + c) * a.NH + head] = total;
  __syncthreads();
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + t0 * a.x_st + head * P;
  const T* dyg = static_cast<const T*>(a.dy) + (static_cast<int64_t>(b) * a.S + t0) * a.NH * P +
                 head * P;
  const int64_t dy_st = static_cast<int64_t>(a.NH) * P;
  for (int e = tid; e < kL * P; e += kThreads) {
    const int r = e / P, p = e - r * P;
    xw[e] = r < valid ? to_f32(xg[r * a.x_st + p]) * w_s[r] : 0.f;
    dyw[e] = r < valid ? to_f32(dyg[r * dy_st + p]) * ecs_s[r] : 0.f;
  }
  __syncthreads();

  // [P][N] in 4 x 4 register tiles (rows p0.., columns n0..), both sums
  const size_t at = ((static_cast<size_t>(b) * a.chunks + c) * a.NH + head) * P * N;
  const int n4 = N / 4;
  for (int t = tid; t < (P / 4) * n4; t += kThreads) {
    const int p0 = (t / n4) * 4, n0 = (t - (t / n4) * n4) * 4;
    float s[4][4] = {}, g[4][4] = {};
    for (int j = 0; j < valid; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xw + j * P + p0);
      const float4 yv = *reinterpret_cast<const float4*>(dyw + j * P + p0);
      const float4 bv = *reinterpret_cast<const float4*>(bt + j * N + n0);
      const float4 cv = *reinterpret_cast<const float4*>(ct + j * N + n0);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w}, yr[4] = {yv.x, yv.y, yv.z, yv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w}, cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          s[u][v] = fmaf(xr[u], br[v], s[u][v]);
          g[u][v] = fmaf(yr[u], cr[v], g[u][v]);
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t o = at + static_cast<size_t>(p0 + u) * N + n0;
      *reinterpret_cast<float4*>(a.states + o) = make_float4(s[u][0], s[u][1], s[u][2], s[u][3]);
      *reinterpret_cast<float4*>(a.dstates + o) = make_float4(g[u][0], g[u][1], g[u][2], g[u][3]);
    }
  }
}

__device__ __forceinline__ float4 fma4(float4 h, float d, float4 c) {
  return make_float4(fmaf(h.x, d, c.x), fmaf(h.y, d, c.y), fmaf(h.z, d, c.z), fmaf(h.w, d, c.w));
}

// (b) Along the chunks of one (sequence, head), 4 values of the state a
// thread: forwards, H_c = H_{c-1} exp(total_{c-1}) + S_{c-1} (H_0 = 0) over
// the first workspace; backwards, G_{c-1} = G_c exp(total_c) + D_c
// (G_last = dh_final) over the second.
__global__ void __launch_bounds__(kThreads) bwd_pass_kernel(const BwdArgs a) {
  const int head = blockIdx.y, b = blockIdx.z;
  const int PN = a.P * a.N;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e0 >= PN) return;  // PN is a multiple of 16: a thread's 4 all exist
  const size_t step = static_cast<size_t>(a.NH) * PN;
  const size_t base = (static_cast<size_t>(b) * a.chunks * a.NH + head) * PN + e0;
  const float* tot = a.totals + static_cast<size_t>(b) * a.chunks * a.NH + head;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < a.chunks; ++c) {
    float4* sp = reinterpret_cast<float4*>(a.states + base + c * step);
    const float4 cur = *sp;
    *sp = h;
    h = fma4(h, expf(tot[static_cast<size_t>(c) * a.NH]), cur);
  }
  float4 g = a.dh ? *reinterpret_cast<const float4*>(
                        a.dh + (static_cast<size_t>(b) * a.NH + head) * PN + e0)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = a.chunks - 1; c >= 0; --c) {
    float4* dp = reinterpret_cast<float4*>(a.dstates + base + c * step);
    const float4 d = *dp;
    *dp = g;
    g = fma4(g, expf(tot[static_cast<size_t>(c) * a.NH]), d);
  }
}

// The sum over a block of one value a thread (fixed order), on every thread.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  __syncthreads();  // scratch is free again
  return s;
}

// (c) Every gradient of one chunk for the heads of the block's group.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads) bwd_chunk_kernel(const BwdArgs a) {
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * a.group, nheads = min(a.group, a.NH - h0);
  const int t0 = c * kL, valid = min(kL, a.S - t0);
  const int P = a.P, N = a.N, tid = threadIdx.x;
  const BwdSmem m(P, N);
  const int xs = m.xs, ns = m.ns, ls = m.ls;
  extern __shared__ __align__(16) float smem[];
  float* xt = smem + m.x;
  float* dyt = smem + m.dy;
  float* bt = smem + m.b;
  float* ct = smem + m.c;
  float* hm = smem + m.h;
  float* gm = smem + m.g;
  float* mm = smem + m.m;
  float* dsm = smem + m.ds;
  float* rr = smem + m.r;
  float* part = rr;  // row partials, once R's sums are taken
  float* dt_s = smem + m.vec;
  float* cs_s = dt_s + kL;
  float* ecs_s = cs_s + kL;   // exp(cs)
  float* e2_s = ecs_s + kL;   // exp(total - cs)
  float* w_s = e2_s + kL;     // exp(total - cs) dt
  float* rowq_s = w_s + kL;   // sum_{j < i} R_ij dt_j
  float* colr_s = rowq_s + kL;  // sum_{i > j} R_ij
  float* rdiag_s = colr_s + kL;  // R_jj
  float* dw_s = rdiag_s + kL;  // x_j . (G B_j)
  float* dci_s = dw_s + kL;   // exp(cs_i) C_i . (dy_i H)
  float* dcs_s = dci_s + kL;
  float* rc_s = dcs_s + kL;
  float* tmp_s = rc_s + kL;
  float* scratch = tmp_s + kL;  // 40

  load_rows(bt, ns, static_cast<const T*>(a.B) + b * a.b_sb + t0 * a.b_st, a.b_st, valid, kL, N);
  load_rows(ct, ns, static_cast<const T*>(a.C) + b * a.c_sb + t0 * a.c_st, a.c_st, valid, kL, N);
  // this block's rows of its group's dB and dC partials
  const size_t prow = (static_cast<size_t>(grp) * a.Bsz + b) * a.S + t0;
  const int64_t dy_st = static_cast<int64_t>(a.NH) * P;

  for (int k = 0; k < nheads; ++k) {
    const int head = h0 + k;
    const size_t st = ((static_cast<size_t>(b) * a.chunks + c) * a.NH + head) * P * N;
    const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + t0 * a.x_st + head * P;
    const T* dyg = static_cast<const T*>(a.dy) + (static_cast<int64_t>(b) * a.S + t0) * dy_st +
                   head * P;
    load_rows(xt, xs, xg, a.x_st, valid, kL, P);
    load_rows(dyt, xs, dyg, dy_st, valid, kL, P);
    load_rows(hm, ns, a.states + st, N, P, P, N);
    load_rows(gm, ns, a.dstates + st, N, P, P, N);
    const float av = a.A[head];
    const float d = row_dt<TD>(a, b, t0, head, valid);
    const float cs = chunk_cumsum(d * av, scratch);
    if (tid == kL - 1) scratch[32] = cs;
    __syncthreads();
    const float total = scratch[32];
    if (tid < kL) {
      dt_s[tid] = d;
      cs_s[tid] = cs;
      ecs_s[tid] = expf(cs);
      e2_s[tid] = expf(total - cs);
      w_s[tid] = e2_s[tid] * d;
    }
    __syncthreads();

    // M, dS and R over the kL x kL pairs: thread (it, jt) takes rows
    // it + 16u and columns jt + 16v (consecutive threads, consecutive rows
    // of B and x: no bank conflict), 0 above the diagonal
    {
      const int it = tid >> 4, jt = tid & 15;
      float sa[4][4] = {}, ma[4][4] = {};
      for (int q = 0; q < N; q += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = *reinterpret_cast<const float4*>(ct + (it + 16 * u) * ns + q);
          bv[u] = *reinterpret_cast<const float4*>(bt + (jt + 16 * u) * ns + q);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) sa[u][v] += dot4(cv[u], bv[v]);
      }
      for (int q = 0; q < P; q += 4) {
        float4 yv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          yv[u] = *reinterpret_cast<const float4*>(dyt + (it + 16 * u) * xs + q);
          xv[u] = *reinterpret_cast<const float4*>(xt + (jt + 16 * u) * xs + q);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) ma[u][v] += dot4(yv[u], xv[v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = it + 16 * u, j = jt + 16 * v;
          float mv = 0.f, dv = 0.f, rv = 0.f;
          if (j <= i) {
            const float e = expf(cs_s[i] - cs_s[j]);
            const float se = sa[u][v] * e;
            mv = se * dt_s[j];
            dv = ma[u][v] * e * dt_s[j];
            rv = ma[u][v] * se;
          }
          mm[i * ls + j] = mv;
          dsm[i * ls + j] = dv;
          rr[i * ls + j] = rv;
        }
    }
    __syncthreads();
    if (tid < kL) {
      float s = 0.f;
      for (int j = 0; j < tid; ++j) s = fmaf(rr[tid * ls + j], dt_s[j], s);
      rowq_s[tid] = s;
      rdiag_s[tid] = rr[tid * ls + tid];
    } else if (tid < 2 * kL) {
      const int j = tid - kL;
      float s = 0.f;
      for (int i = j + 1; i < kL; ++i) s += rr[i * ls + j];
      colr_s[j] = s;
    }
    __syncthreads();

    // dx [kL][P]: rows j0.., columns pt + p4 v; and x_j . (G B_j)
    {
      const int p4 = P / 4;
      T* dxg = static_cast<T*>(a.dx) + (static_cast<int64_t>(b) * a.S + t0) * dy_st + head * P;
      for (int t = tid; t < (kL / 4) * p4; t += kThreads) {
        const int j0 = (t / p4) * 4, pt = t - (t / p4) * p4;
        float acc[4][4] = {}, gb[4][4] = {};
        for (int i = j0; i < kL; ++i) {  // M_ij = 0 for i < j
          const float4 mv = *reinterpret_cast<const float4*>(mm + i * ls + j0);
          const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
          float dr[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) dr[v] = dyt[i * xs + pt + p4 * v];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(mr[u], dr[v], acc[u][v]);
        }
        for (int q = 0; q < N; q += 4) {
          float4 bv[4], gv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            bv[u] = *reinterpret_cast<const float4*>(bt + (j0 + u) * ns + q);
            gv[u] = *reinterpret_cast<const float4*>(gm + (pt + p4 * u) * ns + q);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) gb[u][v] += dot4(bv[u], gv[v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          float dwp = 0.f;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int p = pt + p4 * v;
            dwp = fmaf(xt[j * xs + p], gb[u][v], dwp);
            if (j < valid) dxg[j * dy_st + p] = from_f32<T>(fmaf(w_s[j], gb[u][v], acc[u][v]));
          }
          part[j * p4 + pt] = dwp;
        }
      }
      __syncthreads();
      if (tid < kL) {
        float s = 0.f;
        for (int q = 0; q < p4; ++q) s += part[tid * p4 + q];
        dw_s[tid] = s;
      }
      __syncthreads();
    }

    // dC [kL][N] (this head's share, into the group's partial), and
    // exp(cs_i) C_i . (dy_i H)
    const int n4 = N / 4;
    for (int t = tid; t < (kL / 4) * n4; t += kThreads) {
      const int i0 = (t / n4) * 4, n0 = (t - (t / n4) * n4) * 4;
      float acc[4][4] = {}, yh[4][4] = {};
      for (int j = 0; j < i0 + 4; ++j) {  // dS_ij = 0 for j > i
        const float4 bv = *reinterpret_cast<const float4*>(bt + j * ns + n0);
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float s = dsm[(i0 + u) * ls + j];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(s, br[v], acc[u][v]);
        }
      }
      for (int p = 0; p < P; ++p) {
        const float4 hv = *reinterpret_cast<const float4*>(hm + p * ns + n0);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float y = dyt[(i0 + u) * xs + p];
#pragma unroll
          for (int v = 0; v < 4; ++v) yh[u][v] = fmaf(y, hr[v], yh[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        const float e = ecs_s[i];
        const float4 cv = *reinterpret_cast<const float4*>(ct + i * ns + n0);
        part[i * n4 + n0 / 4] = dot4(cv, make_float4(yh[u][0], yh[u][1], yh[u][2], yh[u][3]));
        if (i < valid) {
          float4* dst = reinterpret_cast<float4*>(a.dC_part + (prow + i) * N + n0);
          float4 v = k ? *dst : make_float4(0.f, 0.f, 0.f, 0.f);
          v.x += fmaf(e, yh[u][0], acc[u][0]);
          v.y += fmaf(e, yh[u][1], acc[u][1]);
          v.z += fmaf(e, yh[u][2], acc[u][2]);
          v.w += fmaf(e, yh[u][3], acc[u][3]);
          *dst = v;
        }
      }
    }
    __syncthreads();
    if (tid < kL) {
      float s = 0.f;
      for (int q = 0; q < n4; ++q) s += part[tid * n4 + q];
      dci_s[tid] = ecs_s[tid] * s;
    }

    // dB [kL][N] (this head's share, into the group's partial)
    for (int t = tid; t < (kL / 4) * n4; t += kThreads) {
      const int j0 = (t / n4) * 4, n0 = (t - (t / n4) * n4) * 4;
      float acc[4][4] = {}, xg4[4][4] = {};
      for (int i = j0; i < kL; ++i) {  // dS_ij = 0 for i < j
        const float4 sv = *reinterpret_cast<const float4*>(dsm + i * ls + j0);
        const float4 cv = *reinterpret_cast<const float4*>(ct + i * ns + n0);
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w}, cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(sr[u], cr[v], acc[u][v]);
      }
      for (int p = 0; p < P; ++p) {
        const float4 gv = *reinterpret_cast<const float4*>(gm + p * ns + n0);
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = xt[(j0 + u) * xs + p];
#pragma unroll
          for (int v = 0; v < 4; ++v) xg4[u][v] = fmaf(xv, gr[v], xg4[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        if (j >= valid) continue;
        const float wj = w_s[j];
        float4* dst = reinterpret_cast<float4*>(a.dB_part + (prow + j) * N + n0);
        float4 v = k ? *dst : make_float4(0.f, 0.f, 0.f, 0.f);
        v.x += fmaf(wj, xg4[u][0], acc[u][0]);
        v.y += fmaf(wj, xg4[u][1], acc[u][1]);
        v.z += fmaf(wj, xg4[u][2], acc[u][2]);
        v.w += fmaf(wj, xg4[u][3], acc[u][3]);
        *dst = v;
      }
    }

    // <G, H> (H is 0 entering the first chunk)
    float gh = 0.f;
    if (c > 0)
      for (int e = tid; e < P * N; e += kThreads) {
        const int r = e / N, col = e - r * N;
        gh = fmaf(gm[r * ns + col], hm[r * ns + col], gh);
      }
    const float egh = expf(total) * block_sum(gh, scratch);
    if (tid < kL) dcs_s[tid] = rowq_s[tid] - dt_s[tid] * colr_s[tid] + dci_s[tid];
    __syncthreads();
    // rc_k: thread r sums the rows kL - 1 - r and after of dcs, and then
    // the rows before r of w dw
    const float rcs = chunk_cumsum(tid < kL ? dcs_s[kL - 1 - tid] : 0.f, scratch);
    if (tid < kL) rc_s[kL - 1 - tid] = rcs;
    const float before =
        chunk_cumsum(tid > 0 && tid < kL ? w_s[tid - 1] * dw_s[tid - 1] : 0.f, scratch);
    __syncthreads();
    if (tid < kL) {
      const int j = tid;
      const float rc = rc_s[j] + before + egh;
      if (j < valid)
        a.ddt[(static_cast<size_t>(b) * a.S + t0 + j) * a.NH + head] =
            colr_s[j] + rdiag_s[j] + e2_s[j] * dw_s[j] + av * rc;
      tmp_s[j] = dt_s[j] * rc;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int j = 0; j < kL; ++j) s += tmp_s[j];
      a.dA_part[(static_cast<size_t>(b) * a.chunks + c) * a.NH + head] = s;
    }
    __syncthreads();  // the tiles and vectors are free for the next head
  }
}

// (d) dB and dC: the groups' partials summed in group order, rounded once;
// the last block: dA, its terms summed in (sequence, chunk) order.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_reduce_kernel(const BwdArgs a) {
  const size_t E = static_cast<size_t>(a.Bsz) * a.S * a.N;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < a.NH; h += kThreads) {
      float s = 0.f;
      for (int r = 0; r < a.Bsz * a.chunks; ++r) s += a.dA_part[static_cast<size_t>(r) * a.NH + h];
      a.dA[h] = s;
    }
    return;
  }
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= 2 * E) return;
  const bool dc = e >= E;
  const size_t i = dc ? e - E : e;
  const float* part = dc ? a.dC_part : a.dB_part;
  float s = 0.f;
  for (int g = 0; g < a.groups; ++g) s += part[static_cast<size_t>(g) * E + i];
  static_cast<T*>(dc ? a.dC : a.dB)[i] = from_f32<T>(s);
}

template <typename T, typename TD>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem_a = state_floats(a.P, a.N) * sizeof(float);
  const size_t smem_c = BwdSmem(a.P, a.N).floats * sizeof(float);
  auto ka = bwd_state_kernel<T, TD>;
  auto kc = bwd_chunk_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_a));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_c));
  if (err != cudaSuccess) return err;
  ka<<<dim3(a.NH, a.chunks, a.Bsz), kThreads, smem_a, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = a.P * a.N;
  bwd_pass_kernel<<<dim3((PN + 4 * kThreads - 1) / (4 * kThreads), a.NH, a.Bsz), kThreads, 0,
                    stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<dim3(a.groups, a.chunks, a.Bsz), kThreads, smem_c, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t E2 = 2 * static_cast<size_t>(a.Bsz) * a.S * a.N;
  bwd_reduce_kernel<T><<<static_cast<unsigned>((E2 + kThreads - 1) / kThreads + 1), kThreads, 0,
                         stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dt(int dt_dtype, const BwdArgs& a, cudaStream_t stream) {
  if (dt_dtype == 0) return launch<T, float>(a, stream);
  if (dt_dtype == 1) return launch<T, __nv_bfloat16>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C, dy, dx, dB and dC) and dt_dtype: 0 = float32,
// 1 = bfloat16. A is f32 [NH]; strides are in elements; dy is contiguous
// [Bsz, S, NH, P]; dh is f32 [Bsz, NH, P, N] or null (zero). ddt [Bsz, S,
// NH] and dA [NH] are f32. The f32 workspaces: states and dstates of
// Bsz x chunks x NH x P x N values, totals and dA_part of Bsz x chunks x NH,
// dB_part and dC_part of groups x Bsz x S x N, chunks = ceil(S / 64),
// groups = ceil(NH / group). P and N are multiples of 4, at most 128, and
// (c)'s tiles must fit a block's shared memory (the wrapper checks). Four
// launches on `stream`; returns the first failure's cudaError_t (0 on
// success).
extern "C" int repro_ssd_scan_bwd(const void* x, long long x_sb, long long x_st, const void* dt,
                                  long long dt_sb, long long dt_st, long long dt_sh,
                                  const void* A, const void* Bm, long long b_sb, long long b_st,
                                  const void* Cm, long long c_sb, long long c_st, const void* dy,
                                  const void* dh, void* dx, void* ddt, void* dA, void* dB,
                                  void* dC, void* states, void* dstates, void* totals,
                                  void* dA_part, void* dB_part, void* dC_part, int Bsz, int S,
                                  int NH, int P, int N, int group, int dtype, int dt_dtype,
                                  void* stream) {
  if (Bsz < 1 || S < 1 || NH < 1 || P < 4 || P % 4 != 0 || P > kMaxHead || N < 4 ||
      N % 4 != 0 || N > kMaxState || group < 1 || (dtype != 0 && dtype != 1) || Bsz > 65535 ||
      (S + kL - 1) / kL > 65535 || NH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (NH + group - 1) / group;
  BwdArgs a{x, x_sb, x_st, dt, dt_sb, dt_st, dt_sh, static_cast<const float*>(A), Bm, b_sb,
            b_st, Cm, c_sb, c_st, dy, static_cast<const float*>(dh), dx,
            static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC,
            static_cast<float*>(states), static_cast<float*>(dstates),
            static_cast<float*>(totals), static_cast<float*>(dA_part),
            static_cast<float*>(dB_part), static_cast<float*>(dC_part), Bsz, S, NH, P, N,
            (S + kL - 1) / kL, group, groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_dt<float>(dt_dtype, a, s));
  return static_cast<int>(dispatch_dt<__nv_bfloat16>(dt_dtype, a, s));
}
