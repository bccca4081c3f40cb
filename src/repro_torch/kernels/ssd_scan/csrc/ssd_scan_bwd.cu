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
//   dC_i  = sum_j (sum_h dS_ij) B_j + sum_h exp(cs_i) dy_i H
//   dB_j  = sum_i (sum_h dS_ij) C_i + sum_h w_j x_j G
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
//   (a) bwd_state_kernel, a block per (sequence, chunk, group of heads): B
//       and C once, then per head the chunk's own state S_c = sum_j w_j x_j
//       B_j^T and D_c = sum_i exp(cs_i) dy_i C_i^T into two f32 workspaces
//       [b, chunks, nh, P, N], and total;
//   (b) bwd_pass_kernel, per (sequence, head, pass, 8 values of the
//       state): the only sequential part, the passes along the chunks: the
//       first workspace becomes the state entering each chunk (forwards),
//       the second the gradient of the state leaving it (backwards from
//       dh_final), each stored as its bf16 high and low parts (bf16 path);
//   (c) bwd_chunk_kernel, a block per (sequence, chunk, group of heads): C
//       B^T once, then per head dx, ddt and the head's dA term, with dS and
//       the heads' inter-chunk dB and dC terms summed in registers over the
//       group; dS meets B and C once, at the end, and the group's dB and dC
//       go to its f32 partial (no atomics);
//   (d) bwd_reduce_kernel: dB and dC, the sum of the groups' partials in
//       group order, rounded once to x's type; dA, the sum of its terms in
//       (sequence, chunk) order. The result is the same from run to run.
// No exponent of a positive argument is taken: exp(cs_i - cs_j) only for
// j <= i; exp(total - cs_j), exp(cs_i) and exp(total) are all of
// non-positive arguments.
//
// What bounds it: at the training shapes the function is bound by its bytes
// in bf16 (~43 MB at mamba2's, against ~9.0 GFLOP of causal products) and
// by its operations in f32. The chunk-parallel decomposition adds the f32
// workspace of the chunk states (~100 MB at mamba2's: written by (a), read
// and rewritten by (b), read by (c)). What the design does:
//   * every bf16 product runs on tensor cores (mma.sync m16n8k16, f32
//     accumulators, operands by ldmatrix from shared memory): C B^T, dy x^T,
//     M^T dy, dS B, dS^T C, and the products with the [P, N] states (S_c,
//     D_c, G B, dy H, x G). x, dy, B and C are exact in bf16 and go in as
//     they are; an operand that carries an f32 factor (M, dS, x w,
//     exp(cs) dy, the states H and G) is split into a bf16 high part and a
//     bf16 low part, two products, so it keeps ~16 bits. The f32 path runs
//     the same phases on f32 tiles with f32 FMA products on CUDA cores,
//     computed in the mma fragment's layout so that every epilogue is
//     shared (16 bits are not enough there: ddt sums terms ~100x its
//     smaller values);
//   * C B^T does not depend on the head: in (c) each warp computes its
//     16 x 16 block of it once and keeps it in registers for every head of
//     the group; per head only the decay exp(cs_i - cs_j) is applied. dS is
//     summed over the group in the same registers and meets B and C once a
//     block, not once a head; the inter-chunk terms of dB and dC are summed
//     in registers too, so a head writes no partial;
//   * x, dy, B and C stay in shared memory in their input type (bf16: 2
//     bytes), and the pass stores the states already split (bf16 path), so
//     (c) copies them as they are used; each block keeps `depth` heads'
//     tiles (x, dy, dt and, in (c), H and G) in flight in a ring of
//     shared-memory slots filled by cp.async (the shared coro_ring.cuh), the
//     copies of head k + depth overlapping the products of head k, and
//     starts the tiles of the head after into L2; `depth` is solved by the
//     host from ssd_bwd_spec and clamped to shared memory (at mamba2's
//     widths one slot of ~88 KB fits beside B, C and the scores; (a), whose
//     slots are small, takes its own group and depth: `launch`);
//   * the per-head vectors (the cumsum and its exponents) and the gradient
//     of cs (its two 64-row scans, ddt, the head's dA term) are one warp's
//     work with shuffles, two rows a lane, so a head in (c) takes five
//     block barriers;
//   * (b) runs each pass in threads of its own and issues the loads of
//     kAhead chunks (and their decays) before it stores any, so its ~190 MB
//     at mamba2's shape stream instead of waiting one load latency a chunk;
//   * rows past the sequence and padding columns are zeros in shared
//     memory (dt 0 there), so the last chunk needs no masked products.
// What bounds it now (scripts/ssd_scan_bwd_breakdown.py): (c)'s per-head
// phases are short and latency bound at one 512-thread block an SM (its
// registers), so its barriers and epilogues, not its products, take most
// of its time; its reads of the states are the workspace's DRAM round trip.
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
using bf16 = __nv_bfloat16;

constexpr int kL = 64;              // rows of the backward's chunk
constexpr int kRB = kL / 16;        // its 16-row blocks
constexpr int kThreads = 512;       // (a) and (c): 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;   // (b) and (d)
constexpr int kAhead = 8;           // chunks (b) loads before it stores
constexpr int kMaxState = 128;      // N
constexpr int kMaxHead = 128;       // P
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use (sm_90)
constexpr size_t kSmemPair = 233472 / 2 - 1024;  // each of two blocks on an SM (less its 1 KB)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kWarps == kRB * kRB, "(c): one 16 x 16 block of the scores a warp");

// f32 vectors of (c), in units of kL floats: cs (log2
// units), exp(cs), exp(total - cs), w, dt, R's diagonal; then three
// partials of 8 x kL each (R's row and column sums, x . (G B), C . (dy H))
// and a scratch of kL.
constexpr int kVecRows = 6;
constexpr int kVecFloats = (kVecRows + 24 + 1) * kL;

// Shared-memory layout of (a) and (c), the same on the host and in the
// kernels (and in repro_torch/kernels/ssd_scan/ssd_scan.py:_bwd_layout).
// Tiles are row-major in the input type, P and N padded to 16 with zeros,
// rows longer than that so that ldmatrix (bf16: 8 elements) and the f32
// fragment loads (f32: 4) meet no bank conflict. A split operand (bf16
// path) is its high part [rows][stride] and then its low part; an f32
// one takes the same 4 bytes a value. Sizes in bytes.
struct Layout {
  int Pp, Np, xs, bs, hs, ss;
  size_t x, bc, st, sc, dtw, vec;
  __host__ __device__ Layout(bool f32, int P, int N) {
    Pp = round16(P);
    Np = round16(N);
    const int pad = f32 ? 4 : 8, esz = f32 ? 4 : 2;
    xs = Pp + pad;   // x, dy rows
    bs = Np + pad;   // B, C rows
    hs = Np + pad;   // state rows
    ss = kL + pad;   // score rows
    x = static_cast<size_t>(kL) * xs * esz;   // an x or dy tile
    bc = static_cast<size_t>(kL) * bs * esz;  // a B or C tile
    st = static_cast<size_t>(Pp) * hs * 4;    // a state (bf16: both parts)
    sc = static_cast<size_t>(kL) * ss * 4;    // the scores (bf16: both parts)
    dtw = kL * 4;                             // dt, a 4-byte word a row
    vec = kVecFloats * 4;
  }
  // (a): B, C, x w and dy exp(cs) (bf16: high and low parts), w and
  // exp(cs); a slot: x, dy, dt
  __host__ __device__ size_t fixed_a() const { return 2 * bc + 2 * (kL * xs * 4) + 2 * kL * 4; }
  __host__ __device__ size_t slot_a() const { return 2 * x + dtw; }
  // (c): B, C, the scores (M, then the group's dS), vectors; a slot: x,
  // dy, H and G, dt
  __host__ __device__ size_t fixed_c() const { return 2 * bc + sc + vec; }
  __host__ __device__ size_t slot_c() const { return 2 * x + 2 * st + dtw; }
};

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
  float* states;       // [b, chunks, NH, P, N]: S_c after (a), H (split) after (b)
  float* dstates;      // [b, chunks, NH, P, N]: D_c after (a), G (split) after (b)
  float* totals;       // [b, chunks, NH]
  float* dA_part;      // [b, chunks, NH]
  float* dB_part;      // [groups, b, S, N]
  float* dC_part;      // [groups, b, S, N]
  int Bsz, S, NH, P, N, chunks, group, groups;
};

// Where a block of (a) or (c) is: its sequence b, chunk c (rows t0 .. t0 +
// valid), and heads h0 .. h0 + nheads.
struct Place {
  int b, c, grp, h0, nheads, t0, valid;
  __device__ Place(const BwdArgs& a, int group) {
    grp = blockIdx.x;
    h0 = grp * group;
    nheads = min(group, a.NH - h0);
    c = blockIdx.y;
    b = blockIdx.z;
    t0 = c * kL;
    valid = min(kL, a.S - t0);
  }
  __device__ size_t state(const BwdArgs& a, int head) const {
    return ((static_cast<size_t>(b) * a.chunks + c) * a.NH + head) * a.P * a.N;
  }
};

// One warp's inclusive scan of the chunk's kL = 64 rows, two a lane: rows
// lane and lane + 32 in v0 and v1; `rev` scans from the last row back (each
// row's sum of itself and the rows after it).
__device__ __forceinline__ void scan64(float* v0, float* v1, bool rev) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o0 = rev ? __shfl_down_sync(0xffffffffu, *v0, off) : __shfl_up_sync(0xffffffffu, *v0, off);
    const float o1 = rev ? __shfl_down_sync(0xffffffffu, *v1, off) : __shfl_up_sync(0xffffffffu, *v1, off);
    if (rev ? lane + off < 32 : lane >= off) {
      *v0 += o0;
      *v1 += o1;
    }
  }
  if (rev)
    *v0 += __shfl_sync(0xffffffffu, *v1, 0);
  else
    *v1 += __shfl_sync(0xffffffffu, *v0, 31);
}

// Warp 0 of a block: the dt of rows lane and lane + 32 (0 past `valid`)
// and cs = cumsum(dt a) there; returns total (cs at the last row).
template <typename TD>
__device__ __forceinline__ float warp_cs(const uint32_t* dtw, const TD* dtg, int64_t dt_st,
                                         int valid, float av, float* d, float* cs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    d[h] = r < valid ? DtUnit<TD>::read(dtw + r, dtg + r * dt_st) : 0.f;
    cs[h] = d[h] * av;
  }
  scan64(&cs[0], &cs[1], false);
  return __shfl_sync(0xffffffffu, cs[1], 31);
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

// A shared operand of element type E: its values (bf16: the high part)
// and, for a split bf16 operand, its low part (null: exact in bf16; always
// null in f32), row stride `ld` in elements.
template <typename E>
struct Op {
  const E* hi;
  const E* lo;
  int ld;
  __device__ float at(int r, int c) const {
    const float v = repro::to_f32(hi[r * ld + c]);
    return lo ? v + repro::to_f32(lo[r * ld + c]) : v;
  }
};

// The A fragment of rows r0.. and depth k0.. (kTrans: stored [k][r]).
template <bool kTrans>
__device__ __forceinline__ void load_a(uint32_t* f, const bf16* p, int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
  if constexpr (kTrans)
    ldsm_x4_trans(f, p + (k0 + r8 + (q >> 1) * 8) * ld + r0 + (q & 1) * 8);
  else
    ldsm_x4(f, p + (r0 + r8 + (q & 1) * 8) * ld + k0 + (q >> 1) * 8);
}

// The B fragments of depth k0.. and columns c0 .. c0 + 16, two 8-column
// tiles: f[0..1] and f[2..3] (kTrans: stored [k][c]; else [c][k]).
template <bool kTrans>
__device__ __forceinline__ void load_b(uint32_t* f, const bf16* p, int ld, int c0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
  if constexpr (kTrans)
    ldsm_x4_trans(f, p + (k0 + r8 + (q & 1) * 8) * ld + c0 + (q >> 1) * 8);
  else
    ldsm_x4(f, p + (c0 + r8 + (q >> 1) * 8) * ld + k0 + (q & 1) * 8);
}

// acc (a 16 x 16 tile: rows r0.., columns c0.., two 8-column tiles) +=
// A[r0.., k] B[k, c0..] over k in [k0, k1) (multiples of 16), one warp. A
// thread holds acc[t][e] at row r0 + g + 8 (e / 2), column c0 + 8 t +
// 2 tig + e % 2 (g = lane / 4, tig = lane % 4), the layout of mma.sync's
// accumulators. bf16: on tensor cores, the high parts' product and the low
// part of each split operand against the other's high part.
template <bool kTransA, bool kTransB>
__device__ __forceinline__ void mma_tile(float (*acc)[4], const Op<bf16>& A, const Op<bf16>& B,
                                         int r0, int c0, int k0, int k1) {
  for (int k = k0; k < k1; k += 16) {
    uint32_t af[4], bf[4];
    load_a<kTransA>(af, A.hi, A.ld, r0, k);
    load_b<kTransB>(bf, B.hi, B.ld, c0, k);
    mma(acc[0], af, bf[0], bf[1]);
    mma(acc[1], af, bf[2], bf[3]);
    if (A.lo) {
      uint32_t al[4];
      load_a<kTransA>(al, A.lo, A.ld, r0, k);
      mma(acc[0], al, bf[0], bf[1]);
      mma(acc[1], al, bf[2], bf[3]);
    }
    if (B.lo) {
      uint32_t bl[4];
      load_b<kTransB>(bl, B.lo, B.ld, c0, k);
      mma(acc[0], af, bl[0], bl[1]);
      mma(acc[1], af, bl[2], bl[3]);
    }
  }
}

// f32: the same tile with f32 FMA on CUDA cores, four k a step (16-byte
// loads where a row runs along k, 8-byte ones where it runs along the
// columns).
template <bool kTransA, bool kTransB>
__device__ __forceinline__ void mma_tile(float (*acc)[4], const Op<float>& A, const Op<float>& B,
                                         int r0, int c0, int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ra = r0 + g, cA = c0 + 2 * tig;
  for (int k = k0; k < k1; k += 4) {
    float a[2][4], b[4][4];  // a[row half][u] = A(ra + 8 half, k + u); b[col][u]
    if constexpr (kTransA) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[0][u] = A.hi[(k + u) * A.ld + ra];
        a[1][u] = A.hi[(k + u) * A.ld + ra + 8];
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(A.hi + (ra + 8 * h) * A.ld + k);
        a[h][0] = v.x; a[h][1] = v.y; a[h][2] = v.z; a[h][3] = v.w;
      }
    }
    if constexpr (kTransB) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float2 v = *reinterpret_cast<const float2*>(B.hi + (k + u) * B.ld + cA + 8 * t);
          b[2 * t][u] = v.x;
          b[2 * t + 1][u] = v.y;
        }
    } else {
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        const float4 v =
            *reinterpret_cast<const float4*>(B.hi + (cA + 8 * (col >> 1) + (col & 1)) * B.ld + k);
        b[col][0] = v.x; b[col][1] = v.y; b[col][2] = v.z; b[col][3] = v.w;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][e] = fmaf(a[e >> 1][u], b[2 * t + (e & 1)][u], acc[t][e]);
  }
}

// Store a pair of values (columns c, c + 1 of row r) of a score tile: bf16
// as high and low parts (the low part `lo_off` elements after), f32 as is.
__device__ __forceinline__ void store_pair(bf16* tile, int lo_off, int idx, float u, float v) {
  split(u, v, reinterpret_cast<uint32_t*>(tile + idx), reinterpret_cast<uint32_t*>(tile + lo_off + idx));
}
__device__ __forceinline__ void store_pair(float* tile, int, int idx, float u, float v) {
  *reinterpret_cast<float2*>(tile + idx) = make_float2(u, v);
}

// Sum of v over the 4 lanes of a quad (same g) or the 8 quads (same tig).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Sum of G * H over the kV values of a state row at element offset o:
// bf16, 8 values (their high and low parts), f32 4.
__device__ __forceinline__ float dot_state(const Op<float>& G, const Op<float>& H, int o) {
  const float4 gv = *reinterpret_cast<const float4*>(G.hi + o);
  const float4 hv = *reinterpret_cast<const float4*>(H.hi + o);
  return fmaf(gv.x, hv.x, fmaf(gv.y, hv.y, fmaf(gv.z, hv.z, gv.w * hv.w)));
}
__device__ __forceinline__ float dot_state(const Op<bf16>& G, const Op<bf16>& H, int o) {
  const uint4 v[4] = {*reinterpret_cast<const uint4*>(G.hi + o), *reinterpret_cast<const uint4*>(G.lo + o),
                      *reinterpret_cast<const uint4*>(H.hi + o), *reinterpret_cast<const uint4*>(H.lo + o)};
  const __nv_bfloat162* q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 gh = __bfloat1622float2(q[0][i]), gl = __bfloat1622float2(q[1][i]);
    const float2 hh = __bfloat1622float2(q[2][i]), hl = __bfloat1622float2(q[3][i]);
    s = fmaf(gh.x + gl.x, hh.x + hl.x, s);
    s = fmaf(gh.y + gl.y, hh.y + hl.y, s);
  }
  return s;
}

// (a) S_c = sum_j w_j x_j B_j^T and D_c = sum_i exp(cs_i) dy_i C_i^T of each
// head of the block's group, and total. S of the last chunk and D of the
// first are never read, and are not computed.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads, 2) bwd_state_kernel(const BwdArgs a, int group,
                                                                int depth) {
  constexpr bool kF32 = sizeof(T) == 4;
  const Place at(a, group);
  const Layout m(kF32, a.P, a.N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int P = a.P, N = a.N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bt = reinterpret_cast<T*>(smem);
  T* ct = reinterpret_cast<T*>(smem + m.bc);
  // x w and dy exp(cs), [kL][xs] each (bf16: high part, then low part)
  T* xw = reinterpret_cast<T*>(smem + 2 * m.bc);
  T* yw = reinterpret_cast<T*>(smem + 2 * m.bc + kL * m.xs * 4);
  float* w_s = reinterpret_cast<float*>(smem + 2 * m.bc + 2 * kL * m.xs * 4);
  float* ecs_s = w_s + kL;
  unsigned char* ring = smem + m.fixed_a();
  auto x_slot = [&](int s) { return reinterpret_cast<T*>(ring + s * m.slot_a()); };
  auto dy_slot = [&](int s) { return reinterpret_cast<T*>(ring + s * m.slot_a() + m.x); };
  auto dt_slot = [&](int s) { return reinterpret_cast<uint32_t*>(ring + s * m.slot_a() + 2 * m.x); };
  const int64_t dy_st = static_cast<int64_t>(a.NH) * P;

  const T* xg = static_cast<const T*>(a.x) + at.b * a.x_sb + at.t0 * a.x_st;
  const T* dyg = static_cast<const T*>(a.dy) + (static_cast<int64_t>(at.b) * a.S + at.t0) * dy_st;
  const TD* dtg = static_cast<const TD*>(a.dt) + at.b * a.dt_sb + at.t0 * a.dt_st;
  auto issue = [&](int k, int slot) {
    if (k >= at.nheads) return;
    const int head = at.h0 + k;
    copy_rows<kThreads>(x_slot(slot), m.xs, xg + head * P, a.x_st, at.valid, P);
    copy_rows<kThreads>(dy_slot(slot), m.xs, dyg + head * P, dy_st, at.valid, P);
    uint32_t* dw = dt_slot(slot);
    for (int r = tid; r < at.valid; r += kThreads)
      DtUnit<TD>::load(dw + r, dtg + head * a.dt_sh + r * a.dt_st);
  };

  zero_pad<kThreads>(bt, kL, m.bs, at.valid, N);
  zero_pad<kThreads>(ct, kL, m.bs, at.valid, N);
  for (int s = 0; s < depth; ++s) {
    zero_pad<kThreads>(x_slot(s), kL, m.xs, at.valid, P);
    zero_pad<kThreads>(dy_slot(s), kL, m.xs, at.valid, P);
  }
  copy_rows<kThreads>(bt, m.bs, static_cast<const T*>(a.B) + at.b * a.b_sb + at.t0 * a.b_st,
                      a.b_st, at.valid, N);
  copy_rows<kThreads>(ct, m.bs, static_cast<const T*>(a.C) + at.b * a.c_sb + at.t0 * a.c_st,
                      a.c_st, at.valid, N);
  for (int s = 0; s < depth; ++s) {
    issue(s, s);
    cp_async_commit();  // group 0 also holds B and C
  }
  const Op<T> Bop{bt, nullptr, m.bs};
  const Op<T> Cop{ct, nullptr, m.bs};
  const Op<T> Xw{xw, kF32 ? nullptr : xw + kL * m.xs, m.xs};
  const Op<T> Yw{yw, kF32 ? nullptr : yw + kL * m.xs, m.xs};
  const bool want_s = at.c + 1 < a.chunks, want_d = at.c > 0;

  for (int k = 0; k < at.nheads; ++k) {
    const int slot = k % depth;
    const int head = at.h0 + k;
    if (k + depth < at.nheads) {  // the head this slot takes next, into L2
      prefetch_rows<kThreads>(xg + (head + depth) * P, a.x_st, at.valid, P);
      prefetch_rows<kThreads>(dyg + (head + depth) * P, dy_st, at.valid, P);
    }
    cp_async_wait_pending(depth - 1);
    __syncthreads();
    if (warp == 0) {  // the head's vectors, two rows a lane
      float d[2], cs[2];
      const float total = warp_cs(dt_slot(slot), dtg + head * a.dt_sh, a.dt_st, at.valid,
                                  a.A[head], d, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w_s[lane + 32 * h] = expf(total - cs[h]) * d[h];
        ecs_s[lane + 32 * h] = expf(cs[h]);
      }
      if (lane == 0) a.totals[(static_cast<size_t>(at.b) * a.chunks + at.c) * a.NH + head] = total;
    }
    __syncthreads();
    // x w and dy exp(cs), zeros past the rows and columns of the data
    const T* xr = x_slot(slot);
    const T* yr = dy_slot(slot);
    for (int e = tid; e < kL * (m.Pp / 2); e += kThreads) {
      const int j = e / (m.Pp / 2), p = 2 * (e - j * (m.Pp / 2)), o = j * m.xs + p;
      const float wj = w_s[j], ej = ecs_s[j];
      store_pair(xw, kL * m.xs, o, repro::to_f32(xr[o]) * wj, repro::to_f32(xr[o + 1]) * wj);
      store_pair(yw, kL * m.xs, o, repro::to_f32(yr[o]) * ej, repro::to_f32(yr[o + 1]) * ej);
    }
    __syncthreads();
    // S [Pp x Np] = (x w)^T [Pp x kL] B [kL x Np], D likewise with dy and
    // C: a warp takes one 16 x 16 tile of one of them at a time
    const int mt_n = m.Pp / 16, nt_n = m.Np / 16, per = mt_n * nt_n;
    for (int u = warp; u < 2 * per; u += kWarps) {
      const bool is_d = u >= per;
      if (is_d ? !want_d : !want_s) continue;
      const int v = is_d ? u - per : u, mt = v % mt_n, np = v / mt_n;
      float acc[2][4] = {};
      mma_tile<true, true>(acc, is_d ? Yw : Xw, is_d ? Cop : Bop, mt * 16, np * 16, 0, kL);
      float* out = (is_d ? a.dstates : a.states) + at.state(a, head);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int n = np * 16 + t * 8 + 2 * tig;
        if (n >= N) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = mt * 16 + g + hf * 8;
          if (p < P)
            *reinterpret_cast<float2*>(out + p * N + n) = make_float2(acc[t][2 * hf], acc[t][2 * hf + 1]);
        }
      }
    }
    __syncthreads();  // the slot and the scaled tiles are free
    issue(k + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// 8 values of a state over the 32 bytes they took in f32: bf16 path, their
// high parts (16 bytes) and then their low parts (16 bytes); f32, as they
// are.
template <bool kSplit>
__device__ __forceinline__ void store8(float* dst, const float4* v) {
  if constexpr (kSplit) {
    uint32_t h[4], l[4];
    split(v[0].x, v[0].y, &h[0], &l[0]);
    split(v[0].z, v[0].w, &h[1], &l[1]);
    split(v[1].x, v[1].y, &h[2], &l[2]);
    split(v[1].z, v[1].w, &h[3], &l[3]);
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(h[0], h[1], h[2], h[3]);
    d[1] = make_uint4(l[0], l[1], l[2], l[3]);
  } else {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = v[0];
    d[1] = v[1];
  }
}

__device__ __forceinline__ void fma8(float4* h, float d, const float4* c) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
    h[k] = make_float4(fmaf(h[k].x, d, c[k].x), fmaf(h[k].y, d, c[k].y),
                       fmaf(h[k].z, d, c[k].z), fmaf(h[k].w, d, c[k].w));
}

// (b) Along the chunks of one (sequence, head), 8 values of the state a
// thread, one pass a thread (even blocks forwards, odd backwards):
// forwards, H_c = H_{c-1} exp(total_{c-1}) + S_{c-1} (H_0 = 0) over the
// first workspace; backwards, G_{c-1} = G_c exp(total_c) + D_c (G_last =
// dh_final) over the second. Each stores its chunk's value in place
// (store8). The loads of kAhead chunks, and their decays, are issued
// before any of their stores.
template <bool kSplit>
__global__ void __launch_bounds__(kPassThreads) bwd_pass_kernel(const BwdArgs a) {
  const bool back = blockIdx.x & 1;
  const int head = blockIdx.y, b = blockIdx.z;
  const int PN = a.P * a.N, C = a.chunks;
  const int e0 = ((blockIdx.x >> 1) * kPassThreads + threadIdx.x) * 8;
  if (e0 >= PN) return;  // PN is a multiple of 64: a thread's 8 all exist
  const size_t step = static_cast<size_t>(a.NH) * PN;
  float* __restrict__ sp =
      (back ? a.dstates : a.states) + (static_cast<size_t>(b) * C * a.NH + head) * PN + e0;
  const float* __restrict__ tot = a.totals + static_cast<size_t>(b) * C * a.NH + head;
  float4 h[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  if (back && a.dh) {
    const float4* d = reinterpret_cast<const float4*>(a.dh + (static_cast<size_t>(b) * a.NH + head) * PN + e0);
    h[0] = d[0];
    h[1] = d[1];
  }
  for (int t0 = 0; t0 < C; t0 += kAhead) {
    // step t: chunk t forwards, C - 1 - t backwards
    float4 v[kAhead][2];
    float f[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u, c = back ? C - 1 - t : t;
      if (t + 1 < C) {  // S_c (c < C - 1) or D_c (c > 0)
        const float4* s = reinterpret_cast<const float4*>(sp + c * step);
        v[u][0] = s[0];
        v[u][1] = s[1];
        f[u] = tot[static_cast<size_t>(c) * a.NH];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u, c = back ? C - 1 - t : t;
      if (t >= C) break;
      store8<kSplit>(sp + c * step, h);
      if (t + 1 < C) fma8(h, expf(f[u]), v[u]);
    }
  }
}

// (c) Every gradient of one chunk for the heads of the block's group.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads) bwd_chunk_kernel(const BwdArgs a, int depth) {
  constexpr bool kF32 = sizeof(T) == 4;
  const Place at(a, a.group);
  const Layout m(kF32, a.P, a.N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int P = a.P, N = a.N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bt = reinterpret_cast<T*>(smem);
  T* ct = reinterpret_cast<T*>(smem + m.bc);
  T* sm = reinterpret_cast<T*>(smem + 2 * m.bc);  // M, then the group's dS (bf16: high, low)
  float* vec = reinterpret_cast<float*>(smem + 2 * m.bc + m.sc);
  float* cs2_s = vec;            // cs in log2 units
  float* ecs_s = vec + kL;       // exp(cs)
  float* e2_s = vec + 2 * kL;    // exp(total - cs)
  float* w_s = vec + 3 * kL;     // exp(total - cs) dt
  float* dt_s = vec + 4 * kL;
  float* rdiag_s = vec + 5 * kL; // R_jj
  float* part_a = vec + kVecRows * kL;  // [kRB][kL] row sums of R, [kRB][kL] column sums
  float* part_b = part_a + 8 * kL;      // [Np/16][kL] of C . (dy H)
  float* part_c = part_b + 8 * kL;      // [Pp/16][kL] of x . (G B)
  float* scratch = part_c + 8 * kL;
  unsigned char* ring = smem + m.fixed_c();
  auto slot_at = [&](int s) { return ring + s * m.slot_c(); };
  auto x_slot = [&](int s) { return reinterpret_cast<T*>(slot_at(s)); };
  auto dy_slot = [&](int s) { return reinterpret_cast<T*>(slot_at(s) + m.x); };
  auto h_slot = [&](int s) { return reinterpret_cast<T*>(slot_at(s) + 2 * m.x); };
  auto g_slot = [&](int s) { return reinterpret_cast<T*>(slot_at(s) + 2 * m.x + m.st); };
  auto dt_slot = [&](int s) {
    return reinterpret_cast<uint32_t*>(slot_at(s) + 2 * m.x + 2 * m.st);
  };
  const int64_t dy_st = static_cast<int64_t>(a.NH) * P;
  const T* xg = static_cast<const T*>(a.x) + at.b * a.x_sb + at.t0 * a.x_st;
  const T* dyg = static_cast<const T*>(a.dy) + (static_cast<int64_t>(at.b) * a.S + at.t0) * dy_st;
  const TD* dtg = static_cast<const TD*>(a.dt) + at.b * a.dt_sb + at.t0 * a.dt_st;
  const bool inter = at.c > 0;  // chunk 0 enters from a zero state
  // a state into its slot: f32 rows as they are; bf16 rows in groups of 8
  // values, 16 bytes of high parts then 16 of low parts (store8), into the
  // high and low tiles
  auto copy_state = [&](T* dst, const float* src) {
    if constexpr (kF32) {
      copy_rows<kThreads>(dst, m.hs, src, N, P, N);
    } else {
      const int units = N / 8;
      for (int e = tid; e < P * units; e += kThreads) {
        const int p = e / units, n = 8 * (e - p * units);
        repro::cp_async16(dst + p * m.hs + n, src + p * N + n);
        repro::cp_async16(dst + m.Pp * m.hs + p * m.hs + n, src + p * N + n + 4);
      }
    }
  };
  auto issue = [&](int k, int slot) {
    if (k >= at.nheads) return;
    const int head = at.h0 + k;
    copy_rows<kThreads>(x_slot(slot), m.xs, xg + head * P, a.x_st, at.valid, P);
    copy_rows<kThreads>(dy_slot(slot), m.xs, dyg + head * P, dy_st, at.valid, P);
    const size_t st = at.state(a, head);
    copy_state(g_slot(slot), a.dstates + st);
    if (inter) copy_state(h_slot(slot), a.states + st);
    uint32_t* dw = dt_slot(slot);
    for (int r = tid; r < at.valid; r += kThreads)
      DtUnit<TD>::load(dw + r, dtg + head * a.dt_sh + r * a.dt_st);
  };

  zero_pad<kThreads>(bt, kL, m.bs, at.valid, N);
  zero_pad<kThreads>(ct, kL, m.bs, at.valid, N);
  for (int s = 0; s < depth; ++s) {
    zero_pad<kThreads>(x_slot(s), kL, m.xs, at.valid, P);
    zero_pad<kThreads>(dy_slot(s), kL, m.xs, at.valid, P);
    for (int part = 0; part < (kF32 ? 1 : 2); ++part) {
      zero_pad<kThreads>(h_slot(s) + part * m.Pp * m.hs, m.Pp, m.hs, P, N);
      zero_pad<kThreads>(g_slot(s) + part * m.Pp * m.hs, m.Pp, m.hs, P, N);
    }
  }
  copy_rows<kThreads>(bt, m.bs, static_cast<const T*>(a.B) + at.b * a.b_sb + at.t0 * a.b_st,
                      a.b_st, at.valid, N);
  copy_rows<kThreads>(ct, m.bs, static_cast<const T*>(a.C) + at.b * a.c_sb + at.t0 * a.c_st,
                      a.c_st, at.valid, N);
  for (int s = 0; s < depth; ++s) {
    issue(s, s);
    cp_async_commit();  // group 0 also holds B and C
  }
  cp_async_wait_pending(depth - 1);
  __syncthreads();
  const Op<T> Bop{bt, nullptr, m.bs};
  const Op<T> Cop{ct, nullptr, m.bs};
  const Op<T> Sop{sm, kF32 ? nullptr : sm + kL * m.ss, m.ss};

  // warp w's block of the scores: rows rb, columns kb (on or below the
  // diagonal for 10 of the 16 warps). C B^T there, once for the group
  const int rb = warp / kRB, kb = warp % kRB;
  const bool lower = kb <= rb;
  float cb[2][4] = {}, dsum[2][4] = {};
  if (lower) mma_tile<false, false>(cb, Cop, Bop, rb * 16, kb * 16, 0, m.Np);

  // the warp's units of dC and dB [kL x Np] (16 x 16: row block, column
  // pair), warp and warp + kWarps, summed over the group in registers
  const int np_n = m.Np / 16, units = kRB * np_n, px = m.Pp / 16;
  float dct[2][2][4] = {}, dbt[2][2][4] = {};

  for (int k = 0; k < at.nheads; ++k) {
    const int slot = k % depth;
    const int head = at.h0 + k;
    if (k + depth < at.nheads) {  // the head this slot takes next, into L2
      prefetch_rows<kThreads>(xg + (head + depth) * P, a.x_st, at.valid, P);
      prefetch_rows<kThreads>(dyg + (head + depth) * P, dy_st, at.valid, P);
      if (tid == 0) {
        const size_t st = at.state(a, head + depth);
        const uint32_t bytes = static_cast<uint32_t>(P) * N * 4;
        bulk_prefetch_l2(a.dstates + st, bytes);
        if (inter) bulk_prefetch_l2(a.states + st, bytes);
      }
    }
    if (k > 0) {
      cp_async_wait_pending(depth - 1);
      __syncthreads();
    }
    const Op<T> Xop{x_slot(slot), nullptr, m.xs};
    const Op<T> Yop{dy_slot(slot), nullptr, m.xs};
    const Op<T> Hop{h_slot(slot), kF32 ? nullptr : h_slot(slot) + m.Pp * m.hs, m.hs};
    const Op<T> Gop{g_slot(slot), kF32 ? nullptr : g_slot(slot) + m.Pp * m.hs, m.hs};
    const float av = a.A[head];
    if (warp == 0) {  // the head's vectors, two rows a lane
      float d[2], cs[2];
      const float total = warp_cs(dt_slot(slot), dtg + head * a.dt_sh, a.dt_st, at.valid, av, d, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        cs2_s[r] = cs[h] * kLog2e;  // exp(cs_i - cs_j) = exp2(cs2_i - cs2_j)
        ecs_s[r] = expf(cs[h]);
        e2_s[r] = expf(total - cs[h]);
        w_s[r] = e2_s[r] * d[h];
        dt_s[r] = d[h];
      }
      if (lane == 0) scratch[32] = total;
    }
    __syncthreads();
    const float total = scratch[32];

    // dM = dy x^T on the warp's block, then M (to shared memory), dS (into
    // the group's sum) and R's row, column and diagonal sums
    if (lower) {
      float dm[2][4] = {};
      mma_tile<false, false>(dm, Yop, Xop, rb * 16, kb * 16, 0, m.Pp);
      float rsum[2] = {0.f, 0.f}, csum[2][2] = {};
      float mv[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rb * 16 + g + 8 * (e >> 1), j = kb * 16 + t * 8 + 2 * tig + (e & 1);
          float mval = 0.f, rv = 0.f;
          if (j <= i) {
            const float ex = exp2_neg(cs2_s[i] - cs2_s[j]);
            const float se = cb[t][e] * ex;
            mval = se * dt_s[j];
            dsum[t][e] = fmaf(dm[t][e] * ex, dt_s[j], dsum[t][e]);
            rv = dm[t][e] * se;
          }
          mv[t][e] = mval;
          if (j < i) {
            rsum[e >> 1] = fmaf(rv, dt_s[j], rsum[e >> 1]);
            csum[t][e & 1] += rv;
          } else if (j == i) {
            rdiag_s[i] = rv;
          }
        }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_pair(sm, kL * m.ss, (rb * 16 + g + 8 * hf) * m.ss + kb * 16 + t * 8 + 2 * tig,
                     mv[t][2 * hf], mv[t][2 * hf + 1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s = quad_sum(rsum[hf]);
        if (tig == 0) part_a[kb * kL + rb * 16 + g + 8 * hf] = s;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const float s = column_sum(csum[t][o]);
          if (g == 0) part_a[(kRB + rb) * kL + kb * 16 + t * 8 + 2 * tig + o] = s;
        }
    }
    __syncthreads();

    // dx [kL x Pp] (row block jb, column pair cp): M^T dy over the rows
    // i >= j, and w_j G B_j; and the partial sums of x_j . (G B_j)
    {
      T* dxg = static_cast<T*>(a.dx) + (static_cast<int64_t>(at.b) * a.S + at.t0) * dy_st + head * P;
      for (int u = warp; u < kRB * px; u += kWarps) {
        const int jb = u / px, cp = u - jb * px;
        float in[2][4] = {}, gb[2][4] = {};
        mma_tile<true, true>(in, Sop, Yop, jb * 16, cp * 16, jb * 16, kL);
        mma_tile<false, false>(gb, Bop, Gop, jb * 16, cp * 16, 0, m.Np);
        float dwp[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = jb * 16 + g + 8 * hf, p = cp * 16 + t * 8 + 2 * tig;
            const float v0 = fmaf(w_s[j], gb[t][2 * hf], in[t][2 * hf]);
            const float v1 = fmaf(w_s[j], gb[t][2 * hf + 1], in[t][2 * hf + 1]);
            dwp[hf] = fmaf(Xop.at(j, p), gb[t][2 * hf], dwp[hf]);
            dwp[hf] = fmaf(Xop.at(j, p + 1), gb[t][2 * hf + 1], dwp[hf]);
            if (j < at.valid && p < P) {
              if constexpr (kF32)
                *reinterpret_cast<float2*>(dxg + j * dy_st + p) = make_float2(v0, v1);
              else
                *reinterpret_cast<__nv_bfloat162*>(dxg + j * dy_st + p) = __floats2bfloat162_rn(v0, v1);
            }
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float s = quad_sum(dwp[hf]);
          if (tig == 0) part_c[cp * kL + jb * 16 + g + 8 * hf] = s;
        }
      }
    }

    // the inter-chunk terms of dC (exp(cs_i) dy_i H) and dB (w_j x_j G) on
    // the warp's units, and the partial sums of C_i . (dy_i H)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int u = warp + t * kWarps;
      if (u >= units) continue;
      const int ib = u / np_n, np = u - ib * np_n;
      if (inter) {
        float yhv[2][4] = {};
        mma_tile<false, true>(yhv, Yop, Hop, ib * 16, np * 16, 0, m.Pp);
        float dcp[2] = {0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ib * 16 + g + 8 * (e >> 1), n = np * 16 + s * 8 + 2 * tig + (e & 1);
            dct[t][s][e] = fmaf(ecs_s[i], yhv[s][e], dct[t][s][e]);
            dcp[e >> 1] = fmaf(Cop.at(i, n), yhv[s][e], dcp[e >> 1]);
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float s = quad_sum(dcp[hf]);
          if (tig == 0) part_b[np * kL + ib * 16 + g + 8 * hf] = s;
        }
      }
      float xgv[2][4] = {};
      mma_tile<false, true>(xgv, Xop, Gop, ib * 16, np * 16, 0, m.Pp);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = ib * 16 + g + 8 * (e >> 1);
          dbt[t][s][e] = fmaf(w_s[j], xgv[s][e], dbt[t][s][e]);
        }
    }

    // <G, H> (H is 0 entering the first chunk), 8 (bf16) or 4 (f32) values
    // of a row a step
    float gh = 0.f;
    if (inter) {
      constexpr int kV = kF32 ? 4 : 8;
      const int units = N / kV;
      for (int e = tid; e < P * units; e += kThreads) {
        const int p = e / units, o = p * m.hs + kV * (e - p * units);
        gh += dot_state(Gop, Hop, o);
      }
    }
    const float egh = expf(total) * block_sum(gh, scratch);  // its barriers end the products
    issue(k + depth, slot);  // the slot is free
    cp_async_commit();

    // warp 0, two rows a lane: rc_k = sum_{i >= k} dcs_i + sum_{j < k} w_j
    // dw_j + exp(total) <G, H>, ddt and the head's dA term (the other warps
    // go on to the next head's copies)
    if (warp == 0) {
      float colr[2], dw[2], dcs[2], wdw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h, blk = r / 16;
        float rowq = 0.f, cr = 0.f, dwv = 0.f, dci = 0.f;
        for (int q = 0; q <= blk; ++q) rowq += part_a[q * kL + r];
        for (int q = blk; q < kRB; ++q) cr += part_a[(kRB + q) * kL + r];
        for (int q = 0; q < px; ++q) dwv += part_c[q * kL + r];
        if (inter)
          for (int q = 0; q < np_n; ++q) dci += part_b[q * kL + r];
        colr[h] = cr;
        dw[h] = dwv;
        dcs[h] = rowq - dt_s[r] * cr + ecs_s[r] * dci;
        wdw[h] = w_s[r] * dwv;
      }
      // the rows before k of w dw: a scan of w dw shifted down a row
      float pre[2] = {__shfl_up_sync(0xffffffffu, wdw[0], 1),
                      __shfl_up_sync(0xffffffffu, wdw[1], 1)};
      const float last0 = __shfl_sync(0xffffffffu, wdw[0], 31);
      if (lane == 0) {
        pre[0] = 0.f;
        pre[1] = last0;
      }
      scan64(&pre[0], &pre[1], false);
      scan64(&dcs[0], &dcs[1], true);
      float da = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        const float rc = dcs[h] + pre[h] + egh;
        if (r < at.valid)
          a.ddt[(static_cast<size_t>(at.b) * a.S + at.t0 + r) * a.NH + head] =
              colr[h] + rdiag_s[r] + e2_s[r] * dw[h] + av * rc;
        da = fmaf(dt_s[r], rc, da);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0) a.dA_part[(static_cast<size_t>(at.b) * a.chunks + at.c) * a.NH + head] = da;
    }
  }
  cp_async_wait<0>();

  // the group's dS (0 above the diagonal) meets B and C once
  if (lower)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_pair(sm, kL * m.ss, (rb * 16 + g + 8 * hf) * m.ss + kb * 16 + t * 8 + 2 * tig,
                   dsum[t][2 * hf], dsum[t][2 * hf + 1]);
  __syncthreads();
  const size_t prow = (static_cast<size_t>(at.grp) * a.Bsz + at.b) * a.S + at.t0;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int u = warp + t * kWarps;
    if (u >= units) continue;
    const int ib = u / np_n, np = u - ib * np_n;
    // dC_i += sum_{j <= i} dS_ij B_j; dB_j += sum_{i >= j} dS_ij C_i (ib is
    // the row block of i for dC and of j for dB)
    mma_tile<false, true>(dct[t], Sop, Bop, ib * 16, np * 16, 0, (ib + 1) * 16);
    mma_tile<true, true>(dbt[t], Sop, Cop, ib * 16, np * 16, ib * 16, kL);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int n = np * 16 + s * 8 + 2 * tig;
      if (n >= N) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = ib * 16 + g + 8 * hf;
        if (i >= at.valid) continue;
        *reinterpret_cast<float2*>(a.dC_part + (prow + i) * N + n) =
            make_float2(dct[t][s][2 * hf], dct[t][s][2 * hf + 1]);
        *reinterpret_cast<float2*>(a.dB_part + (prow + i) * N + n) =
            make_float2(dbt[t][s][2 * hf], dbt[t][s][2 * hf + 1]);
      }
    }
  }
}

// (d) dB and dC: the groups' partials summed in group order, rounded once;
// the last block: dA, its terms summed in (sequence, chunk) order.
template <typename T>
__global__ void __launch_bounds__(kPassThreads) bwd_reduce_kernel(const BwdArgs a) {
  const size_t E = static_cast<size_t>(a.Bsz) * a.S * a.N;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < a.NH; h += kPassThreads) {
      float s = 0.f;
      for (int r = 0; r < a.Bsz * a.chunks; ++r) s += a.dA_part[static_cast<size_t>(r) * a.NH + h];
      a.dA[h] = s;
    }
    return;
  }
  const size_t e = static_cast<size_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (e >= 2 * E) return;
  const bool dc = e >= E;
  const size_t i = dc ? e - E : e;
  const float* part = dc ? a.dC_part : a.dB_part;
  float s = 0.f;
  for (int g = 0; g < a.groups; ++g) s += part[static_cast<size_t>(g) * E + i];
  static_cast<T*>(dc ? a.dC : a.dB)[i] = repro::from_f32<T>(s);
}

// (a)'s heads are independent (it sums nothing over them): it takes the
// smallest group of heads that fills the card once, at two blocks an SM
// where two fit (its registers are bounded for it), and keeps every head of
// it in flight that its shared memory holds, no fewer than (c)'s depth. Its
// result does not depend on the group.
inline int state_group(const BwdArgs& a, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return a.group;
  const long long slots = static_cast<long long>(sms) * per_sm;
  int best = a.group;
  long long best_cost = -1;
  for (int g = 1; g <= a.NH; ++g) {  // the fewest waves times heads a block, the largest on a tie
    const long long blocks = static_cast<long long>(a.Bsz) * a.chunks * ((a.NH + g - 1) / g);
    const long long cost = (blocks + slots - 1) / slots * g;
    if (best_cost < 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, typename TD>
cudaError_t launch(const BwdArgs& a, int depth, cudaStream_t stream) {
  const Layout m(sizeof(T) == 4, a.P, a.N);
  const bool pair = m.fixed_a() + m.slot_a() <= kSmemPair;  // two blocks of (a) an SM
  const int group_a = state_group(a, pair ? 2 : 1);
  const int fit_a = static_cast<int>(((pair ? kSmemPair : kSmemLimit) - m.fixed_a()) / m.slot_a());
  const int depth_a = max(depth, min(min(group_a, repro::kMaxDepth), fit_a));
  const size_t smem_a = m.fixed_a() + depth_a * m.slot_a();
  const size_t smem_c = m.fixed_c() + depth * m.slot_c();
  auto ka = bwd_state_kernel<T, TD>;
  auto kc = bwd_chunk_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_a));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_c));
  if (err != cudaSuccess) return err;
  ka<<<dim3((a.NH + group_a - 1) / group_a, a.chunks, a.Bsz), kThreads, smem_a, stream>>>(
      a, group_a, depth_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = a.P * a.N;
  bwd_pass_kernel<sizeof(T) == 2><<<dim3(2 * ((PN / 8 + kPassThreads - 1) / kPassThreads), a.NH,
                                         a.Bsz),
                                    kPassThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<dim3(a.groups, a.chunks, a.Bsz), kThreads, smem_c, stream>>>(a, depth);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t E2 = 2 * static_cast<size_t>(a.Bsz) * a.S * a.N;
  bwd_reduce_kernel<T><<<static_cast<unsigned>((E2 + kPassThreads - 1) / kPassThreads + 1),
                         kPassThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dt(int dt_dtype, const BwdArgs& a, int depth, cudaStream_t stream) {
  if (dt_dtype == 0) return launch<T, float>(a, depth, stream);
  if (dt_dtype == 1) return launch<T, bf16>(a, depth, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C, dy, dx, dB and dC) and dt_dtype: 0 = float32,
// 1 = bfloat16. A is f32 [NH]; strides are in elements; dy is contiguous
// [Bsz, S, NH, P]; dh is f32 [Bsz, NH, P, N] or null (zero), 16-byte
// aligned. ddt [Bsz, S, NH] and dA [NH] are f32. Rows of x (P values) and
// of B and C (N values) must be whole 16-byte units at 16-byte aligned
// addresses, P and N multiples of 8 up to 128 (the wrapper checks). The f32
// workspaces: states and dstates of Bsz x chunks x NH x P x N values,
// totals and dA_part of Bsz x chunks x NH, dB_part and dC_part of groups x
// Bsz x S x N, chunks = ceil(S / 64), groups = ceil(NH / group). `depth`
// heads' tiles are in flight in a block of (a) and (c), whose shared memory
// must fit (the wrapper checks). Four launches on `stream`; returns the
// first failure's cudaError_t (0 on success).
extern "C" int repro_ssd_scan_bwd(const void* x, long long x_sb, long long x_st, const void* dt,
                                  long long dt_sb, long long dt_st, long long dt_sh,
                                  const void* A, const void* Bm, long long b_sb, long long b_st,
                                  const void* Cm, long long c_sb, long long c_st, const void* dy,
                                  const void* dh, void* dx, void* ddt, void* dA, void* dB,
                                  void* dC, void* states, void* dstates, void* totals,
                                  void* dA_part, void* dB_part, void* dC_part, int Bsz, int S,
                                  int NH, int P, int N, int group, int depth, int dtype,
                                  int dt_dtype, void* stream) {
  if (Bsz < 1 || S < 1 || NH < 1 || P < 8 || P % 8 != 0 || P > kMaxHead || N < 8 ||
      N % 8 != 0 || N > kMaxState || group < 1 || depth < 1 || depth > repro::kMaxDepth ||
      (dtype != 0 && dtype != 1) || Bsz > 65535 || (S + kL - 1) / kL > 65535 || NH > 65535) {
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
  if (dtype == 0) return static_cast<int>(dispatch_dt<float>(dt_dtype, a, depth, s));
  return static_cast<int>(dispatch_dt<bf16>(dt_dtype, a, depth, s));
}
