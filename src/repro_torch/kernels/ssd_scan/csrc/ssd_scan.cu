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
// computed as the chunked SSD (Mamba-2, Alg. 1): within a tile of kQ rows,
// cs = cumsum(dt a),
//   y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//       + exp(cs_i) state C_i                                     (inter)
//   state <- state exp(cs_last) + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T.
// It returns y in x's type and the final state [b, nh, P, N] in f32.
//
// The result does not depend on the tile length but for rounding, and the
// kernel computes at a tile of kQ = 32 rows, whatever the caller's chunk
// (256 at mamba2's width): a [256, 256] f32 decay matrix alone is 256 KiB,
// over a block's shared memory, and the intra-tile work grows with the tile.
// The exponent is taken only where j <= i, so its argument is never
// positive: the Pallas body's exp(seg) * causal overflows to inf above the
// diagonal once a chunk's decay passes ~88 (inf * 0 = NaN); here nothing
// above the diagonal is exponentiated.
//
// What bounds it: operations. At mamba2's prefill shape the SSD needs ~14
// GFLOP against ~117 MB in and out (the reference spec's flops_per_tile
// over its 256-row chunks), all of it f32 SIMT arithmetic here. What the
// design does about it:
//   * one thread block per (sequence, head) walks the sequence's tiles in
//     order; the [P, N] state stays in shared memory (stored [N][P]) for
//     the whole sequence, nothing crosses between blocks;
//   * each block reads its head's x and dt once, and B and C once per head
//     (nh times in all: 24x at mamba2, 2 x 8 x 2048 x 128 x 2 B x 24 =
//     201 MB of B/C reads at bf16, mostly from L2);
//   * a ring of `depth` tiles (x, dt, B, C of kQ rows) is kept in flight
//     with cp.async (the shared coro_ring.cuh), so the copy of tile
//     i + depth overlaps the math on tile i; `depth` is solved by the host
//     from the reference's CoroSpec and clamped to shared memory;
//   * the per-row products are register-blocked 4 wide over the head dim
//     (16-byte vector loads from shared memory).
// Later work: one block for several heads (B and C read once), tensor-core
// products (wgmma) for C B^T and the state update.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/coro_ring.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::cp_async_wait_pending;
using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 512;  // 16 warps: more loads in flight per SM than 8
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 32;            // rows per tile: one warp lane per row
constexpr int kMaxNPerLane = 4;   // N <= 128

// Shared memory: a ring of `depth` slots (x [kQ][P], B [kQ][N], C [kQ][N]
// in the input type, dt [kQ] as 4-byte words), then f32 state [N][P],
// scores [kQ][kQ] and four [kQ] rows (cs, exp(cs), exp(total - cs) dt, dt).
// The same formulas are repro_torch/kernels/ssd_scan/ssd_scan.py:slot_bytes
// and fixed_bytes.
__host__ __device__ size_t slot_bytes(int P, int N, int itemsize) {
  return static_cast<size_t>(kQ) * (P + 2 * N) * itemsize + kQ * sizeof(uint32_t);
}

__host__ __device__ size_t fixed_bytes(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(N) * P + kQ * kQ + 4 * kQ);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Four consecutive values from shared memory as f32 (16- or 8-byte load).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

// dt of one row: one 4-byte ring word. An f32 value is the word; a bf16
// value is copied with the aligned word that holds it (the shared ring's
// 2-byte unit) and shifted out on read.
template <typename TD>
struct DtUnit;

template <>
struct DtUnit<float> {
  static __device__ __forceinline__ void load(uint32_t* s, const float* g) { cp_async4(s, g); }
  static __device__ __forceinline__ float read(const uint32_t* s, const float*) {
    return __uint_as_float(*s);
  }
};

template <>
struct DtUnit<__nv_bfloat16> {
  using U = repro::Unit<uint16_t>;
  static __device__ __forceinline__ void load(uint32_t* s, const __nv_bfloat16* g) {
    U::load(s, reinterpret_cast<const uint16_t*>(g));
  }
  static __device__ __forceinline__ float read(const uint32_t* s, const __nv_bfloat16* g) {
    return __bfloat162float(__ushort_as_bfloat16(U::read(s, reinterpret_cast<const uint16_t*>(g))));
  }
};

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, int64_t x_sb, int64_t x_st,
                    const TD* __restrict__ dt, int64_t dt_sb, int64_t dt_st, int64_t dt_sh,
                    const float* __restrict__ A, const T* __restrict__ Bm, int64_t b_sb,
                    int64_t b_st, const T* __restrict__ Cm, int64_t c_sb, int64_t c_st,
                    T* __restrict__ y, float* __restrict__ h_out, int S, int NH, int P, int N,
                    int depth) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements per 16 B copy
  const int x_units = P / kChunk;
  const int bc_units = N / kChunk;
  const int P4 = P / 4;
  const size_t sbytes = slot_bytes(P, N, static_cast<int>(sizeof(T)));

  extern __shared__ __align__(16) unsigned char smem[];
  float* hT = reinterpret_cast<float*>(smem + static_cast<size_t>(depth) * sbytes);  // [N][P]
  float* sm = hT + static_cast<size_t>(N) * P;  // [kQ][kQ] decayed, dt-scaled C B^T
  float* cs_s = sm + kQ * kQ;                   // cumsum(dt a) within the tile
  float* ecs_s = cs_s + kQ;                     // exp(cs)
  float* w_s = ecs_s + kQ;                      // exp(total - cs) dt
  float* dt_s = w_s + kQ;                       // dt
  auto x_slot = [&](int slot) {
    return reinterpret_cast<T*>(smem + static_cast<size_t>(slot) * sbytes);
  };
  auto b_slot = [&](int slot) { return x_slot(slot) + kQ * P; };
  auto c_slot = [&](int slot) { return b_slot(slot) + kQ * N; };
  auto dt_slot = [&](int slot) { return reinterpret_cast<uint32_t*>(c_slot(slot) + kQ * N); };

  const float a = A[head];
  const int n_tiles = (S + kQ - 1) / kQ;
  const T* xb = x + b * x_sb + static_cast<int64_t>(head) * P;
  const TD* dtb = dt + b * dt_sb + head * dt_sh;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;

  // Start the copies of tile `tile` into ring slot `slot`: its rows (fewer
  // than kQ at the end of the sequence; rows past S are never read).
  auto issue = [&](int tile, int slot) {
    const int t0 = tile * kQ;
    const int rows = min(kQ, S - t0);
    T* xs = x_slot(slot);
    T* bs = b_slot(slot);
    T* cm = c_slot(slot);
    for (int c = tid; c < rows * x_units; c += kThreads) {
      const int r = c / x_units;
      const int u = (c - r * x_units) * kChunk;
      cp_async16(xs + r * P + u, xb + (t0 + r) * x_st + u);
    }
    for (int c = tid; c < rows * bc_units; c += kThreads) {
      const int r = c / bc_units;
      const int u = (c - r * bc_units) * kChunk;
      cp_async16(bs + r * N + u, bb + (t0 + r) * b_st + u);
      cp_async16(cm + r * N + u, cb + (t0 + r) * c_st + u);
    }
    uint32_t* ds = dt_slot(slot);
    for (int r = tid; r < rows; r += kThreads) DtUnit<TD>::load(ds + r, dtb + (t0 + r) * dt_st);
  };

  for (int e = tid; e < N * P; e += kThreads) hT[e] = 0.f;
  for (int s = 0; s < depth; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % depth;
    const int t0 = i * kQ;
    const int rows = min(kQ, S - t0);
    cp_async_wait_pending(depth - 1);  // tile i has landed (this thread's part)
    __syncthreads();                   // ... and every other thread's part
    const T* xs = x_slot(slot);
    const T* bs = b_slot(slot);
    const T* cm = c_slot(slot);

    // 1. Lane r of warp 0 takes row r: cs = inclusive cumsum of dt a over
    //    the tile (rows past the sequence add 0), and the row factors.
    if (warp == 0) {
      const float d = lane < rows ? DtUnit<TD>::read(dt_slot(slot) + lane, dtb + (t0 + lane) * dt_st)
                                  : 0.f;
      float v = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      const float total = __shfl_sync(0xffffffffu, v, 31);
      cs_s[lane] = v;
      ecs_s[lane] = expf(v);
      w_s[lane] = expf(total - v) * d;
      dt_s[lane] = d;
    }
    __syncthreads();

    // 2. sm[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i: a warp per
    //    row i, lanes over N, one warp reduction per j; lane j keeps it.
    for (int r = warp; r < rows; r += kWarps) {
      float cv[kMaxNPerLane];
#pragma unroll
      for (int k = 0; k < kMaxNPerLane; ++k) {
        const int n = lane + 32 * k;
        cv[k] = n < N ? to_f32(cm[r * N + n]) : 0.f;
      }
      float mine = 0.f;
      for (int j = 0; j <= r; ++j) {
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxNPerLane; ++k) {
          const int n = lane + 32 * k;
          if (n < N) part += cv[k] * to_f32(bs[j * N + n]);
        }
        part = warp_sum(part);
        if (lane == j) mine = part;
      }
      sm[r * kQ + lane] = lane <= r ? mine * expf(cs_s[r] - cs_s[lane]) * dt_s[lane] : 0.f;
    }
    __syncthreads();

    // 3. y[i][p0 .. p0 + 3] = sum_{j <= i} sm[i][j] x_j + exp(cs_i) C_i state.
    for (int e = tid; e < rows * P4; e += kThreads) {
      const int r = e / P4;
      const int p0 = (e - r * P4) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float v[4];
      for (int n = 0; n < N; ++n) {
        const float c = to_f32(cm[r * N + n]);
        load4(hT + n * P + p0, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += c * v[u];
      }
      const float ec = ecs_s[r];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] *= ec;
      for (int j = 0; j <= r; ++j) {
        const float s = sm[r * kQ + j];
        load4(xs + j * P + p0, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += s * v[u];
      }
      T* out = y + ((static_cast<int64_t>(b) * S + t0 + r) * NH + head) * P + p0;
#pragma unroll
      for (int u = 0; u < 4; ++u) out[u] = from_f32<T>(acc[u]);
    }
    __syncthreads();  // every read of the old state is done

    // 4. state[n][p0 .. p0 + 3] = state exp(total) + sum_j B_j[n] w_j x_j.
    const float decay = expf(cs_s[kQ - 1]);
    for (int e = tid; e < N * P4; e += kThreads) {
      const int n = e / P4;
      const int p0 = (e - n * P4) * 4;
      float acc[4], v[4];
      load4(hT + n * P + p0, acc);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] *= decay;
      for (int j = 0; j < rows; ++j) {
        const float bw = to_f32(bs[j * N + n]) * w_s[j];
        load4(xs + j * P + p0, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += bw * v[u];
      }
      *reinterpret_cast<float4*>(hT + n * P + p0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();  // the slot is free and the state is updated

    if (i + depth < n_tiles) issue(i + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The final state, [P][N] per (sequence, head).
  float* ho = h_out + (static_cast<int64_t>(b) * NH + head) * P * N;
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P;
    const int p = e - n * P;
    ho[p * N + n] = hT[e];
  }
}

template <typename T, typename TD>
cudaError_t launch(const void* x, int64_t x_sb, int64_t x_st, const void* dt, int64_t dt_sb,
                   int64_t dt_st, int64_t dt_sh, const void* A, const void* Bm, int64_t b_sb,
                   int64_t b_st, const void* Cm, int64_t c_sb, int64_t c_st, void* y,
                   void* h_out, int Bsz, int S, int NH, int P, int N, int depth,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(depth) * slot_bytes(P, N, sizeof(T)) + fixed_bytes(P, N);
  auto kernel = ssd_scan_kernel<T, TD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(NH, Bsz), kThreads, smem, stream>>>(
      static_cast<const T*>(x), x_sb, x_st, static_cast<const TD*>(dt), dt_sb, dt_st, dt_sh,
      static_cast<const float*>(A), static_cast<const T*>(Bm), b_sb, b_st,
      static_cast<const T*>(Cm), c_sb, c_st, static_cast<T*>(y), static_cast<float*>(h_out), S,
      NH, P, N, depth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dt(int dt_dtype, const void* x, int64_t x_sb, int64_t x_st, const void* dt,
                        int64_t dt_sb, int64_t dt_st, int64_t dt_sh, const void* A,
                        const void* Bm, int64_t b_sb, int64_t b_st, const void* Cm, int64_t c_sb,
                        int64_t c_st, void* y, void* h_out, int Bsz, int S, int NH, int P, int N,
                        int depth, cudaStream_t stream) {
  if (dt_dtype == 0)
    return launch<T, float>(x, x_sb, x_st, dt, dt_sb, dt_st, dt_sh, A, Bm, b_sb, b_st, Cm, c_sb,
                            c_st, y, h_out, Bsz, S, NH, P, N, depth, stream);
  if (dt_dtype == 1)
    return launch<T, __nv_bfloat16>(x, x_sb, x_st, dt, dt_sb, dt_st, dt_sh, A, Bm, b_sb, b_st,
                                    Cm, c_sb, c_st, y, h_out, Bsz, S, NH, P, N, depth, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B, C and y) and dt_dtype: 0 = float32, 1 = bfloat16. A is
// f32 [NH]; strides are in elements. Rows of x (P values) and of B and C
// (N values) must be whole 16-byte units at 16-byte aligned addresses
// (the wrapper checks). Returns the cudaError_t of the launch (0 on
// success); the caller raises on anything else.
extern "C" int repro_ssd_scan(const void* x, long long x_sb, long long x_st, const void* dt,
                              long long dt_sb, long long dt_st, long long dt_sh, const void* A,
                              const void* Bm, long long b_sb, long long b_st, const void* Cm,
                              long long c_sb, long long c_st, void* y, void* h_out, int Bsz, int S,
                              int NH, int P, int N, int depth, int dtype, int dt_dtype,
                              void* stream) {
  if (Bsz < 1 || S < 1 || NH < 1 || P < 4 || P % 4 != 0 || N < 1 ||
      N > 32 * kMaxNPerLane || depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_dt<float>(dt_dtype, x, x_sb, x_st, dt, dt_sb, dt_st, dt_sh,
                                               A, Bm, b_sb, b_st, Cm, c_sb, c_st, y, h_out, Bsz,
                                               S, NH, P, N, depth, s));
  if (dtype == 1)
    return static_cast<int>(dispatch_dt<__nv_bfloat16>(dt_dtype, x, x_sb, x_st, dt, dt_sb, dt_st,
                                                       dt_sh, A, Bm, b_sb, b_st, Cm, c_sb, c_st,
                                                       y, h_out, Bsz, S, NH, P, N, depth, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
