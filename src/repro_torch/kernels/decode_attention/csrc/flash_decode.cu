// Flash-decode attention over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py:flash_decode.
// For each sequence b and query head h of KV group kh = h / G it computes
//
//   o[b, h] = softmax_j(q[b, h] . K[b, j, kh] * D^-0.5) V[b, j, kh]   over j <= pos
//
// on caches [B, S, KH, D] with one scalar `pos` for the whole batch, with an
// f32 online softmax (m, l, acc) over tiles of `blk` key rows, and the output
// acc / max(l, 1e-30) cast to the input type. This is the dense serving
// engine's decode attention: every attention layer, every decode step.
//
// What bounds it: bytes. Each key row is read once and used for G query
// heads (2 * G flops per byte in bf16), far below the ~295 flops/byte at
// which the H100 becomes compute-bound, so its floor is the live K/V rows
// (positions <= pos) over 3.35 TB/s. What the design does about it:
//   * one thread block per (sequence, KV head), so every K/V byte crosses
//     from global memory once and serves all G query heads of its group;
//   * it walks only the ceil((pos + 1) / blk) tiles that hold a live key,
//     where the Pallas kernel walks all S / blk tiles with the tail masked,
//     and never loads a row at or past min(pos + 1, S): S need not be a
//     multiple of blk (the engine pads the cache to prompt + generation);
//   * a ring of `depth` [blk, D] K and V tiles in shared memory is kept in
//     flight with cp.async (the shared coro_ring.cuh), so the copy of tile
//     i + depth overlaps the math on tile i; `depth` is the pipeline depth
//     the host solves from the kernel's CoroSpec, clamped to what shared
//     memory holds for this block's tile;
//   * the scaled query tile stays in shared memory and the running
//     max/sum and the output accumulator in registers, all in f32; each
//     tile costs four block barriers, one warp reduction per (row, head)
//     for the scores and one per head for the softmax update.
// Later work: split the sequence over several blocks when B * KH is under
// the 132 SMs (flash-decoding; yi-6b at batch 8 fills 32), the query in
// registers and scores without a warp reduction per row, TMA tile loads.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/coro_ring.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::cp_async_wait_pending;
using repro::from_f32;
using repro::to_f32;

// 512 threads (16 warps): at the dense engine's shapes B * KH blocks fill
// few SMs (32 of 132 at yi-6b, batch 8), one block each, so the block's
// own warps are what hides shared-memory and shuffle latency (the first
// version's 128 threads ran the yi-6b decode shape far slower: PERF.md).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 32;  // query heads per KV head this kernel takes
constexpr float kNegInf = -1e30f;

// Dynamic shared memory: K ring, V ring ([depth][blk][D] each, input type),
// then f32 q [G][D], p [G][blk], corr [G], l [G]. The same formula is
// repro_torch/kernels/decode_attention/decode_attention.py:_smem_bytes.
size_t smem_bytes(int G, int D, int blk, int depth, int itemsize) {
  return static_cast<size_t>(2) * depth * blk * D * itemsize +
         sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(G) * blk + 2 * G);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// GMAX: a power of two >= G, the query heads one KV head serves; it sizes
// the per-thread register arrays at compile time.
template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache, T* __restrict__ out, int H, int KH, int S,
                        int blk, int n_keys, int depth, float scale) {
  static_assert(kThreads % D == 0, "a thread keeps one head-dim column of the accumulator");
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / KH;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements per 16 B copy
  constexpr int kChunksPerRow = D / kChunk;
  constexpr int kGStep = kThreads / D;                       // heads between a thread's columns
  constexpr int kAccPerThread = (GMAX + kGStep - 1) / kGStep;
  constexpr int kHeadsPerWarp = (GMAX + kWarps - 1) / kWarps;
  constexpr int kDPerLane = (D + 31) / 32;
  const int tile_elems = blk * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_ring = reinterpret_cast<T*>(smem);
  T* v_ring = k_ring + static_cast<size_t>(depth) * tile_elems;
  float* q_s = reinterpret_cast<float*>(v_ring + static_cast<size_t>(depth) * tile_elems);
  float* p_s = q_s + G * D;    // scores, then probabilities, of one tile [G][blk]
  float* c_s = p_s + G * blk;  // this tile's rescale factor exp(m_old - m_new)
  float* l_s = c_s + G;        // final softmax denominators, for the epilogue

  // Key rows 0 .. n_keys - 1 (n_keys = min(pos + 1, S) >= 1) are live.
  const int n_tiles = (n_keys + blk - 1) / blk;
  const int64_t row_stride = static_cast<int64_t>(KH) * D;  // between key rows of one head
  const int64_t base = static_cast<int64_t>(b) * S * row_stride + static_cast<int64_t>(kh) * D;

  // Start the copies of tile `tile` into ring slot `slot`: its live rows
  // of D contiguous elements for this KV head, 16 B per cp.async. Rows at
  // or past n_keys are not loaded, and never read.
  auto issue = [&](int tile, int slot) {
    const int rows = min(blk, n_keys - tile * blk);
    const int64_t first = base + static_cast<int64_t>(tile) * blk * row_stride;
    T* ks = k_ring + static_cast<size_t>(slot) * tile_elems;
    T* vs = v_ring + static_cast<size_t>(slot) * tile_elems;
    for (int c = tid; c < rows * kChunksPerRow; c += kThreads) {
      const int row = c / kChunksPerRow;
      const int col = (c - row * kChunksPerRow) * kChunk;
      const int64_t src = first + row * row_stride + col;
      cp_async16(ks + row * D + col, k_cache + src);
      cp_async16(vs + row * D + col, v_cache + src);
    }
  };

  // Prologue: the scaled query tile of this KV group, fresh accumulators,
  // and the first `depth` tiles in flight. Every slot commits one group,
  // empty or not, so that group i always holds tile i.
  const int64_t q_off = (static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * G) * D;
  for (int e = tid; e < G * D; e += kThreads) q_s[e] = to_f32(q[q_off + e]) * scale;
  // Online-softmax state of heads g = warp + kWarps * i lives in the
  // registers of warp `warp` (every lane holds the same value).
  float m_r[kHeadsPerWarp], l_r[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  // Thread t owns accumulator column d0 = t % D of heads g0, g0 + kGStep, ...
  const int d0 = tid % D;
  const int g0 = tid / D;
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.f;
  for (int s = 0; s < depth; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();
  }
  __syncthreads();

  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % depth;
    const int rows = min(blk, n_keys - i * blk);
    cp_async_wait_pending(depth - 1);  // tile i has landed (this thread's part)
    __syncthreads();                   // ... and every other thread's part
    const T* ks = k_ring + static_cast<size_t>(slot) * tile_elems;
    const T* vs = v_ring + static_cast<size_t>(slot) * tile_elems;

    // Scores: warp w takes key rows j = w, w + 4, ...; each lane multiplies
    // its slice of the head dim with all G query heads, and G independent
    // warp reductions give the G scores. Rows past `rows` score -1e30.
    for (int j = warp; j < blk; j += kWarps) {
      if (j >= rows) {
        if (lane < G) p_s[lane * blk + j] = kNegInf;
        continue;
      }
      float part[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[g] = 0.f;
#pragma unroll
      for (int x = 0; x < kDPerLane; ++x) {
        const int d = lane + 32 * x;
        if (d < D) {
          const float kv = to_f32(ks[j * D + d]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) part[g] += q_s[g * D + d] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float sc = warp_sum(part[g]);
          if (lane == g % 32) p_s[g * blk + j] = sc;
        }
      }
    }
    __syncthreads();

    // Online softmax update: one warp per query head, lanes over the rows.
#pragma unroll
    for (int h = 0; h < kHeadsPerWarp; ++h) {
      const int g = warp + kWarps * h;
      if (g < G) {
        float* sg = p_s + g * blk;
        float mx = m_r[h];
        for (int j = lane; j < blk; j += 32) mx = fmaxf(mx, sg[j]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < blk; j += 32) {
          const float e = expf(sg[j] - mx);
          sg[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        const float corr = expf(m_r[h] - mx);
        l_r[h] = l_r[h] * corr + sum;
        m_r[h] = mx;
        if (lane == 0) c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g, d0] = acc[g, d0] * corr[g] + sum_j p[g, j] * v[j, d0] over the
    // tile's live rows: each V element is read from shared memory once and
    // used for all the thread's heads.
    float pv[kAccPerThread];
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) pv[a] = 0.f;
    for (int j = 0; j < rows; ++j) {
      const float v = to_f32(vs[j * D + d0]);
#pragma unroll
      for (int a = 0; a < kAccPerThread; ++a) {
        const int g = g0 + a * kGStep;
        if (g < G) pv[a] += p_s[g * blk + j] * v;
      }
    }
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int g = g0 + a * kGStep;
      if (g < G) acc[a] = acc[a] * c_s[g] + pv[a];
    }
    __syncthreads();  // the slot and p_s are free again

    if (i + depth < n_tiles) issue(i + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // Epilogue: normalise and cast.
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    const int g = warp + kWarps * h;
    if (g < G && lane == 0) l_s[g] = l_r[h];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int g = g0 + a * kGStep;
    if (g < G) out[q_off + g * D + d0] = from_f32<T>(acc[a] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int D, int GMAX>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache, void* out, int B,
                   int H, int KH, int S, int blk, int n_keys, int depth, float scale,
                   cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = smem_bytes(G, D, blk, depth, static_cast<int>(sizeof(T)));
  auto kernel = flash_decode_kernel<T, D, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<T*>(out), H, KH, S, blk, n_keys, depth, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k_cache, const void* v_cache, void* out,
                       int B, int H, int KH, int S, int blk, int n_keys, int depth, float scale,
                       cudaStream_t stream) {
#define REPRO_LAUNCH(GMAX)                                                                 \
  return launch<T, D, GMAX>(q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys, depth, scale, \
                            stream)
  if (G <= 1) REPRO_LAUNCH(1);
  if (G <= 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  if (G <= 8) REPRO_LAUNCH(8);
  if (G <= 16) REPRO_LAUNCH(16);
  REPRO_LAUNCH(32);
#undef REPRO_LAUNCH
}

template <typename T>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k_cache, const void* v_cache,
                       void* out, int B, int H, int KH, int S, int blk, int n_keys, int depth,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(G, q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys, depth,
                               scale, stream);
    case 32:
      return dispatch_g<T, 32>(G, q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys, depth,
                               scale, stream);
    case 64:
      return dispatch_g<T, 64>(G, q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys, depth,
                               scale, stream);
    case 128:
      return dispatch_g<T, 128>(G, q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys, depth,
                                scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `pos` >= 0 is the last key position
// attended (keys at or past S do not exist: min(pos + 1, S) rows are live).
// Returns the cudaError_t of the launch (0 on success); the caller raises
// on anything else.
extern "C" int repro_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                  void* out, int B, int H, int KH, int D, int S, int blk,
                                  int pos, int depth, float scale, int dtype, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || H / KH > kMaxGroup || S < 1 || blk < 1 || pos < 0 ||
      depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_keys = pos + 1 < S ? pos + 1 : S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int G = H / KH;
  if (dtype == 0) {
    err = dispatch_d<float>(D, G, q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys, depth,
                            scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, G, q, k_cache, v_cache, out, B, H, KH, S, blk, n_keys,
                                    depth, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
