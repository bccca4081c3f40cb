// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py:paged_flash_decode.
// For each request b and query head h of KV group kh = h / G it computes
//
//   o[b, h] = softmax_j(q[b, h] . K[j] * D^-0.5) V      over key j < len[b]
//
// where key position j lives in page block_tables[b, j / blk] at row
// j % blk of the [NB, blk, KH, D] pools, with an f32 online softmax
// (m, l, acc) and the output acc / max(l, 1e-30) cast to the input type.
//
// What bounds it: bytes. Each key row is read once and used for G query
// heads (2 * G flops per byte in bf16), far below the ~295 flops/byte at
// which the H100 becomes compute-bound, so its floor is the live K/V pages
// over 3.35 TB/s. What the design does about it:
//   * one thread block per (request, KV head), so every K/V byte crosses
//     from global memory once and serves all G query heads of its group;
//   * it walks only the ceil(len/blk) pages a request holds, where the
//     Pallas kernel walks every page of the table with the tail masked;
//   * a ring of `depth` page buffers in shared memory is kept in flight
//     with cp.async (the paper's decoupled aload), so the copy of page
//     i + depth overlaps the math on page i; `depth` is the pipeline depth
//     the host solves from the kernel's CoroSpec, clamped to what shared
//     memory holds for this block's tile;
//   * the scaled query tile stays in shared memory and the running
//     max/sum and the output accumulator in registers, all in f32; each
//     page costs four block barriers, one warp reduction per (row, head)
//     for the scores and one per head for the softmax update.
// Later work: split a request's pages over several blocks when B * KH is
// under the 132 SMs (flash-decoding), TMA page loads, wgmma for large G.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 32;  // query heads per KV head this kernel takes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `n` copy groups are still pending. The instruction
// takes an immediate, so a run-time depth goes through a switch; past 15
// it waits for 15, which is stricter and therefore still correct.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<15>(); break;
  }
}

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
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, T* __restrict__ out, int H, int KH,
                        int blk, int M, int depth, float scale) {
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
  const int page_elems = blk * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_ring = reinterpret_cast<T*>(smem);
  T* v_ring = k_ring + static_cast<size_t>(depth) * page_elems;
  float* q_s = reinterpret_cast<float*>(v_ring + static_cast<size_t>(depth) * page_elems);
  float* p_s = q_s + G * D;  // scores, then probabilities, of one page [G][blk]
  float* c_s = p_s + G * blk;  // this page's rescale factor exp(m_old - m_new)
  float* l_s = c_s + G;        // final softmax denominators, for the epilogue

  const int len = lengths[b];
  int n_pages = len > 0 ? (len + blk - 1) / blk : 0;
  if (n_pages > M) n_pages = M;
  const int* table = block_tables + static_cast<int64_t>(b) * M;
  const int64_t row_stride = static_cast<int64_t>(KH) * D;  // between key rows of one head
  const int64_t page_stride = static_cast<int64_t>(blk) * row_stride;
  const int64_t head_off = static_cast<int64_t>(kh) * D;

  // Start the copies of page `page` of this request into ring slot `slot`:
  // blk rows of D contiguous elements for this KV head, 16 B per cp.async.
  auto issue = [&](int page, int slot) {
    const int64_t base = static_cast<int64_t>(table[page]) * page_stride + head_off;
    T* ks = k_ring + static_cast<size_t>(slot) * page_elems;
    T* vs = v_ring + static_cast<size_t>(slot) * page_elems;
    for (int c = tid; c < blk * kChunksPerRow; c += kThreads) {
      const int row = c / kChunksPerRow;
      const int col = (c - row * kChunksPerRow) * kChunk;
      const int64_t src = base + row * row_stride + col;
      cp_async16(ks + row * D + col, k_pool + src);
      cp_async16(vs + row * D + col, v_pool + src);
    }
  };

  // Prologue: the scaled query tile of this KV group, fresh accumulators,
  // and the first `depth` pages in flight. Every slot commits one group,
  // empty or not, so that group i always holds page i.
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
    if (s < n_pages) issue(s, s);
    cp_async_commit();
  }
  __syncthreads();

  for (int i = 0; i < n_pages; ++i) {
    const int slot = i % depth;
    cp_async_wait_pending(depth - 1);  // page i has landed (this thread's part)
    __syncthreads();                   // ... and every other thread's part
    const T* ks = k_ring + static_cast<size_t>(slot) * page_elems;
    const T* vs = v_ring + static_cast<size_t>(slot) * page_elems;

    // Scores: warp w takes key rows j = w, w + 4, ...; each lane multiplies
    // its slice of the head dim with all G query heads, and G independent
    // warp reductions (their shuffles interleave) give the G scores.
    for (int j = warp; j < blk; j += kWarps) {
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
      const bool valid = i * blk + j < len;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float sc = warp_sum(part[g]);
          if (lane == g % 32) p_s[g * blk + j] = valid ? sc : kNegInf;
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

    // acc[g, d0] = acc[g, d0] * corr[g] + sum_j p[g, j] * v[j, d0]: each V
    // element is read from shared memory once and used for all the
    // thread's heads.
    float pv[kAccPerThread];
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) pv[a] = 0.f;
    for (int j = 0; j < blk; ++j) {
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

    if (i + depth < n_pages) issue(i + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // Epilogue: normalise and cast. A request with len == 0 (a padding row
  // of a round) has l == 0 and acc == 0, and writes 0.
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
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* lengths, void* out, int B, int H,
                   int KH, int blk, int M, int depth, float scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = smem_bytes(G, D, blk, depth, static_cast<int>(sizeof(T)));
  auto kernel = paged_decode_kernel<T, D, GMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KH, blk, M, depth, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* lengths, void* out, int B, int H,
                       int KH, int blk, int M, int depth, float scale, cudaStream_t stream) {
#define REPRO_LAUNCH(GMAX)                                                                   \
  return launch<T, D, GMAX>(q, k_pool, v_pool, block_tables, lengths, out, B, H, KH, blk, M, \
                            depth, scale, stream)
  if (G <= 1) REPRO_LAUNCH(1);
  if (G <= 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  if (G <= 8) REPRO_LAUNCH(8);
  if (G <= 16) REPRO_LAUNCH(16);
  REPRO_LAUNCH(32);
#undef REPRO_LAUNCH
}

template <typename T>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* lengths, void* out, int B, int H,
                       int KH, int blk, int M, int depth, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(G, q, k_pool, v_pool, block_tables, lengths, out, B, H, KH, blk,
                               M, depth, scale, stream);
    case 64:
      return dispatch_g<T, 64>(G, q, k_pool, v_pool, block_tables, lengths, out, B, H, KH, blk,
                               M, depth, scale, stream);
    case 128:
      return dispatch_g<T, 128>(G, q, k_pool, v_pool, block_tables, lengths, out, B, H, KH, blk,
                                M, depth, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The message of a CUDA error code, for the wrapper's exception.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int repro_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* block_tables, const void* lengths, void* out,
                                  int B, int H, int KH, int D, int blk, int M, int depth,
                                  float scale, int dtype, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || H / KH > kMaxGroup || blk < 1 || M < 1 ||
      depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int G = H / KH;
  if (dtype == 0) {
    err = dispatch_d<float>(D, G, q, k_pool, v_pool, block_tables, lengths, out, B, H, KH, blk,
                            M, depth, scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, G, q, k_pool, v_pool, block_tables, lengths, out, B, H,
                                    KH, blk, M, depth, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
