// Grouped matmul of the MoE expert FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/moe_gmm.py:gmm (K2).
// For every expert e it computes
//
//   out[e] = tokens[e] @ weights[e]        [C, dm] x [dm, f] -> [C, f]
//
// with an f32 accumulator and the output in the token type. `tokens` may
// have any expert and row stride (unit column stride): an expert stride of
// 0 hands every expert the same token block, which is how the dense MoE
// layer calls it, without E copies of the tokens. `weights` [E, dm, f] and
// `out` [E, C, f] are contiguous.
//
// What bounds it: bytes. On the serving path C is a decode round (about 5
// tokens) or a prefill chunk (32), so each weight element feeds 2C flops:
// at most 64 per 2-byte element, far below the ~295 flops per byte at
// which the H100's tensor cores become the limit. The floor is the expert
// weights over 3.35 TB/s. What the design does about it:
//   * one thread block per (128-column f tile, 16- or 32-row token tile,
//     expert), so every weight byte crosses from global memory once per
//     token tile, and the serving path has one token tile;
//   * the block walks dm in k-slices of 128 bytes per weight row
//     ([BK, 128]: 64 rows in bf16, 32 in f32) and keeps `depth` of them in
//     flight in a ring of shared-memory slots filled by cp.async (the
//     paper's decoupled aload, coro_ring.cuh), each slot holding the weight
//     slice and the matching [BM, BK] token slice; `depth` is the pipeline
//     depth the host solves from the kernel's CoroSpec, clamped to shared
//     memory, to the number of k-slices and to repro::kMaxDepth;
//   * bf16 runs on the tensor cores through mma.sync.m16n8k16 with f32
//     accumulators (each of the 4 warps owns 32 columns); f32 runs on the
//     SIMT cores (each thread owns one column), so no TF32 rounding enters;
//   * every axis may be ragged: a weight or token unit outside the tensor is
//     never read (its slot is zero-filled instead), and stores are masked.
//     Rows whose bytes or strides are not 16-byte units copy element by
//     element, synchronously.
// Later work: wgmma and TMA loads with a producer warp, and a persistent
// grid that spreads one expert's columns over SMs.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <type_traits>

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 128;  // f columns per block (moe_gmm.py:F_TILE)
static_assert(kThreads == kBN, "a SIMT thread owns one column");

// The ring's geometry for element type T and MT 16-row token tiles. Rows of
// both slices are padded by 16 bytes so that the tensor-core fragment loads
// of one warp fall in distinct shared-memory banks. The same formula is
// repro_torch/kernels/moe_gmm/moe_gmm.py:slot_bytes.
template <typename T, int MT>
struct Ring {
  static constexpr int kBM = 16 * MT;
  static constexpr int kBK = 128 / static_cast<int>(sizeof(T));
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWS = kBN + kPad;  // weight slice row stride
  static constexpr int kTS = kBK + kPad;  // token slice row stride
  static constexpr int kSlot = kBK * kWS + kBM * kTS;
};

size_t smem_bytes(int itemsize, int mt, int depth) {
  const int bk = 128 / itemsize, pad = 16 / itemsize;
  const size_t slot = static_cast<size_t>(bk) * (kBN + pad) + static_cast<size_t>(16) * mt * (bk + pad);
  return slot * itemsize * depth;
}

// One copy unit: 16 bytes through cp.async, or one element synchronously.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_unit(T* dst, const T* src) {
  if constexpr (kVec) {
    repro::cp_async16(dst, src);
  } else {
    *dst = *src;
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void zero_unit(T* dst) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    *dst = repro::from_f32<T>(0.f);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a @ b for one 16x8x16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int MT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ tokens, const T* __restrict__ weights, T* __restrict__ out,
               int C, int dm, int f, int64_t tok_e_stride, int64_t tok_c_stride, int depth) {
  using R = Ring<T, MT>;
  constexpr int kVecElems = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kWRowUnits = kBN / kVecElems;
  constexpr int kTRowUnits = R::kBK / kVecElems;
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * R::kBM;
  const int64_t e = blockIdx.z;
  const T* tok = tokens + e * tok_e_stride;
  const T* w = weights + e * static_cast<int64_t>(dm) * f;
  T* o = out + e * static_cast<int64_t>(C) * f;
  const int tid = threadIdx.x;
  const int n_slices = (dm + R::kBK - 1) / R::kBK;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  // Start the copies of k-slice `s` into ring slot `slot`: the weight rows
  // [k0, k0 + BK) of this block's columns, then the token rows of this
  // block's token tile over the same k range.
  auto issue = [&](int s, int slot) {
    T* ws = ring + static_cast<size_t>(slot) * R::kSlot;
    T* ts = ws + R::kBK * R::kWS;
    const int k0 = s * R::kBK;
    for (int u = tid; u < R::kBK * kWRowUnits; u += kThreads) {
      const int r = u / kWRowUnits;
      const int c = (u - r * kWRowUnits) * kVecElems;
      const int k = k0 + r, n = n0 + c;
      T* dst = ws + r * R::kWS + c;
      if (k < dm && n < f) {
        copy_unit<T, kVec>(dst, w + static_cast<int64_t>(k) * f + n);
      } else {
        zero_unit<T, kVec>(dst);
      }
    }
    for (int u = tid; u < R::kBM * kTRowUnits; u += kThreads) {
      const int r = u / kTRowUnits;
      const int c = (u - r * kTRowUnits) * kVecElems;
      const int m = m0 + r, k = k0 + c;
      T* dst = ts + r * R::kTS + c;
      if (m < C && k < dm) {
        copy_unit<T, kVec>(dst, tok + m * tok_c_stride + k);
      } else {
        zero_unit<T, kVec>(dst);
      }
    }
  };

  // Accumulators. Tensor cores: warp w owns columns [32w, 32w + 32) as four
  // 8-column mma tiles of each 16-row token tile, in the m16n8 C-fragment
  // layout (rows g and g + 8, columns 2 * tig + {0, 1}). SIMT: thread t owns
  // column t of every token row.
  constexpr int kAcc = kTensorCores ? MT * 4 * 4 : R::kBM;
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  // Prologue: the first `depth` k-slices in flight, one commit group per
  // slot, empty or not, so that group i always holds slice i.
  for (int s = 0; s < depth; ++s) {
    if (s < n_slices) issue(s, s);
    repro::cp_async_commit();
  }

  for (int i = 0; i < n_slices; ++i) {
    const int slot = i % depth;
    repro::cp_async_wait_pending(depth - 1);  // slice i has landed (this thread's part)
    __syncthreads();                          // ... and every other thread's part
    const T* ws = ring + static_cast<size_t>(slot) * R::kSlot;
    const T* ts = ws + R::kBK * R::kWS;
    if constexpr (kTensorCores) {
#pragma unroll
      for (int kk = 0; kk < R::kBK; kk += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = warp * 32 + j * 8 + g;
          const T* col = ws + (kk + 2 * tig) * R::kWS + n;
          b[j][0] = pack_bf16(col[0], col[R::kWS]);
          b[j][1] = pack_bf16(col[8 * R::kWS], col[9 * R::kWS]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* row = ts + (mt * 16 + g) * R::kTS + kk + 2 * tig;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(row);
          a[1] = *reinterpret_cast<const uint32_t*>(row + 8 * R::kTS);
          a[2] = *reinterpret_cast<const uint32_t*>(row + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(row + 8 * R::kTS + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc + (mt * 4 + j) * 4, a, b[j]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < R::kBK; ++k) {
        const float wv = repro::to_f32(ws[k * R::kWS + tid]);
#pragma unroll
        for (int m = 0; m < R::kBM; ++m) acc[m] = fmaf(repro::to_f32(ts[m * R::kTS + k]), wv, acc[m]);
      }
    }
    __syncthreads();  // the slot is free again

    if (i + depth < n_slices) issue(i + depth, slot);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();

  // Epilogue: masked stores in the token type.
  auto store = [&](int m, int n, float v) {
    if (m < C && n < f) o[static_cast<int64_t>(m) * f + n] = repro::from_f32<T>(v);
  };
  if constexpr (kTensorCores) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* d = acc + (mt * 4 + j) * 4;
        const int m = m0 + mt * 16 + g;
        const int n = n0 + warp * 32 + j * 8 + 2 * tig;
        store(m, n, d[0]);
        store(m, n + 1, d[1]);
        store(m + 8, n, d[2]);
        store(m + 8, n + 1, d[3]);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < R::kBM; ++m) store(m0 + m, n0 + tid, acc[m]);
  }
}

template <typename T, int MT, bool kVec>
cudaError_t launch(const void* tokens, const void* weights, void* out, int E, int C, int dm,
                   int f, int64_t tok_e_stride, int64_t tok_c_stride, int depth,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(static_cast<int>(sizeof(T)), MT, depth);
  auto kernel = gmm_kernel<T, MT, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((f + kBN - 1) / kBN, (C + 16 * MT - 1) / (16 * MT), E);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(tokens),
                                           static_cast<const T*>(weights), static_cast<T*>(out),
                                           C, dm, f, tok_e_stride, tok_c_stride, depth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int mt, int vec, const void* tokens, const void* weights, void* out, int E,
                     int C, int dm, int f, int64_t tok_e_stride, int64_t tok_c_stride, int depth,
                     cudaStream_t stream) {
#define REPRO_LAUNCH(MT, VEC)                                                                  \
  return launch<T, MT, VEC>(tokens, weights, out, E, C, dm, f, tok_e_stride, tok_c_stride, \
                            depth, stream)
  if (mt == 1) {
    if (vec) REPRO_LAUNCH(1, true);
    REPRO_LAUNCH(1, false);
  }
  if (vec) REPRO_LAUNCH(2, true);
  REPRO_LAUNCH(2, false);
#undef REPRO_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mt: 16-row token tiles per block (1 or
// 2); vec: 1 if every row and base pointer allows 16-byte copies. Returns
// the cudaError_t of the launch (0 on success); the caller raises on
// anything else.
extern "C" int repro_moe_gmm(const void* tokens, const void* weights, void* out, int E, int C,
                             int dm, int f, int64_t tok_e_stride, int64_t tok_c_stride, int depth,
                             int dtype, int mt, int vec, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || dm < 0 || f < 1 || depth < 1 ||
      depth > repro::kMaxDepth || (mt != 1 && mt != 2) || (C + 16 * mt - 1) / (16 * mt) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(mt, vec, tokens, weights, out, E, C, dm, f, tok_e_stride, tok_c_stride,
                          depth, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(mt, vec, tokens, weights, out, E, C, dm, f, tok_e_stride,
                                  tok_c_stride, depth, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
