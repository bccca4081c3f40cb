// The coroutine ring shared by the row-copy kernels (gather, span gather,
// scatter-add, STREAM triad): cp.async copies into shared memory, one commit
// group per tile (the paper's aset group), and a wait on a run-time depth.
//
// Each kernel keeps `depth` tiles in flight in a ring of shared-memory
// slots. A thread copies the same vectors of every tile it issues and later
// reads back exactly those vectors, so cp.async.wait_group alone makes its
// data visible to it: the ring needs no block barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The deepest ring a kernel may run: `depth` tiles in flight per block.
// The host clamps every depth to it (repro_torch/kernels/ring.py:MAX_DEPTH).
constexpr int kMaxDepth = 64;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One copy unit of type V: 16, 4, 2 or 1 bytes, the widest that the rows
// and base pointers allow. `Slot` is what one unit takes in the ring; `load`
// starts its cp.async from global address g; `read` returns it from the
// slot once its group has landed (g is the same address).
template <typename V>
struct Unit {
  using Slot = V;
  static __device__ __forceinline__ void load(Slot* s, const V* g) {
    if constexpr (sizeof(V) == 16) cp_async16(s, g); else cp_async4(s, g);
  }
  static __device__ __forceinline__ V read(const Slot* s, const V*) { return *s; }
};

// cp.async copies no fewer than 4 bytes, so a 2- or 1-byte unit's slot is
// the aligned 4-byte word that holds it, and `read` shifts its bytes out.
// That word never leaves the unit's allocation: allocations are aligned to
// far more than 4 bytes.
template <typename V>
struct SubWordUnit {
  using Slot = uint32_t;
  static __device__ __forceinline__ uintptr_t addr(const V* g) {
    return reinterpret_cast<uintptr_t>(g);
  }
  static __device__ __forceinline__ void load(Slot* s, const V* g) {
    cp_async4(s, reinterpret_cast<const void*>(addr(g) & ~uintptr_t(3)));
  }
  static __device__ __forceinline__ V read(const Slot* s, const V* g) {
    return static_cast<V>(*s >> (8 * (addr(g) & 3)));
  }
};
template <>
struct Unit<uint16_t> : SubWordUnit<uint16_t> {};
template <>
struct Unit<uint8_t> : SubWordUnit<uint8_t> {};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `n` copy groups are still pending, for any n below
// kMaxDepth. The instruction takes an immediate, so the run-time n picks one
// of kMaxDepth instantiations by binary search (six uniform branches).
template <int Lo, int Hi>
__device__ __forceinline__ void cp_async_wait_range(int n) {
  if constexpr (Lo == Hi) {
    cp_async_wait<Lo>();
  } else {
    constexpr int kMid = (Lo + Hi) / 2;
    if (n <= kMid) {
      cp_async_wait_range<Lo, kMid>(n);
    } else {
      cp_async_wait_range<kMid + 1, Hi>(n);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_pending(int n) {
  cp_async_wait_range<0, kMaxDepth - 1>(n);
}

// Elementwise arithmetic on one copy unit of T values, in f32 with one
// rounding per result. __fadd_rn / __fmul_rn keep nvcc from contracting
// b + s * c into an FMA, so the result is the plain version's, bit for bit.
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

// out = a + s * b over the sizeof(V) / sizeof(T) values of one unit (s = 1
// skips the product: the scatter-add's plain a + b).
template <typename T, typename V, bool kScale>
__device__ __forceinline__ V axpy_unit(V a, V b, float s) {
  constexpr int kN = sizeof(V) / sizeof(T);
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  V out;
  T* po = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const float y = kScale ? __fmul_rn(s, to_f32(pb[e])) : to_f32(pb[e]);
    po[e] = from_f32<T>(__fadd_rn(to_f32(pa[e]), y));
  }
  return out;
}

// The tiles [first, last) of block blockIdx.x when every block walks
// `tiles_per_block` consecutive tiles.
__device__ __forceinline__ void block_tiles(int64_t n_tiles, int64_t tiles_per_block,
                                            int64_t* first, int64_t* count) {
  *first = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  int64_t c = n_tiles - *first;
  *count = c < tiles_per_block ? c : tiles_per_block;
  if (*count < 0) *count = 0;
}

}  // namespace repro

// The message of a CUDA error code, for the wrapper's exception.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
