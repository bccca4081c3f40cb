// The coroutine ring shared by the port's kernels (gather, span gather,
// scatter-add, flash decode, grouped matmul, SSD scan): cp.async copies
// into shared memory, one commit group per tile (the paper's aset group),
// and a wait on a run-time depth; and the bulk copies on mbarriers that
// the STREAM triad streams with.
//
// Each kernel keeps `depth` tiles in flight in a ring of shared-memory
// slots. In the row-copy kernels a thread copies the same vectors of every
// tile it issues and later reads back exactly those vectors, so
// cp.async.wait_group alone makes its data visible to it: their ring needs
// no block barrier (the flash-decode and grouped-matmul kernels share each
// tile across the block and add one after the wait).

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
// of kMaxDepth instantiations by binary search (six uniform branches). Not
// inlined: inlined into the page loop of the first paged-decode kernel (since
// replaced), the search ran that kernel a third slower on an H100 (a switch
// there cost the gather kernels' deep rings 6% instead). A kernel whose loop
// it does not slow may inline cp_async_wait_range itself (the span gather,
// the scatter-add).
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

__device__ __noinline__ void cp_async_wait_pending(int n) {
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

// mbarriers, and bulk copies (the Tensor Memory Accelerator's 1-D form)
// that complete on them (the grouped matmul's TMA boxes do too). A bulk
// copy moves a contiguous run of bytes, a multiple of 16 at 16-byte
// aligned addresses on both sides, without registers or per-thread
// instructions: one thread issues it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Make initialised mbarriers visible to the bulk-copy unit.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive, and expect `bytes` more of bulk copies before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared, `bytes` of them, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A 16-byte global store that streams past the caches (evict-first).
__device__ __forceinline__ void st_global_cs(uint4* g, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(g), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
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
