// STREAM triad for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/stream_copy/stream_copy.py:triad  (K7)
// a = b + s * c over [N, d] arrays. The product and the sum are each
// rounded in f32 (__fmul_rn, __fadd_rn: no FMA contraction) and the result
// rounded once to the arrays' type, so in f32 it equals the plain version
// bit for bit. `s` arrives already rounded to the arrays' type, as the
// reference passes it.
//
// What bounds it: bytes. Two loads and one store per element and two flops,
// far below the card's balance point, so its floor is 3 x N x d x itemsize
// over 3.35 TB/s. What the design does about it:
//   * the arrays are cut into equal items (a slice of the caller's tile of
//     `rows` rows: contiguous, a few KiB of each array), one a block, and
//     block g makes one pass over item g: the block scheduler, which
//     starts blocks in order as others finish, keeps the bytes in flight in
//     one narrow window that moves through the arrays. (A persistent grid,
//     each block walking items g, g + grid, ..., reads slower on an H100:
//     its blocks drift apart and the window widens; chip_smoke.py's phase
//     9 times it from a patched copy of this source.);
//   * one thread loads the item's b and c slices with one bulk copy each
//     (cp.async.bulk), completing on one mbarrier: no thread spends an
//     instruction per 16 bytes on the loads, and the bytes in flight on an
//     SM are its resident blocks' items;
//   * a is stored from registers with 16-byte streaming stores
//     (st.global.cs; a bulk store from the slot read no faster);
//   * items off 16-byte sizes or addresses (the 4-byte and bf16 2-byte
//     units) take a unit path in the same kernel: plain loads and stores of
//     4- or 2-byte units, consecutive threads on consecutive addresses.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kThreads = 128;

// V is the copy unit: uint4 takes the bulk path, uint32_t / uint16_t the
// unit path. An item is `item_bytes` of each array; block g takes item g.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    triad_kernel(const V* __restrict__ b, const V* __restrict__ c, V* __restrict__ a, float s,
                 int item_bytes) {
  const int tid = threadIdx.x;
  const int units = item_bytes / static_cast<int>(sizeof(V));
  const int64_t off = static_cast<int64_t>(blockIdx.x) * units;

  if constexpr (sizeof(V) != 16) {
    for (int u = tid; u < units; u += kThreads)
      a[off + u] = repro::axpy_unit<T, V, true>(b[off + u], c[off + u], s);
  } else {
    // [b's item | c's item | the mbarrier]
    extern __shared__ __align__(128) unsigned char smem[];
    V* bs = reinterpret_cast<V*>(smem);
    const V* cs = bs + units;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * static_cast<size_t>(item_bytes));
    if (tid == 0) {
      repro::mbar_init(full, 1);
      repro::mbar_fence_init();
      repro::mbar_arrive_expect_tx(full, 2u * item_bytes);
      repro::bulk_load(bs, b + off, item_bytes, full);
      repro::bulk_load(bs + units, c + off, item_bytes, full);
    }
    __syncthreads();  // the mbarrier is initialised
    repro::mbar_wait(full, 0);
    for (int u = tid; u < units; u += kThreads)
      repro::st_global_cs(a + off + u, repro::axpy_unit<T, V, true>(bs[u], cs[u], s));
  }
}

template <typename T, typename V>
cudaError_t launch(const void* b, const void* c, void* a, float s, int64_t items, int item_bytes,
                   cudaStream_t stream) {
  const size_t smem = sizeof(V) == 16 ? 2 * static_cast<size_t>(item_bytes) + 8 : 0;
  auto kernel = triad_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(items), kThreads, smem, stream>>>(
      static_cast<const V*>(b), static_cast<const V*>(c), static_cast<V*>(a), s, item_bytes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int unit, const void* b, const void* c, void* a, float s, int64_t items,
                     int item_bytes, cudaStream_t stream) {
  if (unit == 16) return launch<T, uint4>(b, c, a, s, items, item_bytes, stream);
  if (unit == 4) return launch<T, uint32_t>(b, c, a, s, items, item_bytes, stream);
  if constexpr (sizeof(T) == 2) {
    if (unit == 2) return launch<T, uint16_t>(b, c, a, s, items, item_bytes, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a = b + s * c over `items` contiguous items of `item_bytes` each, one a
// block. dtype: 0 = float32, 1 = bfloat16. unit: 16 (the bulk path:
// item_bytes and the pointers 16-byte aligned), or 4 or (bfloat16) 2 (the
// unit path). Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_triad(const void* b, const void* c, void* a, float s, long long items,
                           int item_bytes, int dtype, int unit, void* stream) {
  if (items < 1 || items > 0x7fffffffLL || unit < 2 || item_bytes < unit ||
      item_bytes % unit != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(unit, b, c, a, s, items, item_bytes, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(unit, b, c, a, s, items, item_bytes, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
