// STREAM triad for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/stream_copy/stream_copy.py:triad  (K7)
// a = b + s * c over [N, d] arrays in tiles of `rows` rows. The product and
// the sum are each rounded in f32 (__fmul_rn, __fadd_rn: no FMA
// contraction) and the result rounded once to the arrays' type, so in f32
// it equals the plain version bit for bit. `s` arrives already rounded to
// the arrays' type, as the reference passes it.
//
// What bounds it: bytes. Two loads and one store per element and two flops,
// far below the card's balance point, so its floor is 3 x N x d x itemsize
// over 3.35 TB/s. What the design does about it:
//   * a thread block is one coroutine scheduler over a contiguous range of
//     tiles; it keeps `depth` tiles of b and c in flight in a shared-memory
//     ring filled by cp.async, one commit group per tile (both loads of a
//     tile are one aset group), while the tile before is computed and
//     stored; the depth is solved on the host from the CoroSpec and clamped
//     to shared memory (a 128 x 128 f32 tile pair is 128 KiB, so one slot)
//     and to the tile count;
//   * the store stream (the reference's StoreStream) is a plain global store
//     from registers: it does not stall the thread and needs no slot;
//   * 16-byte units where the tiles and pointers allow, else 4-byte words,
//     else (bf16 tiles of an odd number of values) 2-byte units
//     (coro_ring.cuh), consecutive threads on consecutive addresses; a
//     thread reads back only the units it copied, so no block barrier.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    triad_kernel(const V* __restrict__ b, const V* __restrict__ c, V* __restrict__ a, float s,
                 int64_t n_tiles, int64_t tiles_per_block, int tile_units, int depth) {
  using U = repro::Unit<V>;
  using Slot = typename U::Slot;
  extern __shared__ __align__(16) unsigned char smem[];
  Slot* ring = reinterpret_cast<Slot*>(smem);  // slot k: [b tile | c tile]
  int64_t first, count;
  repro::block_tiles(n_tiles, tiles_per_block, &first, &count);

  auto issue = [&](int64_t t, int slot) {
    Slot* bs = ring + static_cast<size_t>(slot) * 2 * tile_units;
    Slot* cs = bs + tile_units;
    const int64_t off = t * tile_units;
    for (int u = threadIdx.x; u < tile_units; u += kThreads) {
      U::load(bs + u, b + off + u);
      U::load(cs + u, c + off + u);
    }
  };

  for (int k = 0; k < depth; ++k) {
    if (k < count) issue(first + k, k);
    repro::cp_async_commit();
  }
  for (int64_t i = 0; i < count; ++i) {
    const int slot = static_cast<int>(i % depth);
    repro::cp_async_wait_pending(depth - 1);
    const Slot* bs = ring + static_cast<size_t>(slot) * 2 * tile_units;
    const Slot* cs = bs + tile_units;
    const int64_t off = (first + i) * tile_units;
    for (int u = threadIdx.x; u < tile_units; u += kThreads)
      a[off + u] = repro::axpy_unit<T, V, true>(U::read(bs + u, b + off + u),
                                                U::read(cs + u, c + off + u), s);
    if (i + depth < count) issue(first + i + depth, slot);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
}

template <typename T, typename V>
cudaError_t launch(const void* b, const void* c, void* a, float s, int64_t n_tiles,
                   int64_t tiles_per_block, int grid, int tile_bytes, int depth,
                   cudaStream_t stream) {
  const int tile_units = tile_bytes / static_cast<int>(sizeof(V));
  const size_t smem = static_cast<size_t>(depth) * 2 * tile_units *
                      sizeof(typename repro::Unit<V>::Slot);
  auto kernel = triad_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const V*>(b), static_cast<const V*>(c),
                                           static_cast<V*>(a), s, n_tiles, tiles_per_block,
                                           tile_units, depth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_unit(int unit, const void* b, const void* c, void* a, float s,
                          int64_t n_tiles, int64_t tiles_per_block, int grid, int tile_bytes,
                          int depth, cudaStream_t stream) {
  if (unit == 16)
    return launch<T, uint4>(b, c, a, s, n_tiles, tiles_per_block, grid, tile_bytes, depth,
                            stream);
  if (unit == 4)
    return launch<T, uint32_t>(b, c, a, s, n_tiles, tiles_per_block, grid, tile_bytes, depth,
                               stream);
  if constexpr (sizeof(T) == 2) {
    if (unit == 2)
      return launch<T, uint16_t>(b, c, a, s, n_tiles, tiles_per_block, grid, tile_bytes, depth,
                                 stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a = b + s * c over n_tiles contiguous tiles of tile_bytes each. dtype:
// 0 = float32, 1 = bfloat16. unit: copy unit in bytes, 16, 4 or (bfloat16)
// 2. depth is at most repro::kMaxDepth. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_triad(const void* b, const void* c, void* a, float s, long long n_tiles,
                           long long tiles_per_block, int grid, int tile_bytes, int depth,
                           int dtype, int unit, void* stream) {
  if (n_tiles < 1 || tiles_per_block < 1 || grid < 1 || depth < 1 ||
      depth > repro::kMaxDepth || unit < 2 || tile_bytes < unit || tile_bytes % unit != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_unit<float>(unit, b, c, a, s, n_tiles, tiles_per_block, grid, tile_bytes,
                               depth, st);
  } else if (dtype == 1) {
    err = dispatch_unit<__nv_bfloat16>(unit, b, c, a, s, n_tiles, tiles_per_block, grid,
                                       tile_bytes, depth, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
