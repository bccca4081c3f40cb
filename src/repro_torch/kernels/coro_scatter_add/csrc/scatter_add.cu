// Coroutine scatter-add (read-modify-write) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/coro_scatter_add/coro_scatter_add.py:scatter_add_unique  (K6)
// table[idx[i]] += upd[i] in place, where idx holds no duplicate (the ops
// layer combines duplicates first: core/descriptors.py:dedup_rmw, the
// compile-time stand-in for the paper's await/asignal locks), so no two
// tiles touch one row and the kernel needs no atomics. The add is done in
// f32 and rounded once to the table's type: for one add that is the
// reference's bf16 add, and in f32 it is the plain version's, bit for bit.
//
// What bounds it: bytes. Each target row is read and written once and each
// update row read once (3 x row bytes + a 4-byte index per row), one add
// per element, so its floor is those bytes over 3.35 TB/s. What the design
// does about it:
//   * a thread block is one coroutine scheduler over a contiguous range of
//     tiles of `rows_per_tile` rows; it keeps `depth` tiles in flight in a
//     shared-memory ring, each slot holding the tile's current table rows
//     and its update rows, both copied by cp.async in one commit group (the
//     aset group); the depth is solved on the host from the CoroSpec and
//     clamped to shared memory, to the tile count and to repro::kMaxDepth;
//   * the write-back (the reference's astore StoreStream) is a plain global
//     store straight from registers: a store does not stall the thread, so
//     it needs no slot of its own;
//   * 16-byte units where the rows and pointers allow, else 4-byte words,
//     else (bf16 rows of odd width) 2-byte units (coro_ring.cuh); a thread
//     reads back only the units it copied, so no block barrier.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(V* __restrict__ table, const int* __restrict__ idx,
                       const V* __restrict__ upd, int64_t n_tiles, int64_t tiles_per_block,
                       int rows_per_tile, int row_units, int depth) {
  using U = repro::Unit<V>;
  using Slot = typename U::Slot;
  extern __shared__ __align__(16) unsigned char smem[];
  Slot* ring = reinterpret_cast<Slot*>(smem);  // slot s: [cur tile | upd tile]
  const int tile_units = rows_per_tile * row_units;
  int64_t first, count;
  repro::block_tiles(n_tiles, tiles_per_block, &first, &count);

  // The table address of unit u of tile t.
  auto target = [&](int64_t t, int u) {
    const int r = u / row_units;
    const int c = u - r * row_units;
    return table + static_cast<int64_t>(idx[t * rows_per_tile + r]) * row_units + c;
  };
  auto issue = [&](int64_t t, int slot) {
    Slot* cur = ring + static_cast<size_t>(slot) * 2 * tile_units;
    Slot* up = cur + tile_units;
    const V* src_upd = upd + t * tile_units;
    for (int u = threadIdx.x; u < tile_units; u += kThreads) {
      U::load(cur + u, target(t, u));
      U::load(up + u, src_upd + u);
    }
  };

  for (int s = 0; s < depth; ++s) {
    if (s < count) issue(first + s, s);
    repro::cp_async_commit();
  }
  for (int64_t i = 0; i < count; ++i) {
    const int slot = static_cast<int>(i % depth);
    const int64_t t = first + i;
    repro::cp_async_wait_pending(depth - 1);
    const Slot* cur = ring + static_cast<size_t>(slot) * 2 * tile_units;
    const Slot* up = cur + tile_units;
    const V* src_upd = upd + t * tile_units;
    for (int u = threadIdx.x; u < tile_units; u += kThreads) {
      V* dst = target(t, u);
      *dst = repro::axpy_unit<T, V, false>(U::read(cur + u, dst), U::read(up + u, src_upd + u),
                                           1.f);
    }
    if (i + depth < count) issue(t + depth, slot);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
}

template <typename T, typename V>
cudaError_t launch(void* table, const void* idx, const void* upd, int64_t n_tiles,
                   int64_t tiles_per_block, int grid, int rows_per_tile, int row_bytes,
                   int depth, cudaStream_t stream) {
  const int row_units = row_bytes / static_cast<int>(sizeof(V));
  const size_t smem = static_cast<size_t>(depth) * 2 * rows_per_tile * row_units *
                      sizeof(typename repro::Unit<V>::Slot);
  auto kernel = scatter_add_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<V*>(table), static_cast<const int*>(idx),
                                           static_cast<const V*>(upd), n_tiles, tiles_per_block,
                                           rows_per_tile, row_units, depth);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_unit(int unit, void* table, const void* idx, const void* upd,
                          int64_t n_tiles, int64_t tiles_per_block, int grid, int rows_per_tile,
                          int row_bytes, int depth, cudaStream_t stream) {
  if (unit == 16)
    return launch<T, uint4>(table, idx, upd, n_tiles, tiles_per_block, grid, rows_per_tile,
                            row_bytes, depth, stream);
  if (unit == 4)
    return launch<T, uint32_t>(table, idx, upd, n_tiles, tiles_per_block, grid, rows_per_tile,
                               row_bytes, depth, stream);
  if constexpr (sizeof(T) == 2) {
    if (unit == 2)
      return launch<T, uint16_t>(table, idx, upd, n_tiles, tiles_per_block, grid, rows_per_tile,
                                 row_bytes, depth, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// table [R, row_bytes] += upd [n_tiles * rows_per_tile, row_bytes] at the
// duplicate-free rows idx. dtype: 0 = float32, 1 = bfloat16. unit: copy unit
// in bytes, 16, 4 or (bfloat16) 2. depth is at most repro::kMaxDepth. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_scatter_add(void* table, const void* idx, const void* upd,
                                 long long n_tiles, long long tiles_per_block, int grid,
                                 int rows_per_tile, int row_bytes, int depth, int dtype, int unit,
                                 void* stream) {
  if (n_tiles < 1 || tiles_per_block < 1 || grid < 1 || rows_per_tile < 1 || depth < 1 ||
      depth > repro::kMaxDepth || unit < 2 || row_bytes < unit || row_bytes % unit != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_unit<float>(unit, table, idx, upd, n_tiles, tiles_per_block, grid,
                               rows_per_tile, row_bytes, depth, s);
  } else if (dtype == 1) {
    err = dispatch_unit<__nv_bfloat16>(unit, table, idx, upd, n_tiles, tiles_per_block, grid,
                                       rows_per_tile, row_bytes, depth, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
