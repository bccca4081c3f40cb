// Coroutine row gather and span gather for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/coro_gather/coro_gather.py:row_gather   (K5a)
//     out[i] = table[idx[i]], `rows_per_tile` single-row copies per tile
//     (an aset group);
//   src/repro/kernels/coro_gather/coro_gather.py:span_gather  (K5b)
//     tile i = table[starts[i] : starts[i] + span] (one coarse-grained
//     span copy per tile, paper §III-C).
// Both are byte copies, so one kernel serves f32, bf16 and int32 tables.
//
// What bounds it: bytes. Every gathered row is read once and written once
// (2 x row bytes + a 4-byte index per row), with no arithmetic, so its floor
// is those bytes over 3.35 TB/s. A random row is a separate 512 B request,
// so what the kernel has to supply is memory-level parallelism: enough rows
// in flight to cover the ~600 ns a load takes under load. What the design
// does about it:
//   * a thread block is one coroutine scheduler over a contiguous range of
//     tiles; it keeps `depth` tiles in flight in a ring of shared-memory
//     slots filled by cp.async (the paper's decoupled aload), one commit
//     group per tile (the aset group), so the copies of tiles i+1..i+depth-1
//     are in flight while tile i is written out; `depth` is the pipeline
//     depth the host solves from the kernel's CoroSpec, clamped to shared
//     memory, to the tile count and to repro::kMaxDepth;
//   * a row is copied in 16-byte units where its bytes and both base
//     pointers allow it, else in 4-, 2- or 1-byte units (coro_ring.cuh), by
//     consecutive threads on consecutive addresses;
//   * a thread reads back only the units it copied itself, so the ring needs
//     no block barrier (coro_ring.cuh).
// Later work: TMA row copies, and a store path that skips shared memory.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kThreads = 128;

// kSpan: tile t covers rows idx[t] .. idx[t] + rows_per_tile - 1 (idx holds
// span starts); otherwise row r of tile t is idx[t * rows_per_tile + r].
template <typename V, bool kSpan>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const V* __restrict__ table, const int* __restrict__ idx, V* __restrict__ out,
                  int64_t n_tiles, int64_t tiles_per_block, int rows_per_tile, int row_units,
                  int depth) {
  using U = repro::Unit<V>;
  extern __shared__ __align__(16) unsigned char smem[];
  typename U::Slot* ring = reinterpret_cast<typename U::Slot*>(smem);
  const int tile_units = rows_per_tile * row_units;
  int64_t first, count;
  repro::block_tiles(n_tiles, tiles_per_block, &first, &count);

  // The table address of unit u of tile t.
  auto source = [&](int64_t t, int u) {
    const int r = u / row_units;
    const int c = u - r * row_units;
    const int64_t row = kSpan ? static_cast<int64_t>(idx[t]) + r
                              : static_cast<int64_t>(idx[t * rows_per_tile + r]);
    return table + row * row_units + c;
  };
  auto issue = [&](int64_t t, int slot) {
    typename U::Slot* dst = ring + static_cast<size_t>(slot) * tile_units;
    for (int u = threadIdx.x; u < tile_units; u += kThreads) U::load(dst + u, source(t, u));
  };

  // Prologue: the first `depth` tiles in flight. Every slot commits one
  // group, empty or not, so that group i always holds tile i.
  for (int s = 0; s < depth; ++s) {
    if (s < count) issue(first + s, s);
    repro::cp_async_commit();
  }
  for (int64_t i = 0; i < count; ++i) {
    const int slot = static_cast<int>(i % depth);
    const int64_t t = first + i;
    repro::cp_async_wait_pending(depth - 1);  // tile i has landed (this thread's units)
    const typename U::Slot* src = ring + static_cast<size_t>(slot) * tile_units;
    V* dst = out + t * tile_units;
    // source() is read only by the sub-word units; the compiler drops it
    // (and its index load) for the others.
    for (int u = threadIdx.x; u < tile_units; u += kThreads) dst[u] = U::read(src + u, source(t, u));
    if (i + depth < count) issue(t + depth, slot);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
}

template <typename V>
cudaError_t launch(const void* table, const void* idx, void* out, int64_t n_tiles,
                   int64_t tiles_per_block, int grid, int rows_per_tile, int row_bytes,
                   int depth, bool span, cudaStream_t stream) {
  const int row_units = row_bytes / static_cast<int>(sizeof(V));
  const size_t smem = static_cast<size_t>(depth) * rows_per_tile * row_units *
                      sizeof(typename repro::Unit<V>::Slot);
  void (*kernel)(const V*, const int*, V*, int64_t, int64_t, int, int, int) =
      span ? &gather_kernel<V, true> : &gather_kernel<V, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const V*>(table),
                                           static_cast<const int*>(idx), static_cast<V*>(out),
                                           n_tiles, tiles_per_block, rows_per_tile, row_units,
                                           depth);
  return cudaGetLastError();
}

}  // namespace

// out [n_tiles * rows_per_tile, row_bytes] <- rows of table [R, row_bytes].
// span = 0: idx holds one row per output row (K5a); span = 1: idx holds one
// start row per tile of `rows_per_tile` consecutive rows (K5b). unit is the
// copy unit in bytes, 16, 4, 2 or 1; row_bytes must be a multiple of it.
// depth is at most repro::kMaxDepth. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_gather(const void* table, const void* idx, void* out, long long n_tiles,
                            long long tiles_per_block, int grid, int rows_per_tile, int row_bytes,
                            int depth, int span, int unit, void* stream) {
  if (n_tiles < 1 || tiles_per_block < 1 || grid < 1 || rows_per_tile < 1 || depth < 1 ||
      depth > repro::kMaxDepth || unit < 1 || row_bytes < unit || row_bytes % unit != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sp = span != 0;
  switch (unit) {
    case 16:
      return launch<uint4>(table, idx, out, n_tiles, tiles_per_block, grid, rows_per_tile,
                           row_bytes, depth, sp, s);
    case 4:
      return launch<uint32_t>(table, idx, out, n_tiles, tiles_per_block, grid, rows_per_tile,
                              row_bytes, depth, sp, s);
    case 2:
      return launch<uint16_t>(table, idx, out, n_tiles, tiles_per_block, grid, rows_per_tile,
                              row_bytes, depth, sp, s);
    case 1:
      return launch<uint8_t>(table, idx, out, n_tiles, tiles_per_block, grid, rows_per_tile,
                             row_bytes, depth, sp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
