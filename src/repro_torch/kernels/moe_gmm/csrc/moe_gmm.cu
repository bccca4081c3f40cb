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
// weights over 3.35 TB/s, so what matters is that every SM streams its share
// of the weights with bytes in flight from the first microsecond to the
// last. That is also why there is no wgmma here: its 64-row tile would be
// 59/64 padding at C 5, and the tensor-core rate is not the limit. What the
// design does:
//   * a persistent grid (moe_gmm.py:walk, grid_blocks): the output tiles
//     (e, 128-column f tile, 16- or 32-row token tile) are dealt to the
//     blocks in turn, block b taking tiles b, b + blocks, ..., so that the
//     blocks in flight together read neighbouring tiles of one expert. The
//     grid is the fewest blocks that walk the tiles in the fewest tiles a
//     block on a card of sm_count x blocks-per-SM (the occupancy
//     calculator's); each block stores every tile it walks, whole. (Every
//     block an equal share of k-slices, tiles split between blocks and
//     summed by the last to arrive, read 3-6% slower at every shape timed:
//     memory, not an SM, is the shared limit, and a split tile costs a
//     fix-up and row locality);
//   * the block walks each tile in k-slices of 128 bytes per weight row
//     ([BK, 128]: 64 rows in bf16, 32 in f32) and keeps `depth` of them in
//     flight in a ring of shared-memory slots, each holding the weight
//     slice and the matching [BM, BK] token slice. Loading and computing
//     are separate warps: one producer warp fills a slot as soon as it is
//     free (the weight slice as TMA boxes of a 3-D tensor map, the token
//     slice in cp.async units; both complete on the slot's `full`
//     mbarrier), and four consumer warps wait on `full`, multiply, and
//     release the slot on its `empty` mbarrier. No block barrier stands in
//     the k-loop, and the copy engine keeps the weights in flight: a
//     slice is two or four TMA instructions (with 1-D bulk copies, one per
//     256-byte weight row, the time followed the blocks an SM, not the
//     depth: their issue bound it). The ring runs on
//     across tile boundaries, so the next tile's slices land while a tile
//     is stored;
//   * bf16 runs on the tensor cores through mma.sync.m16n8k16 with f32
//     accumulators (each of the 4 consumer warps owns 32 columns), its
//     fragments loaded by ldmatrix (.trans for the weight slice, which the
//     TMA stores with the 128-byte swizzle); f32 runs on the SIMT cores
//     (each consumer thread owns one column), so no TF32 rounding enters;
//   * every axis may be ragged: the tensor map returns zeros past dm and f,
//     a token row or column outside the tensor is never read (its slot is
//     zero-filled instead), and stores are masked. Rows whose bytes or
//     strides are not 16-byte units are copied element by element by the
//     producer warp, synchronously.
//
// Built by repro_torch/kernels/build.py with nvcc for sm_90a into a shared
// library with a plain C interface, called through ctypes.

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)

#include <type_traits>

#include "../../csrc/coro_ring.cuh"

namespace {

constexpr int kConsumers = 128;              // four consumer warps
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kBN = 128;  // f columns per tile (moe_gmm.py:F_TILE)
static_assert(kConsumers == kBN, "a SIMT consumer thread owns one column");

// The ring's geometry for element type T and MT 16-row token tiles. A slot
// holds the [BK, 128] weight slice as kBoxes TMA boxes of [BK rows, 128
// bytes], each stored with the 128-byte swizzle (16-byte chunk c of row r
// at chunk c ^ (r % 8)), so that the eight rows of an ldmatrix (or a warp's
// SIMT loads of one row) fall in distinct banks; then the [BM, BK] token
// slice, rows padded by 16 bytes for the same reason. Slots are 1024-byte
// aligned (the swizzle's period). The slots' mbarriers, a `full` and an
// `empty` one each (8 bytes apiece), come first, and 1024 bytes of slack
// align the slots. The same formula is
// repro_torch/kernels/moe_gmm/moe_gmm.py:slot_bytes.
template <typename T, int MT>
struct Ring {
  static constexpr int kBM = 16 * MT;
  static constexpr int kBK = 128 / static_cast<int>(sizeof(T));
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  static constexpr int kTS = kBK + kPad;                          // token row stride
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));  // a box row: 128 bytes
  static constexpr int kBoxes = kBN / kBoxCols;
  static constexpr int kWeightBytes = kBK * kBN * static_cast<int>(sizeof(T));  // 16 KiB
  static constexpr int kSlotBytes =
      (kWeightBytes + kBM * kTS * static_cast<int>(sizeof(T)) + 1023) / 1024 * 1024;
};

constexpr int kBarrierBytes = 16;  // a slot's full and empty mbarriers
constexpr int kAlignSlack = 1024;  // to align the slots to the swizzle's period

size_t smem_bytes(int itemsize, int mt, int depth) {
  const int bk = 128 / itemsize, pad = 16 / itemsize;
  const size_t slot = (static_cast<size_t>(bk) * kBN * itemsize +
                       static_cast<size_t>(16) * mt * (bk + pad) * itemsize + 1023) / 1024 * 1024;
  return (slot + kBarrierBytes) * depth + kAlignSlack;
}

// The byte offset of element (row r, column n) of a weight slice in its
// slot: box n / kBoxCols, 16-byte chunk swizzled by the row.
template <typename T, int MT>
__device__ __forceinline__ int weight_offset(int r, int n) {
  using R = Ring<T, MT>;
  const int box = n / R::kBoxCols;
  const int byte = (n - box * R::kBoxCols) * static_cast<int>(sizeof(T));
  return box * R::kBK * 128 + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

// The walk (moe_gmm.py:walk): block b walks output tiles b, b + blocks,
// b + 2 * blocks, ... below `tiles`, `per_tile` k-slices each. Its i-th
// k-slice is k-slice i % per_tile of its (i / per_tile)-th tile. Output
// tile (e * n_col + column tile) * n_tok + token tile.
struct Walk {
  int64_t tiles;
  int64_t per_tile;
  int blocks;
  int n_col;
  int n_tok;

  // The k-slices block b walks.
  __device__ __forceinline__ int64_t slices_of(int b) const {
    return (tiles - b + blocks - 1) / blocks * per_tile;
  }
  // The output tile of block b's i-th k-slice.
  __device__ __forceinline__ int64_t tile_of(int b, int64_t i) const {
    return b + i / per_tile * blocks;
  }
};

using repro::mbar_arrive_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_addr;

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Load box (c0, c1, c2) of the 3-D tensor map `map` into shared memory at
// `dst` with the Tensor Memory Accelerator; elements outside the tensor
// arrive as zeros. Completes on `bar` with the box's bytes. The weights are
// read once, so they go first when L2 evicts (the tokens, read once per
// column tile, and the partials stay).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l names row l % 8 of
// matrix l / 8. .trans hands each thread a column pair instead of a row
// pair: the B fragment of a row-major [k, n] slice.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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
               int C, int dm, int f, int64_t tok_e_stride, int64_t tok_c_stride, int depth,
               Walk walk, const __grid_constant__ CUtensorMap wmap) {
  using R = Ring<T, MT>;
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  // Accumulators a consumer thread owns, on both paths. Tensor cores: warp
  // w owns columns [32w, 32w + 32) as four 8-column mma tiles of each
  // 16-row token tile, in the m16n8 C-fragment layout (rows g and g + 8,
  // columns 2 * tig + {0, 1}). SIMT: thread t owns column t of every token
  // row.
  constexpr int kAcc = 16 * MT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int block = static_cast<int>(blockIdx.x);
  const int64_t count = walk.slices_of(block);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + depth;
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* slots =
      smem_raw + (((raw + kBarrierBytes * depth + 1023) & ~1023u) - raw);

  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      // full: every producer lane arrives twice (its generic stores, then
      // its cp.async copies); the TMA boxes add their bytes
      mbar_init(full + s, 64);
      mbar_init(empty + s, kConsumerWarps);  // every consumer warp releases
    }
    repro::mbar_fence_init();
  }
  __syncthreads();  // the last block-wide barrier: the roles split here

  // The operands of output tile `tile`: the expert's token block, weight
  // matrix and output block, and the tile's first row and column.
  struct Tile {
    const T* tok;
    const T* w;
    T* o;
    int m0, n0, e;
  };
  auto tile_at = [&](int64_t tile) {
    const int tt = static_cast<int>(tile % walk.n_tok);
    const int64_t rest = tile / walk.n_tok;
    const int col = static_cast<int>(rest % walk.n_col);
    const int64_t e = rest / walk.n_col;
    return Tile{tokens + e * tok_e_stride, weights + e * static_cast<int64_t>(dm) * f,
                out + e * static_cast<int64_t>(C) * f, tt * R::kBM, col * kBN,
                static_cast<int>(e)};
  };

  if (warp == kConsumerWarps) {
    // The producer warp: fill slot i % depth with the block's i-th k-slice
    // once its consumers have released it. Lane 0 loads the weight slice as
    // kBoxes TMA boxes (zeros past dm and f); the lanes copy the token slice
    // in 16-byte cp.async units, zero-filling its rows and columns outside
    // the tensor. Rows off the 16-byte unit (kVec false) are copied element by
    // element, synchronously.
    for (int64_t i = 0; i < count; ++i) {
      const int slot = static_cast<int>(i % depth);
      const uint32_t use = static_cast<uint32_t>(i / depth);
      if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
      const Tile t = tile_at(walk.tile_of(block, i));
      const int k0 = static_cast<int>(i % walk.per_tile) * R::kBK;
      unsigned char* ws = slots + static_cast<size_t>(slot) * R::kSlotBytes;
      T* ts = reinterpret_cast<T*>(ws + R::kWeightBytes);
      const int t_cols = max(0, min(R::kBK, dm - k0));  // token row elements inside the tensor
      if constexpr (kVec) {
        constexpr int kE = 16 / static_cast<int>(sizeof(T));
        constexpr int kTU = R::kBK / kE;
        for (int u = lane; u < R::kBM * kTU; u += 32) {
          const int r = u / kTU, c = (u - r * kTU) * kE;
          T* dst = ts + r * R::kTS + c;
          if (t.m0 + r < C && c < t_cols) {
            repro::cp_async16(dst, t.tok + (t.m0 + r) * tok_c_stride + k0 + c);
          } else {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + slot, R::kWeightBytes);
          for (int b = 0; b < R::kBoxes; ++b) {
            tma_load_3d(ws + b * R::kBK * 128, &wmap, t.n0 + b * R::kBoxCols, k0, t.e, full + slot);
          }
        } else {
          mbar_arrive(full + slot);
        }
        cp_async_arrive(full + slot);
      } else {
        const T zero = repro::from_f32<T>(0.f);
        const int w_cols = min(kBN, f - t.n0);
        for (int r = 0; r < R::kBK; ++r) {
          const T* src = t.w + static_cast<int64_t>(k0 + r) * f + t.n0;
          for (int c = lane; c < kBN; c += 32) {
            *reinterpret_cast<T*>(ws + weight_offset<T, MT>(r, c)) =
                k0 + r < dm && c < w_cols ? src[c] : zero;
          }
        }
        for (int r = 0; r < R::kBM; ++r) {
          const T* src = t.tok + (t.m0 + r) * tok_c_stride + k0;
          for (int c = lane; c < R::kBK; c += 32) {
            ts[r * R::kTS + c] = t.m0 + r < C && c < t_cols ? src[c] : zero;
          }
        }
        mbar_arrive(full + slot);
        mbar_arrive(full + slot);
      }
    }
    return;
  }

  // acc += the token slice @ the weight slice in ring slot `slot`.
  auto multiply = [&](int slot, float* acc) {
    const unsigned char* ws = slots + static_cast<size_t>(slot) * R::kSlotBytes;
    const T* ts = reinterpret_cast<const T*>(ws + R::kWeightBytes);
    if constexpr (kTensorCores) {
      const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int kk = 0; kk < R::kBK; kk += 16) {
        // B fragments of the warp's four 8-column tiles: matrices (k 0-7,
        // n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of
        // each 16-column half.
        uint32_t b[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ws + weight_offset<T, MT>(kk + (mi & 1) * 8 + r8,
                                                         warp * 32 + h * 16 + (mi >> 1) * 8));
          b[2 * h][0] = r[0];
          b[2 * h][1] = r[1];
          b[2 * h + 1][0] = r[2];
          b[2 * h + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A fragment: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7,
          // k 8-15), (m 8-15, k 8-15).
          uint32_t a[4];
          ldmatrix_x4(a, ts + (mt * 16 + (mi & 1) * 8 + r8) * R::kTS + kk + (mi >> 1) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc + (mt * 4 + j) * 4, a, b[j]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < R::kBK; ++k) {
        const float wv = repro::to_f32(*reinterpret_cast<const T*>(ws + weight_offset<T, MT>(k, tid)));
#pragma unroll
        for (int m = 0; m < R::kBM; ++m) acc[m] = fmaf(repro::to_f32(ts[m * R::kTS + k]), wv, acc[m]);
      }
    }
  };

  // Masked stores of a tile's accumulators in the token type.
  auto store = [&](const Tile& t, const float* acc) {
    auto put = [&](int m, int n, float v) {
      if (m < C && n < f) t.o[static_cast<int64_t>(m) * f + n] = repro::from_f32<T>(v);
    };
    if constexpr (kTensorCores) {
      // columns n and n + 1 of a row as one 4-byte store where both are
      // inside the tensor and n * 2 bytes is 4-byte aligned (f even)
      auto put2 = [&](int m, int n, float a, float b) {
        if (m >= C) return;
        if (n + 1 < f && (f & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(t.o + static_cast<int64_t>(m) * f + n) =
              __floats2bfloat162_rn(a, b);
        } else {
          put(m, n, a);
          put(m, n + 1, b);
        }
      };
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* d = acc + (mt * 4 + j) * 4;
          const int m = t.m0 + mt * 16 + g;
          const int n = t.n0 + warp * 32 + j * 8 + 2 * tig;
          put2(m, n, d[0], d[1]);
          put2(m + 8, n, d[2], d[3]);
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < R::kBM; ++m) put(t.m0 + m, t.n0 + tid, acc[m]);
    }
  };

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  for (int64_t i = 0; i < count; ++i) {
    const int slot = static_cast<int>(i % depth);
    mbar_wait(full + slot, static_cast<uint32_t>(i / depth) & 1);  // slice i has landed
    multiply(slot, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the slot
    if ((i + 1) % walk.per_tile == 0) {        // the tile's last k-slice
      store(tile_at(walk.tile_of(block, i)), acc);
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The weights [E, dm, f] as a 3-D tensor map of [BK rows, 128-byte] boxes
// with the 128-byte swizzle; reads past dm or f come back as zeros.
template <typename T, int MT>
cudaError_t weight_map(CUtensorMap* map, const void* weights, int E, int dm, int f) {
  using R = Ring<T, MT>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(f), static_cast<cuuint64_t>(dm),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(f) * sizeof(T),
                                 static_cast<cuuint64_t>(dm) * f * sizeof(T)};
  const cuuint32_t box[3] = {R::kBoxCols, R::kBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(weights), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int MT, bool kVec>
cudaError_t launch(const void* tokens, const void* weights, void* out, int E, int C, int dm,
                   int f, int64_t tok_e_stride, int64_t tok_c_stride, int depth, const Walk& walk,
                   cudaStream_t stream) {
  CUtensorMap wmap{};
  if constexpr (kVec) {
    const cudaError_t err = weight_map<T, MT>(&wmap, weights, E, dm, f);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = smem_bytes(static_cast<int>(sizeof(T)), MT, depth);
  auto kernel = gmm_kernel<T, MT, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<walk.blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(weights), static_cast<T*>(out), C, dm,
      f, tok_e_stride, tok_c_stride, depth, walk, wmap);
  return cudaGetLastError();
}

template <typename T, int MT, bool kVec>
cudaError_t occupancy(int depth, int* blocks_per_sm) {
  const size_t smem = smem_bytes(static_cast<int>(sizeof(T)), MT, depth);
  auto kernel = gmm_kernel<T, MT, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

// Expands to `return CALL(T, MT, VEC);` for the run-time dtype (0 =
// float32, 1 = bfloat16), mt (1 or 2) and vec.
#define REPRO_DISPATCH(CALL)                                                       \
  if (dtype == 0) {                                                                \
    if (mt == 1) return vec ? CALL(float, 1, true) : CALL(float, 1, false);        \
    return vec ? CALL(float, 2, true) : CALL(float, 2, false);                     \
  }                                                                                \
  if (mt == 1) return vec ? CALL(__nv_bfloat16, 1, true) : CALL(__nv_bfloat16, 1, false); \
  return vec ? CALL(__nv_bfloat16, 2, true) : CALL(__nv_bfloat16, 2, false)

bool valid(int dtype, int mt, int depth) {
  return (dtype == 0 || dtype == 1) && (mt == 1 || mt == 2) && depth >= 1 &&
         depth <= repro::kMaxDepth;
}

}  // namespace

// The persistent grid's walk (moe_gmm.py:walk): `blocks` blocks of 160
// threads over `tiles` output tiles (n_col column tiles x n_tok token tiles
// per expert) of `per_tile` k-slices each. dtype: 0 = float32, 1 =
// bfloat16; mt: 16-row token tiles per tile (1 or 2); vec: 1 if every row
// and base pointer allows 16-byte copies. Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int repro_moe_gmm(const void* tokens, const void* weights, void* out, int C, int dm,
                             int f, long long tok_e_stride, long long tok_c_stride, int depth,
                             int dtype, int mt, int vec, int blocks, long long tiles,
                             long long per_tile, int n_col, int n_tok, void* stream) {
  if (!valid(dtype, mt, depth) || C < 1 || dm < 0 || f < 1 || blocks < 1 || per_tile < 1 ||
      tiles < blocks || n_col != (f + kBN - 1) / kBN || n_tok != (C + 16 * mt - 1) / (16 * mt) ||
      tiles % (static_cast<long long>(n_col) * n_tok) != 0 ||
      per_tile * (128 / (dtype ? 2 : 4)) < dm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Walk walk{tiles, per_tile, blocks, n_col, n_tok};
  const int E = static_cast<int>(tiles / (static_cast<long long>(n_col) * n_tok));
  if (dm == 0) vec = 0;  // no tensor map of an empty matrix: the element-wise path
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&]() -> cudaError_t {
#define REPRO_LAUNCH(T, MT, VEC)                                                               \
  launch<T, MT, VEC>(tokens, weights, out, E, C, dm, f, tok_e_stride, tok_c_stride, depth, \
                     walk, s)
    REPRO_DISPATCH(REPRO_LAUNCH);
#undef REPRO_LAUNCH
  };
  return static_cast<int>(run());
}

// The blocks of the kernel for (dtype, mt, vec) at `depth` that fit one SM
// at once (registers, shared memory and threads), into *blocks_per_sm.
extern "C" int repro_moe_gmm_occupancy(int dtype, int mt, int vec, int depth,
                                       int* blocks_per_sm) {
  if (!valid(dtype, mt, depth)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&]() -> cudaError_t {
#define REPRO_OCCUPANCY(T, MT, VEC) occupancy<T, MT, VEC>(depth, blocks_per_sm)
    REPRO_DISPATCH(REPRO_OCCUPANCY);
#undef REPRO_OCCUPANCY
  };
  return static_cast<int>(run());
}
