// Flash-decode attention for Hopper (sm_90a), over a dense KV cache (K3)
// and over a paged one (K1): one split body, two row functions.
//
// Replaces the TPU kernels
//   src/repro/kernels/decode_attention/decode_attention.py:flash_decode (K3)
//   src/repro/kernels/decode_attention/decode_attention.py:paged_flash_decode (K1).
// For each sequence b and query head h of KV group kh = h / G both compute
//
//   o[b, h] = softmax_j(q[b, h] . K[b, j, kh] * D^-0.5) V[b, j, kh]   over j < n_keys(b)
//
// with an f32 online softmax (m, l, acc) and the output acc / max(l, 1e-30)
// cast to the input type. K3 reads caches [B, S, KH, D] up to one scalar
// `pos` for the whole batch: n_keys = min(pos + 1, S) for every b, with pos
// read from a device int32 inside the kernel (the TPU kernel takes it as a
// scalar-prefetched array). K1 reads pools [NB, page, KH, D] through a
// block table [B, M]: key j of request b is row j % page of page
// block_tables[b, j / page], and n_keys(b) is lengths[b] (clamped to
// [0, M * page]), read from the device array inside the kernel. Neither
// launch takes a value that changes from one decode step to the next, so
// both replay in a captured CUDA graph. The dense serving engine runs K3
// and the paged one K1, for every attention layer of every decode step.
//
// What bounds it: bytes. Each key row is read once and used for G query
// heads (2 * G flops per byte in bf16), far below the ~295 flops/byte at
// which the H100 becomes compute-bound, so its floor is the live K/V rows
// over 3.35 TB/s: 17.2 MB, 5.1 us at yi-6b's batch-8 dense decode shape.
// One SM pulls only ~30 GB/s, so the card reaches its rate only with every
// SM loading, and a call this short also pays for its launches and its
// epilogue. What the design does about it:
//   * the sequence is split over blocks (flash-decoding): the grid is
//     (B * KH, n_split), each split a contiguous range of `blk`-row tiles,
//     so that B * KH = 32 (yi-6b at batch 8) still puts two or more blocks
//     on every one of the 132 SMs. The host plans n_split from B, KH, the
//     rows the cache can hold (S, or M * page), blk and the SM count; the
//     grid never depends on pos or on the lengths, which the host does not
//     read. Each split leaves an f32 partial (m, l, acc) per head; a second
//     kernel here, one block per (b, kh, head) and one thread per column,
//     merges a head's partials with the rescale exp(m_i - m). With one
//     split the split pass writes the output itself and no merge runs;
//   * both kernels are launched with programmatic dependent launch: each
//     is scheduled while the kernel before it still runs and waits
//     (griddepcontrol.wait) before its first read, so neither launch's
//     latency lies between two kernels on the device;
//   * a ring of `depth` K and V tiles in shared memory is kept in flight
//     with cp.async (the shared coro_ring.cuh); `depth` is the host's
//     solved pipeline depth, clamped to the tiles of one split. A split
//     loads only rows below its sequence's n_keys: no row past it is ever
//     read, and a split wholly past it writes an empty partial (m = -1e30,
//     l = 0, acc = 0);
//   * bf16 runs both products on the tensor cores with
//     mma.sync.m16n8k16 (f32 accumulate), query heads as the M dimension
//     (G padded to 16; G = 32 takes two M tiles; wgmma's 64-row tile would
//     be three quarters padding, for no gain on memory-bound work). Each
//     warp takes 16 key rows at a time: the scores Q K^T from the query,
//     held unscaled in registers as A fragments, and K read with ldmatrix;
//     D^-0.5 (and log2 e, for exp2) scales the f32 scores. The online
//     softmax runs on the score fragments in registers with quad shuffles
//     only. P is rounded to bf16 and reused in registers as the A operand
//     of P V, with V read by ldmatrix.trans. That rounding of P (relative
//     2^-9) is the one the reference engine's own decode attention makes
//     when it casts P to q's type before P V (models/common.py:
//     _single_decode). K/V rows sit 16 bytes apart from a multiple of 128,
//     so ldmatrix's eight row reads hit distinct banks;
//   * f32 runs the same split, ring and merge on CUDA cores, the query in
//     registers, one warp reduction per (row, head): a correctness path
//     (TF32 would round q and K to 10 bits of mantissa);
//   * every warp keeps its own (m, l, acc) over its rows; the block merges
//     its four warps through shared memory once, after its last tile, with
//     each head's warp weights computed once and the scratch rows padded
//     off a single bank.
// K3 may also write each head's log-sum-exp of its scaled scores over the
// live keys, lse = m + log(l) in the natural log (m back from the log2
// domain), as f32 [B, H]: -inf, with an output of 0, for a head with no
// live key. The one split writes it beside its output, the merge kernel
// beside the merged one. A sequence-sharded decode runs K3 on each shard
// of the cache and merges the shards' (o, lse) (models/common.py:
// _decode_core); K1 passes no lse and writes none.
// Every K/V row address comes from one device function, the kernel's row
// function: DenseRows for the dense cache, PagedRows for the block table.
// The page size is any positive integer, independent of `blk`: each row is
// addressed on its own, so a tile may span several pages. A paged block
// copies its split's slice of the table row (at most
// (tiles_per_split * blk - 1) / page + 2 entries) into shared memory once,
// in the prologue, while it also reads its request's length and its query.
// So no cp.async waits behind a dependent global load of the table: chosen
// over computing the page once per row because each thread issues one
// 16-byte chunk of a row, so a page computed per row would still put a
// global load in front of every row's copies, in every tile; the slice
// costs one round trip per block and 4 bytes of shared memory an entry.
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

constexpr int kThreads = 128;  // four warps, each over its own 16-row chunks of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 16;  // key rows a warp takes at a time (the mma K of P V)
constexpr int kMaxGroup = 32;  // query heads per KV head this kernel takes
constexpr int kMaxGroupWide = 16;  // ... at head dim 256 (one bf16 M tile)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kAccPad = 8;  // floats after each head row of the merge scratch

// Dynamic shared memory: the paged row function's slice of the block table
// (`slots` ints, a multiple of four; none for the dense cache), then a K ring
// and a V ring ([depth][blk][D + pad] each, input type, rows padded by 16
// bytes); after the last tile the ring's bytes hold every warp's f32
// (m [GP], l [GP], acc [GP][D + kAccPad]) for the block's merge. GP is G
// padded: to 16 or 32 in bf16, to a power of two in f32. The kAccPad floats
// of padding put the eight head rows of an m16n8 fragment's stores on
// different banks (unpadded, D = 128 puts them all on one). The same formula
// is repro_torch/kernels/decode_attention/decode_attention.py:_flash_smem_bytes.
size_t smem_bytes(int GP, int D, int blk, int depth, int itemsize, int slots) {
  const size_t ring = static_cast<size_t>(2) * depth * blk * (D + 16 / itemsize) * itemsize;
  const size_t merge = sizeof(float) * kWarps * static_cast<size_t>(GP) * (D + kAccPad + 2);
  return sizeof(int) * static_cast<size_t>(slots) + (ring > merge ? ring : merge);
}

// The row functions. keys(b) is sequence b's live key count; bind() runs
// once per block, in the prologue, and returns the function the block's
// copies address with; operator() is the element offset of key row `row`
// of sequence b, KV head kh: the only place the kernel computes a K/V
// address.

// A dense [B, S, KH, D] cache attended up to one position for the batch.
// The position is a device scalar, read by every block after its
// griddepcontrol.wait (the kernel before may have written it), so that a
// captured launch reads each replay's value; past S every row is live.
struct DenseRows {
  static constexpr bool kTable = false;
  const int* last;  // pos, the last key position attended
  int S, KH, D;
  __device__ __forceinline__ int keys(int) const {
    const int64_t pos = *last;
    return pos < 0 ? 0 : static_cast<int>(pos + 1 < S ? pos + 1 : S);
  }
  __device__ __forceinline__ int table_bytes() const { return 0; }
  __device__ __forceinline__ DenseRows bind(int*, int, int, int) const { return *this; }
  __device__ __forceinline__ int64_t operator()(int b, int row, int kh) const {
    return ((static_cast<int64_t>(b) * S + row) * KH + kh) * D;
  }
};

// Pools [NB, page, KH, D] through a block table [B, M] and per-request
// lengths [B]. bind() copies entries [page0, page0 + slots) of sequence b's
// table row (clamped to its last entry) into shared memory; the slots cover
// every page the split's rows touch.
struct PagedRows {
  static constexpr bool kTable = true;
  const int* bt;
  const int* lengths;
  int M, page, KH, D, slots;
  const int* table;  // after bind(): the slice in shared memory
  int page0;
  __device__ __forceinline__ int keys(int b) const {
    return max(0, min(lengths[b], M * page));
  }
  __device__ __forceinline__ int table_bytes() const { return static_cast<int>(sizeof(int)) * slots; }
  __device__ __forceinline__ PagedRows bind(int* smem_table, int b, int row0, int tid) const {
    PagedRows r = *this;
    r.page0 = row0 / page;
    const int* row_bt = bt + static_cast<int64_t>(b) * M;
    for (int i = tid; i < slots; i += kThreads) smem_table[i] = row_bt[min(r.page0 + i, M - 1)];
    r.table = smem_table;
    return r;
  }
  __device__ __forceinline__ int64_t operator()(int, int row, int kh) const {
    const int p = row / page;
    return ((static_cast<int64_t>(table[p - page0]) * page + (row - p * page)) * KH + kh) * D;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a @ b for one 16x8x16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One warp's online softmax over the key rows it is given, on the tensor
// cores (bf16). MT M tiles of 16 query heads. Fragment layouts are PTX's
// for m16n8k16: lane = 4 * g + t holds rows g and g + 8, columns 2t, 2t + 1.
template <int D, int MT>
struct MmaWarp {
  static constexpr int kStride = D + 8;  // elements between rows in the ring
  uint32_t qa[MT][D / 16][4];            // q, A fragments over the head dim
  float acc[MT][D / 8][4];               // P V, C fragments over the head dim
  float m[MT][2], l[MT][2];              // rows g and g + 8; l is this lane's part

  __device__ __forceinline__ void init(const __nv_bfloat16* qg, int G, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = mt * 16 + g + 8 * (e & 1);
          const int d = kk * 16 + 2 * t + 8 * (e >> 1);
          qa[mt][kk][e] = h < G ? *reinterpret_cast<const uint32_t*>(qg + h * D + d) : 0u;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[mt][r] = kNegInf;
        l[mt][r] = 0.f;
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][dn][e] = 0.f;
    }
  }

  // Key rows ks[0 .. 16) of which the first `live` exist (V rows past them
  // are zero in the ring; K rows past them score -1e30).
  __device__ __forceinline__ void chunk(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                        int live, float scale_log2, int lane) {
    const int t = lane & 3;
    const int j = lane >> 3, r8 = lane & 7;  // the 8x8 matrix and row this lane addresses
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
    // S = Q K^T: per 16 of the head dim, one ldmatrix gives the B fragments
    // of key rows 0-7 ({kb0, kb1}) and 8-15 ({kb2, kb3}).
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + ((j >> 1) * 8 + r8) * kStride + kk * 16 + (j & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][0], qa[mt][kk], kb);
        mma_bf16(s[mt][1], qa[mt][kk], kb + 2);
      }
    }
    // Scale into the log2 domain, mask, and update each head row's state.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][nt][e] = nt * 8 + 2 * t + (e & 1) < live ? s[mt][nt][e] * scale_log2 : kNegInf;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(s[mt][0][2 * r], s[mt][0][2 * r + 1]),
                         fmaxf(s[mt][1][2 * r], s[mt][1][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);
        const float corr = exp2f(m[mt][r] - m_new);
        m[mt][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[mt][nt][2 * r + c] - m_new);
            s[mt][nt][2 * r + c] = p;
            sum += p;
          }
        l[mt][r] = l[mt][r] * corr + sum;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[mt][dn][2 * r] *= corr;
          acc[mt][dn][2 * r + 1] *= corr;
        }
      }
    }
    // O += P V: the score fragments of key rows 0-7 and 8-15 are the A
    // fragment of one k16 step; per 16 of the head dim, one ldmatrix.trans
    // gives the B fragments of columns 0-7 ({vb0, vb1}) and 8-15 ({vb2, vb3}).
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + ((j & 1) * 8 + r8) * kStride + dp * 16 + (j >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * dp], pa[mt], vb);
        mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb + 2);
      }
    }
  }

  // This warp's (m, l, acc) into shared memory: m, l [GP], acc [GP][D + kAccPad].
  __device__ __forceinline__ void store(float* sm_m, float* sm_l, float* sm_acc, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[mt][r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int h = mt * 16 + g + 8 * r;
        if (t == 0) {
          sm_m[h] = m[mt][r];
          sm_l[h] = lr;
        }
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          *reinterpret_cast<float2*>(sm_acc + h * (D + kAccPad) + dn * 8 + 2 * t) =
              make_float2(acc[mt][dn][2 * r], acc[mt][dn][2 * r + 1]);
      }
    }
  }
};

// The same state on CUDA cores (f32): lane owns head-dim columns lane,
// lane + 32, ... of every head; one warp reduction per (row, head) gives a
// score, and every lane then holds the same m and l.
template <int D, int GP_>
struct SimtWarp {
  static constexpr int GP = GP_;
  static constexpr int kStride = D + 4;
  static constexpr int kDPerLane = (D + 31) / 32;
  float qr[GP][kDPerLane], acc[GP][kDPerLane];
  float m[GP], l[GP];
  int G;

  __device__ __forceinline__ void init(const float* qg, int G_, int lane) {
    G = G_;
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int x = 0; x < kDPerLane; ++x) {
        const int d = lane + 32 * x;
        qr[g][x] = g < G && d < D ? qg[g * D + d] : 0.f;
        acc[g][x] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void chunk(const float* ks, const float* vs, int live,
                                        float scale_log2, int lane) {
    for (int jr = 0; jr < live; ++jr) {
      float kv[kDPerLane], vv[kDPerLane];
#pragma unroll
      for (int x = 0; x < kDPerLane; ++x) {
        const int d = lane + 32 * x;
        kv[x] = d < D ? ks[jr * kStride + d] : 0.f;
        vv[x] = d < D ? vs[jr * kStride + d] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int x = 0; x < kDPerLane; ++x) part += qr[g][x] * kv[x];
          const float sc = warp_sum(part) * scale_log2;
          const float m_new = fmaxf(m[g], sc);
          const float corr = exp2f(m[g] - m_new);
          const float p = exp2f(sc - m_new);
          m[g] = m_new;
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int x = 0; x < kDPerLane; ++x) acc[g][x] = acc[g][x] * corr + p * vv[x];
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* sm_m, float* sm_l, float* sm_acc, int lane) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (lane == 0) {
        sm_m[g] = m[g];
        sm_l[g] = l[g];
      }
#pragma unroll
      for (int x = 0; x < kDPerLane; ++x) {
        const int d = lane + 32 * x;
        if (d < D) sm_acc[g * (D + kAccPad) + d] = acc[g][x];
      }
    }
  }
};

template <typename T, int D, int GP>
struct WarpOf {
  using type = SimtWarp<D, GP>;
};
template <int D, int GP>
struct WarpOf<__nv_bfloat16, D, GP> {
  using type = MmaWarp<D, GP / 16>;
};

// A head's log-sum-exp from its max score M (log2 domain) and its sum L of
// exp2(score - M): -inf when no key is live (L = 0).
__device__ __forceinline__ float head_lse(float M, float L) {
  return L > 0.f ? (M + log2f(L)) * kLn2 : __int_as_float(0xff800000);
}

// The f32 partials of B * KH * n_split (b, kh, split) rows: acc [rows][G][D],
// then m [rows][G], then l [rows][G].
template <typename F>
struct Partials {
  F *acc, *m, *l;
  __device__ __forceinline__ Partials(F* part, int rows, int G, int D)
      : acc(part), m(part + static_cast<int64_t>(rows) * G * D), l(m + static_cast<int64_t>(rows) * G) {}
};

// Grid (B * KH, n_split): block (bkh, split) walks the key rows
// [split * tiles_per_split * blk, ...) of sequence b = bkh / KH, KV head
// kh = bkh % KH, up to n_keys = layout.keys(b).
template <typename T, int D, int GP, typename Rows>
__global__ void __launch_bounds__(kThreads)
    flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache, T* __restrict__ out,
                       float* __restrict__ lse, float* __restrict__ part, Rows layout,
                       int H, int KH, int blk,
                       int tiles_per_split, int depth, float scale_log2) {
  using Warp = typename WarpOf<T, D, GP>::type;
  constexpr int kStride = Warp::kStride;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements per 16 B copy
  constexpr int kChunksPerRow = D / kChunk;
  const int bkh = blockIdx.x;
  const int b = bkh / KH;
  const int kh = bkh - b * KH;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / KH;
  const int tile_elems = blk * kStride;
  // Programmatic dependent launch (see launch_pdl): wait for the kernel
  // before this one in the stream (it wrote q and the new cache row) before
  // the first read, then let the merge kernel be scheduled; its blocks wait
  // in griddepcontrol.wait until this grid has finished and its writes are
  // visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* body = smem + layout.table_bytes();  // the ring, then the merge scratch
  T* k_ring = reinterpret_cast<T*>(body);
  T* v_ring = k_ring + static_cast<size_t>(depth) * tile_elems;

  // This split's live key rows [row0, row_end), and its row function.
  const int row0 = split * tiles_per_split * blk;
  const int n_keys = layout.keys(b);
  const int row_end = min(n_keys, row0 + tiles_per_split * blk);
  const int n_tiles = row_end > row0 ? (row_end - row0 + blk - 1) / blk : 0;
  const Rows row_of = layout.bind(reinterpret_cast<int*>(smem), b, row0, tid);

  // Start the copies of this split's tile `tile` into ring slot `slot`: its
  // live rows, 16 B per cp.async. V rows from the last live one to the end
  // of its 16-row chunk are zeroed (P is 0 there, and 0 * garbage may be
  // NaN); rows past n_keys are never loaded.
  auto issue = [&](int tile, int slot) {
    const int first = row0 + tile * blk;
    const int rows = min(blk, row_end - first);
    const int padded = min(blk, (rows + kChunkRows - 1) / kChunkRows * kChunkRows);
    T* ks = k_ring + static_cast<size_t>(slot) * tile_elems;
    T* vs = v_ring + static_cast<size_t>(slot) * tile_elems;
    for (int c = tid; c < rows * kChunksPerRow; c += kThreads) {
      const int row = c / kChunksPerRow;
      const int col = (c - row * kChunksPerRow) * kChunk;
      const int64_t src = row_of(b, first + row, kh) + col;
      cp_async16(ks + row * kStride + col, k_cache + src);
      cp_async16(vs + row * kStride + col, v_cache + src);
    }
    for (int c = rows * kChunksPerRow + tid; c < padded * kChunksPerRow; c += kThreads) {
      const int row = c / kChunksPerRow;
      const int col = (c - row * kChunksPerRow) * kChunk;
      *reinterpret_cast<uint4*>(vs + row * kStride + col) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // Prologue: the query of this KV group, fresh state, and the first
  // `depth` tiles in flight. Every slot commits one group, empty or not,
  // so that group i always holds tile i.
  const int64_t q_off = static_cast<int64_t>(bkh) * G * D;  // (b * H + kh * G) * D
  Warp st;
  st.init(q + q_off, G, lane);
  if constexpr (Rows::kTable) __syncthreads();  // the table slice is in shared memory
  for (int s = 0; s < depth; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % depth;
    const int rows = min(blk, row_end - (row0 + i * blk));
    cp_async_wait_pending(depth - 1);  // tile i has landed (this thread's part)
    __syncthreads();                   // ... and every other thread's part
    const T* ks = k_ring + static_cast<size_t>(slot) * tile_elems;
    const T* vs = v_ring + static_cast<size_t>(slot) * tile_elems;
    for (int c = warp * kChunkRows; c < rows; c += kWarps * kChunkRows)
      st.chunk(ks + c * kStride, vs + c * kStride, min(kChunkRows, rows - c), scale_log2, lane);
    __syncthreads();  // the slot is free again

    if (i + depth < n_tiles) issue(i + depth, slot);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's bytes now hold the warps' states

  constexpr int kWP = GP;
  float* sm_m = reinterpret_cast<float*>(body);
  float* sm_l = sm_m + kWarps * kWP;
  float* sm_acc = sm_l + kWarps * kWP;
  st.store(sm_m + warp * kWP, sm_l + warp * kWP, sm_acc + warp * kWP * (D + kAccPad), lane);
  __syncthreads();

  // Merge the four warps. Thread h < G turns head h's m_w into the weight
  // exp(m_w - M) in place and leaves L in sm_l[h], M in sm_l[kWP + h]; then
  // every column is a weighted sum: the output (one split) or this split's
  // partial.
  if (tid < G) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * kWP + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(sm_m[w * kWP + tid] - M);
      sm_m[w * kWP + tid] = wt;
      L += sm_l[w * kWP + tid] * wt;
    }
    sm_l[tid] = L;
    sm_l[kWP + tid] = M;
    if (lse != nullptr && n_split == 1) lse[static_cast<int64_t>(bkh) * G + tid] = head_lse(M, L);
  }
  __syncthreads();
  const Partials<float> pt(part, gridDim.x * n_split, G, D);
  const int64_t prow = static_cast<int64_t>(bkh) * n_split + split;
  for (int e = tid; e < G * D; e += kThreads) {
    const int h = e / D;
    const int d = e - h * D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) A += sm_acc[(w * kWP + h) * (D + kAccPad) + d] * sm_m[w * kWP + h];
    if (n_split == 1) {
      out[q_off + e] = from_f32<T>(A / fmaxf(sm_l[h], 1e-30f));
    } else {
      pt.acc[prow * G * D + e] = A;
      if (d == 0) {
        pt.m[prow * G + h] = sm_l[kWP + h];
        pt.l[prow * G + h] = sm_l[h];
      }
    }
  }
}

// Grid (B * KH, G), D threads: block (bkh, h) merges head h's n_split
// partials, thread d its column:
//   o = sum_i acc_i exp(m_i - m) / max(sum_i l_i exp(m_i - m), 1e-30),
// m = max_i m_i (m in the log2 domain). Where a sequence has a live key,
// m is finite and an empty partial (m_i = -1e30) weighs exp2(-1e30 - m) = 0.
// A paged request of length 0 has no live key: every partial is empty, so
// m = -1e30, every weight is exp2(0) = 1, the sum of l is 0 and o = 0 /
// 1e-30 = 0, finite (the engine pads a round with such rows). The loads of
// different splits are independent, so an unrolled loop keeps several in
// flight. kMaxD bounds the block: 128 threads up to head dim 128, 256 at
// head dim 256.
template <typename T, int kMaxD>
__global__ void __launch_bounds__(kMaxD)
    flash_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                       float* __restrict__ lse, int n_split) {
  const int bkh = blockIdx.x, h = blockIdx.y, G = gridDim.y;
  const int d = threadIdx.x, D = blockDim.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the split pass is done
  const Partials<const float> pt(part, gridDim.x * n_split, G, D);
  const int64_t first = static_cast<int64_t>(bkh) * n_split;
  float M = kNegInf;
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, pt.m[(first + i) * G + h]);
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) {
    const float m_i = pt.m[(first + i) * G + h];
    const float w = exp2f(m_i - M);
    L += pt.l[(first + i) * G + h] * w;
    A += pt.acc[((first + i) * G + h) * D + d] * w;
  }
  out[(static_cast<int64_t>(bkh) * G + h) * D + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  if (lse != nullptr && d == 0) lse[static_cast<int64_t>(bkh) * G + h] = head_lse(M, L);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;  // K3's optional [B, H] log-sum-exp; null for K1
  float* part;
  int B, H, KH, blk, n_split, tiles_per_split, depth;
  float scale_log2;
  cudaStream_t stream;
};

// Launch with programmatic dependent launch allowed (Hopper): the grid may
// be scheduled while the kernel before it in the stream is still running,
// and each kernel here waits (griddepcontrol.wait) for that one's results
// before it reads them. It hides a launch's latency behind the previous
// kernel: about 1.5 us a call at the dense path's shape (PERF.md).
template <typename... Params, typename... Actual>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                       cudaStream_t stream, Actual... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int D, int GP, typename Rows>
cudaError_t launch(const Args& a, const Rows& rows, int slots) {
  const size_t smem = smem_bytes(GP, D, a.blk, a.depth, static_cast<int>(sizeof(T)), slots);
  auto kernel = flash_split_kernel<T, D, GP, Rows>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = launch_pdl(kernel, dim3(a.B * a.KH, a.n_split), kThreads, smem, a.stream,
                   static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                   static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.part, rows, a.H,
                   a.KH,
                   a.blk, a.tiles_per_split, a.depth, a.scale_log2);
  if (err != cudaSuccess || a.n_split == 1) return err;
  return launch_pdl(flash_merge_kernel<T, (D > 128 ? 256 : 128)>, dim3(a.B * a.KH, a.H / a.KH),
                    D, 0, a.stream,
                    static_cast<const float*>(a.part), static_cast<T*>(a.out), a.lse, a.n_split);
}

// G padded: to 16 or 32 query heads (M tiles) in bf16, a power of two in f32.
// At head dim 256 a warp's P V accumulator alone is 16 x 256 f32 (128
// registers a lane in bf16) and its query 64 more, so G stops at 16 there:
// a second M tile, or a 32-head f32 state, would live in local memory.
template <typename T, int D, typename Rows>
cudaError_t dispatch_g(int G, const Args& a, const Rows& rows, int slots) {
  constexpr bool kWide = D > 128;
  if (kWide && G > kMaxGroupWide) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (G <= 16) return launch<T, D, 16>(a, rows, slots);
    if constexpr (!kWide) return launch<T, D, 32>(a, rows, slots);
  } else {
    if (G <= 1) return launch<T, D, 1>(a, rows, slots);
    if (G <= 2) return launch<T, D, 2>(a, rows, slots);
    if (G <= 4) return launch<T, D, 4>(a, rows, slots);
    if (G <= 8) return launch<T, D, 8>(a, rows, slots);
    if (G <= 16) return launch<T, D, 16>(a, rows, slots);
    if constexpr (!kWide) return launch<T, D, 32>(a, rows, slots);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename Rows>
cudaError_t dispatch_d(int D, int G, const Args& a, const Rows& rows, int slots) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(G, a, rows, slots);
    case 32:
      return dispatch_g<T, 32>(G, a, rows, slots);
    case 64:
      return dispatch_g<T, 64>(G, a, rows, slots);
    case 128:
      return dispatch_g<T, 128>(G, a, rows, slots);
    case 256:
      return dispatch_g<T, 256>(G, a, rows, slots);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.
template <typename Rows>
int dispatch(int dtype, int D, const Args& a, const Rows& rows, int slots) {
  const int G = a.H / a.KH;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(D, G, a, rows, slots);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, G, a, rows, slots);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// What both entry points refuse: a batch, head layout, tile, ring or split
// plan the kernel does not take, or a missing partials buffer.
bool bad_launch(int B, int H, int KH, int blk, int depth, int n_split, int tiles_per_split,
                int64_t rows, const void* part) {
  return B < 1 || KH < 1 || H % KH != 0 || H / KH > kMaxGroup || blk < kChunkRows ||
         blk % kChunkRows != 0 || depth < 1 || depth > repro::kMaxDepth || n_split < 1 ||
         tiles_per_split < 1 || static_cast<int64_t>(n_split) * tiles_per_split * blk < rows ||
         (n_split > 1 && !part);
}

// The table slice one paged split copies: every page its rows can touch,
// min(M, (tiles_per_split * blk - 1) / page + 2) entries, rounded up to four
// (16 bytes, so the ring after it stays aligned). The same formula is
// repro_torch/kernels/decode_attention/decode_attention.py:_table_slots.
int table_slots(int M, int page, int blk, int tiles_per_split) {
  const int64_t touched = (static_cast<int64_t>(tiles_per_split) * blk - 1) / page + 2;
  const int64_t n = touched < M ? touched : M;
  return static_cast<int>((n + 3) / 4 * 4);
}

}  // namespace

// The grid of both entry points is (B * KH, n_split), split i walking tiles
// [i * tiles_per_split, (i + 1) * tiles_per_split) of `blk` rows, which
// must cover every row the cache holds (S, or M * page); `part` holds
// B * KH * n_split * G * (D + 2) floats (unused, and may be null, when
// n_split == 1). dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of the launches (0 on success); the caller raises on
// anything else.

// K3: caches [B, S, KH, D]. `pos` points to one int32 on the device: the
// last key position attended (keys at or past S do not exist: min(pos + 1,
// S) rows are live; none when it is negative, and the output is then 0). It
// is not read on the host, as K1's lengths are not. `lse`, when not null,
// receives each head's f32 log-sum-exp, [B, H].
extern "C" int repro_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                  void* out, void* lse, void* part, const void* pos, int B,
                                  int H, int KH,
                                  int D, int S, int blk, int n_split, int tiles_per_split,
                                  int depth, float scale, int dtype, void* stream) {
  if (S < 1 || !pos || bad_launch(B, H, KH, blk, depth, n_split, tiles_per_split, S, part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_cache, v_cache, out, static_cast<float*>(lse), static_cast<float*>(part),
               B, H, KH, blk, n_split, tiles_per_split, depth, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, DenseRows{static_cast<const int*>(pos), S, KH, D}, 0);
}

// K1: pools [NB, page, KH, D], block_tables [B, M] int32 (entries past a
// request's live pages are never used; the engine pads with page 0),
// lengths [B] int32: request b attends key positions < lengths[b] (all
// M * page of them when lengths[b] is larger; none when it is 0 or less,
// and its output is then 0). Neither array is read on the host. Any page
// size >= 1 and table width >= 1 with M * page below 2^31 are taken.
extern "C" int repro_paged_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                                        const void* block_tables, const void* lengths, void* out,
                                        void* part, int B, int H, int KH, int D, int page, int M,
                                        int blk, int n_split, int tiles_per_split, int depth,
                                        float scale, int dtype, void* stream) {
  const int64_t rows = static_cast<int64_t>(M) * page;
  if (page < 1 || M < 1 || rows > INT32_MAX || !block_tables || !lengths ||
      bad_launch(B, H, KH, blk, depth, n_split, tiles_per_split, rows, part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slots = table_slots(M, page, blk, tiles_per_split);
  const Args a{q, k_pool, v_pool, out, nullptr, static_cast<float*>(part), B, H, KH, blk,
               n_split, tiles_per_split, depth, scale * kLog2e, static_cast<cudaStream_t>(stream)};
  const PagedRows paged{static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
                        M, page, KH, D, slots, nullptr, 0};
  return dispatch(dtype, D, a, paged, slots);
}
