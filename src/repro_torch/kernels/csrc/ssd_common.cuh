// Helpers shared by the chunked SSD scan (ssd_scan/csrc/ssd_scan.cu) and
// its backward (ssd_scan/csrc/ssd_scan_bwd.cu): dt as one ring word a
// row, L2 prefetches, zero padding and cp.async copies of row tiles spread
// over a block of kT threads, and the tensor-core pieces (ldmatrix,
// mma.sync m16n8k16 with bf16 inputs and f32 accumulators, an f32 pair
// split into bf16 high and low parts). Each source includes it inside
// its anonymous namespace, after cuda_bf16.h and coro_ring.cuh.

#pragma once

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// dt of one row: one 4-byte ring word. An f32 value is the word; a bf16
// value is copied with the aligned word that holds it (the shared ring's
// 2-byte unit) and shifted out on read.
template <typename TD>
struct DtUnit;

template <>
struct DtUnit<float> {
  static __device__ __forceinline__ void load(uint32_t* s, const float* g) {
    repro::cp_async4(s, g);
  }
  static __device__ __forceinline__ float read(const uint32_t* s, const float*) {
    return __uint_as_float(*s);
  }
};

template <>
struct DtUnit<__nv_bfloat16> {
  using U = repro::Unit<uint16_t>;
  static __device__ __forceinline__ void load(uint32_t* s, const __nv_bfloat16* g) {
    U::load(s, reinterpret_cast<const uint16_t*>(g));
  }
  static __device__ __forceinline__ float read(const uint32_t* s, const __nv_bfloat16* g) {
    return __bfloat162float(__ushort_as_bfloat16(U::read(s, reinterpret_cast<const uint16_t*>(g))));
  }
};

// Start moving global bytes into L2 ahead of the cp.async that will copy
// them: one line, or (bulk) a contiguous run of 16-byte units.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void bulk_prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// The x rows [0, valid) of `head`, each 128-byte line of them, into L2.
template <int kT, typename T>
__device__ __forceinline__ void prefetch_rows(const T* xg, int64_t x_st, int valid, int P) {
  const int lines = (P * static_cast<int>(sizeof(T)) + 127) / 128;
  for (int e = threadIdx.x; e < valid * lines; e += kT) {
    const int r = e / lines;
    prefetch_l2(reinterpret_cast<const char*>(xg + r * x_st) + (e - r * lines) * 128);
  }
}

// Zero the padding of a [rows][stride] tile whose first `valid` rows hold
// `cols` values each: the rest of those rows, and every later row.
template <int kT, typename E>
__device__ __forceinline__ void zero_pad(E* tile, int rows, int stride, int valid, int cols) {
  const int w = stride - cols;
  for (int e = threadIdx.x; e < valid * w; e += kT) tile[(e / w) * stride + cols + e % w] = E(0.f);
  for (int e = valid * stride + threadIdx.x; e < rows * stride; e += kT) tile[e] = E(0.f);
}

// ---------------------------------------------------------- tensor cores

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::smem_addr(p)));
}

// d += a @ b for one 16x8x16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x for x <= 0 (one MUFU instruction; results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) as a bf16 pair `hi` and the pair of what it leaves, `lo`.
__device__ __forceinline__ void split(float u, float v, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  *hi = pack(h);
  *lo = pack(__floats2bfloat162_rn(u - __low2float(h), v - __high2float(h)));
}

// f(r, u) for every r < rows and u < units, spread over kT threads; where
// units divides kT (every width here but a few) a thread keeps one u and
// steps r, with no division in the loop.
template <int kT, typename F>
__device__ __forceinline__ void for_rows(int rows, int units, F f) {
  if (kT % units == 0) {
    const int u = threadIdx.x % units;
    for (int r = threadIdx.x / units; r < rows; r += kT / units) f(r, u);
  } else {
    for (int e = threadIdx.x; e < rows * units; e += kT) f(e / units, e % units);
  }
}

// cp.async rows [0, rows) of `cols` values (whole 16-byte units) from
// global memory (row stride `gs`) into a shared tile (row stride `ss`).
template <int kT, typename E>
__device__ __forceinline__ void copy_rows(E* tile, int ss, const E* g, int64_t gs, int rows,
                                          int cols) {
  constexpr int v = 16 / sizeof(E);
  for_rows<kT>(rows, cols / v, [&](int r, int u) {
    repro::cp_async16(tile + r * ss + u * v, g + r * gs + u * v);
  });
}
