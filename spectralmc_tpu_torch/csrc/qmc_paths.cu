// The SOBOL_BB generator of the "cuda" port: scrambled Sobol words -> normals
// -> Brownian bridge (qmc_bridge_kernel), and the same generation fused with
// the flat log-Euler walk of a geometric Asian (qmc_walk_kernel).
//
// Replaces two kernels of the JAX package's ops/qmc_pallas.py:
//   * _bridge_block_kernel: for each Sobol point (= path) and each flat
//     dimension k = level·F + factor, the scrambled word
//     shift[k] ^ XOR_{bits b of gray(n)} V[k][b], the normal
//     √2·erf⁻¹(2u − 1) with u = (top 24 bits + 0.5)·2⁻²⁴ (the top bucket,
//     whose u rounds to 1, takes 1 − 2⁻²⁴), then per factor the [T, T] bridge
//     product out[t] = Σ_l B[t][l]·z[l] accumulated over l in order with one
//     rounding per multiply-add. Flat dimensions past the 64 of the Sobol
//     table come in as threefry normals (the pad input). Output [C, T, F,
//     count], coalesced along the point index.
//   * _walk_block_kernel: the same generation for one factor, then
//     log x ← (log x + drift) + vol√dt·eff[t] and acc ← acc + log x, with
//     every add and multiply rounded on its own (__fadd_rn, __fmul_rn), so
//     the result equals the bridge kernel's output walked by the torch scan
//     of ops/gbm.py bit for bit. One float per path is written.
// What they keep: the words, the inverse CDF (XLA's float32 erf⁻¹
// polynomial, as ops/rng.py::erf_inv writes it) and the bridge product of the
// TPU kernels. What they drop: the split-table blocking into 1024-point rows
// that fed the TPU's vector unit and the MXU dot. Here a bridge block takes
// 256 consecutive point indices aligned to 256, so the bits of gray(n) from
// bit 8 up are the block's: its threads XOR those directions once into
// c_hi[k] in shared memory, and each thread adds its own 8 low bits. For
// T <= 64 the bridge matrix sits transposed in shared memory (a level's
// column read as float4s) and a factor's T accumulators in registers; longer
// bridges accumulate in the output itself (same order, same roundings) with
// the matrix read through the read-only cache.
//
// Bound on Hopper: the bridge kernel writes T·F floats per path and its
// operations per path are about T·F·(8 word ops + ~30 for erf⁻¹ + T
// multiply-adds); at T = 16, F = 1 that is ~740 operations for 64 bytes, so
// on the card's 67 TFLOP/s and 3.35 TB/s it is bound by operations. The walk
// kernel writes 4 bytes per path and is bound by operations outright, so at
// the step counts whose bridge is a bisection of 2^m steps (T = 8, 16, 32,
// 64; the main path's is 16) it has an instantiation of its own,
// qmc_walk_sparse_kernel, that issues only the work its result needs:
//   * the bridge's exact zeros are skipped. B = brownian_bridge_matrix(T)
//     has m + 1 non-zeros a row (T = 16: 80 of 256): column 0, and at level
//     d = 1..m the column 2^(d-1) + (t >> (m - d + 1)) (bridge_col). That
//     pattern is fixed when compiling, so each row's multiply-adds, in
//     ascending column as the dense loop takes them, are unrolled onto
//     registers; fma(0, z, a) = a for finite z, so the sums are the dense
//     loop's bit for bit. The host launches this instantiation only where
//     the float32 matrix's zeros are exactly that pattern
//     (ops/qmc_cuda.py::sparse_walk); any other matrix or step count takes
//     the dense walk, qmc_walk_kernel.
//   * a thread takes kQuad = 2 consecutive points (a block 512, aligned to
//     512): the first point's word is c_hi[k] (gray bits from 9 up) XOR its
//     own bits 0..8, and the second follows from one XOR, gray(2q+1) =
//     gray(2q)^1 (with 4 points, gray(4q+2) = gray(4q+1)^2 and gray(4q+3) =
//     gray(4q+2)^1 add two more); a row's bridge values are read once for a
//     thread's points.
//   * each normal is made when its column first enters a row and dies when
//     the column's rows end, so m + 1 normals a point are live at a time;
//     with 2 points and a 32-register cap (kQuadMinBlocks = 8: every warp
//     slot of an SM filled) it ran 12.25 ms at 256 x 2048 x 512 points
//     against 14.04 for 4 points at 64 registers and half the slots, though
//     it issues 9% more a point (chip_variants.py; PERF.md §6).
// The bridge kernel has the same sparse instantiation at those step counts,
// qmc_bridge_sparse_kernel, launched under the same host check (sparse = 1,
// ops/qmc_cuda.py::sparse_walk); every other T or matrix keeps the dense
// qmc_bridge_kernel. A thread takes kQuad consecutive points with the
// Gray-stepped words of the flat dimensions the Sobol table covers (at most
// 64, the tables' kMaxDims rows); the dimensions from sdims up are read
// from the pad input per point. For each factor f in turn, row t's sum runs
// over its m + 1 non-zeros in ascending column, each normal (flat dimension
// l·F + f) made when its column enters and dropped after its last row, so
// the output is the dense kernel's and the twin's bit for bit. A factor none
// of whose dimensions is padded (the main path's every factor) runs a copy
// of its rows without the pad test, so its normals schedule as the walk's
// do. A thread stores its points' value of each (t, f) row as one float2
// where count and start keep the pair aligned (plain stores at the range's
// edges), so a warp's stores stay on consecutive addresses. It shares the
// walk's 32-register cap (kQuadMinBlocks): though it spills there, it ran
// within 1% of 40 registers or ahead, and ahead of 48 to 80 registers and of
// the dense kernel, at T = 16 and 64 (chip_variants.py on an NVIDIA H100;
// PERF.md §6).
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // points per block: one aligned run of 256 indices
constexpr int kLowBits = 8;
constexpr int kMaxDims = 64;   // the Sobol table's dimensions
constexpr int kBits = 32;

// XLA's float32 erf⁻¹ (Giles 2010), its two polynomials with one rounding per
// multiply-add.
__device__ __forceinline__ float erfinv_xla(float x) {
  const float w = -log1pf(-__fmul_rn(x, x));
  float p;
  if (w < 5.0f) {
    const float ws = w - 2.5f;
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, ws, 3.43273939e-07f);
    p = __fmaf_rn(p, ws, -3.5233877e-06f);
    p = __fmaf_rn(p, ws, -4.39150654e-06f);
    p = __fmaf_rn(p, ws, 0.00021858087f);
    p = __fmaf_rn(p, ws, -0.00125372503f);
    p = __fmaf_rn(p, ws, -0.00417768164f);
    p = __fmaf_rn(p, ws, 0.246640727f);
    p = __fmaf_rn(p, ws, 1.50140941f);
  } else {
    const float wl = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = __fmaf_rn(p, wl, 0.000100950558f);
    p = __fmaf_rn(p, wl, 0.00134934322f);
    p = __fmaf_rn(p, wl, -0.00367342844f);
    p = __fmaf_rn(p, wl, 0.00573950773f);
    p = __fmaf_rn(p, wl, -0.0076224613f);
    p = __fmaf_rn(p, wl, 0.00943887047f);
    p = __fmaf_rn(p, wl, 1.00167406f);
    p = __fmaf_rn(p, wl, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

// A Sobol word's normal: centered 24-bit uniform, top-bucket guard, √2·erf⁻¹.
__device__ __forceinline__ float word_normal(uint32_t w) {
  const uint32_t top = w >> 8;
  float x;
  if (top == 0xFFFFFFu) {
    x = 1.0f - 0x1p-24f;
  } else {
    const float u = __fmul_rn(__fadd_rn(static_cast<float>(top), 0.5f), 0x1p-24f);
    x = __fsub_rn(__fmul_rn(2.0f, u), 1.0f);
  }
  return __fmul_rn(1.41421356237309515f, erfinv_xla(x));
}

// What a block shares: the directions of the 8 low bits and c_hi[k] (the
// shift and the directions of the block's common gray bits).
struct BlockTables {
  uint32_t dir_lo[kMaxDims * kLowBits];
  uint32_t c_hi[kMaxDims];
};

// Fills the block's tables; base is the block's first point index.
__device__ __forceinline__ void fill_tables(BlockTables& tab, const uint32_t* __restrict__ dirs,
                                            const uint32_t* __restrict__ shift, int sdims,
                                            uint32_t base) {
  const uint32_t gray_hi = (base ^ (base >> 1)) & ~((1u << kLowBits) - 1u);
  for (int k = threadIdx.x; k < sdims; k += blockDim.x) {
    uint32_t acc = shift[k];
    for (int b = kLowBits; b < kBits; ++b) {
      if ((gray_hi >> b) & 1u) acc ^= dirs[k * kBits + b];
    }
    tab.c_hi[k] = acc;
#pragma unroll
    for (int b = 0; b < kLowBits; ++b) tab.dir_lo[k * kLowBits + b] = dirs[k * kBits + b];
  }
}

// One point's generator: its low gray bits as masks, its pad column.
struct Point {
  uint32_t mask[kLowBits];
  const float* pad;  // pad[(k - sdims)·count] is flat dimension k's normal, or null
  int64_t count;
  int sdims;

  __device__ __forceinline__ float normal(const BlockTables& tab, int k) const {
    if (k >= sdims) return pad[static_cast<int64_t>(k - sdims) * count];
    uint32_t w = tab.c_hi[k];
#pragma unroll
    for (int b = 0; b < kLowBits; ++b) w ^= mask[b] & tab.dir_lo[k * kLowBits + b];
    return word_normal(w);
  }
};

__device__ __forceinline__ Point point_of(uint32_t n, const float* pad, int64_t count, int sdims) {
  Point pt;
  const uint32_t g = n ^ (n >> 1);
#pragma unroll
  for (int b = 0; b < kLowBits; ++b) pt.mask[b] = 0u - ((g >> b) & 1u);
  pt.pad = pad;
  pt.count = count;
  pt.sdims = sdims;
  return pt;
}

// The bridge matrix transposed into shared memory, bbT[l·kMaxT + t] =
// B[t][l], zero past T, so that a level's column is kMaxT/4 aligned float4s.
template <int kMaxT>
__device__ __forceinline__ void fill_bridge(float* bbT, const float* __restrict__ bridge,
                                            int timesteps) {
  for (int i = threadIdx.x; i < kMaxT * kMaxT; i += blockDim.x) {
    const int l = i / kMaxT, t = i % kMaxT;
    bbT[i] = (l < timesteps && t < timesteps) ? bridge[t * timesteps + l] : 0.0f;
  }
}

// Factor f's bridged normals into acc[0..T): acc[t] = Σ_l B[t][l]·z[l·F + f]
// (acc[t] for t >= T stays 0).
template <int kMaxT>
__device__ __forceinline__ void bridge_factor(float (&acc)[kMaxT], const BlockTables& tab,
                                              const Point& pt, const float* bbT, int timesteps,
                                              int factors, int f) {
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) acc[t] = 0.0f;
  for (int l = 0; l < timesteps; ++l) {
    const float z = pt.normal(tab, l * factors + f);
    const float4* col = reinterpret_cast<const float4*>(bbT + l * kMaxT);
#pragma unroll
    for (int q = 0; q < kMaxT / 4; ++q) {
      const float4 b = col[q];
      acc[4 * q] = __fmaf_rn(b.x, z, acc[4 * q]);
      acc[4 * q + 1] = __fmaf_rn(b.y, z, acc[4 * q + 1]);
      acc[4 * q + 2] = __fmaf_rn(b.z, z, acc[4 * q + 2]);
      acc[4 * q + 3] = __fmaf_rn(b.w, z, acc[4 * q + 3]);
    }
  }
}

// The block's place: its first point index and this thread's point p
// (false when the thread's index lies outside [start, start + count)).
__device__ __forceinline__ bool locate(uint32_t start, int64_t count, uint32_t& base,
                                       int64_t& p) {
  const uint32_t lead = start & (kThreads - 1);
  base = (start - lead) + static_cast<uint32_t>(blockIdx.x) * kThreads;
  p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lead;
  return p >= 0 && p < count;
}

template <int kMaxT>
__global__ void qmc_bridge_kernel(const uint32_t* __restrict__ dirs,
                                  const uint32_t* __restrict__ shift,
                                  const float* __restrict__ bridge,
                                  const float* __restrict__ pad, float* __restrict__ out,
                                  uint32_t* __restrict__ words_out, int timesteps, int factors,
                                  int sdims, int64_t count, uint32_t start) {
  __shared__ BlockTables tab;
  __shared__ __align__(16) float bbT[kMaxT > 0 ? kMaxT * kMaxT : 4];
  const int c = blockIdx.y;
  uint32_t base;
  int64_t p;
  const bool mine = locate(start, count, base, p);
  fill_tables(tab, dirs, shift + static_cast<int64_t>(c) * sdims, sdims, base);
  if constexpr (kMaxT > 0) fill_bridge<kMaxT>(bbT, bridge, timesteps);
  __syncthreads();
  if (!mine) return;
  const int flat = timesteps * factors;
  const float* pad_c =
      pad == nullptr ? nullptr : pad + static_cast<int64_t>(c) * (flat - sdims) * count + p;
  const Point pt = point_of(base + threadIdx.x, pad_c, count, sdims);
  if (words_out != nullptr) {
    for (int k = 0; k < sdims; ++k) {
      uint32_t w = tab.c_hi[k];
      for (int b = 0; b < kLowBits; ++b) w ^= pt.mask[b] & tab.dir_lo[k * kLowBits + b];
      words_out[(static_cast<int64_t>(c) * sdims + k) * count + p] = w;
    }
  }
  float* out_c = out + static_cast<int64_t>(c) * flat * count + p;
  for (int f = 0; f < factors; ++f) {
    if constexpr (kMaxT > 0) {
      float acc[kMaxT];
      bridge_factor<kMaxT>(acc, tab, pt, bbT, timesteps, factors, f);
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < timesteps) out_c[static_cast<int64_t>(t * factors + f) * count] = acc[t];
      }
    } else {  // long bridges: the accumulators live in the output column
      for (int l = 0; l < timesteps; ++l) {
        const float z = pt.normal(tab, l * factors + f);
        for (int t = 0; t < timesteps; ++t) {
          float* o = out_c + static_cast<int64_t>(t * factors + f) * count;
          *o = __fmaf_rn(__ldg(bridge + t * timesteps + l), z, l == 0 ? 0.0f : *o);
        }
      }
    }
  }
}

template <int kMaxT>
__global__ void qmc_walk_kernel(const uint32_t* __restrict__ dirs,
                                const uint32_t* __restrict__ shift,
                                const float* __restrict__ bridge,
                                const float* __restrict__ scalars, float* __restrict__ out,
                                int timesteps, int64_t count, uint32_t start) {
  __shared__ BlockTables tab;
  __shared__ __align__(16) float bbT[kMaxT * kMaxT];
  const int c = blockIdx.y;
  uint32_t base;
  int64_t p;
  const bool mine = locate(start, count, base, p);
  fill_tables(tab, dirs, shift + static_cast<int64_t>(c) * timesteps, timesteps, base);
  fill_bridge<kMaxT>(bbT, bridge, timesteps);
  __syncthreads();
  if (!mine) return;
  const Point pt = point_of(base + threadIdx.x, nullptr, count, timesteps);
  float eff[kMaxT];
  bridge_factor<kMaxT>(eff, tab, pt, bbT, timesteps, 1, 0);
  const float log_spot = scalars[3 * c], drift = scalars[3 * c + 1],
              vol_sdt = scalars[3 * c + 2];
  float logx = log_spot, acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < timesteps) {
      logx = __fadd_rn(__fadd_rn(logx, drift), __fmul_rn(vol_sdt, eff[t]));
      acc = __fadd_rn(acc, logx);
    }
  }
  out[static_cast<int64_t>(c) * count + p] = acc;
}

// ---------------------------------------------------------------------------
// The sparse walk and bridge: T = 2^kLog steps, kQuad points a thread.
// ---------------------------------------------------------------------------

constexpr int kQuad = 2;                      // consecutive points a thread: 2 or 4
constexpr int kQuadBlock = kThreads * kQuad;  // points a block, aligned to it
constexpr int kQuadLowBits = kQuad == 2 ? 9 : 10;  // the gray bits a thread sets itself
constexpr int kQuadMinBlocks = 8;             // resident blocks an SM: the register cap

// Row t's non-zero at level d of brownian_bridge_matrix(2^log_t): column 0 at
// d = 0, else the d-th bisection's interval holding t (breadth first, left to
// right: column 2^(d-1) + j for the j-th interval of T >> (d - 1) steps).
__host__ __device__ constexpr int bridge_col(int log_t, int t, int d) {
  return d == 0 ? 0 : (1 << (d - 1)) + (t >> (log_t - d + 1));
}

// log2 of a sparse instantiation's step count.
__host__ __device__ constexpr int log2_steps(int t) {
  return t == 8 ? 3 : t == 16 ? 4 : t == 32 ? 5 : 6;
}

// What a sparse block shares: V[k][0..9] (padded to 12, three uint4 reads)
// and c_hi[k] for the kDims Sobol dimensions, and each of the kT rows' m + 1
// non-zeros (padded to 8, two float4 reads).
template <int kT, int kDims>
struct QuadTables {
  uint32_t dir[kDims][12];
  uint32_t c_hi[kDims];
  float row[kT][8];
};

// Fills a sparse block's tables: c_hi[k] is the contract's shift and the
// directions of the block's gray bits from kQuadLowBits up; base is the
// block's first point index.
template <int kT, int kDims>
__device__ __forceinline__ void fill_quad_tables(QuadTables<kT, kDims>& tab,
                                                 const uint32_t* __restrict__ dirs,
                                                 const uint32_t* __restrict__ shift_c, int sdims,
                                                 const float* __restrict__ bridge, uint32_t base) {
  constexpr int kLog = log2_steps(kT);
  constexpr int kLevels = kLog + 1;
  static_assert((1 << kLog) == kT && kLevels <= 8, "T = 8, 16, 32 or 64");
  const uint32_t gray_hi = (base ^ (base >> 1)) & ~(kQuadBlock - 1u);
  for (int k = threadIdx.x; k < sdims; k += blockDim.x) {
    uint32_t acc = shift_c[k];
    for (int b = kQuadLowBits; b < kBits; ++b) {
      if ((gray_hi >> b) & 1u) acc ^= dirs[k * kBits + b];
    }
    tab.c_hi[k] = acc;
#pragma unroll
    for (int b = 0; b < 12; ++b) tab.dir[k][b] = b < kQuadLowBits ? dirs[k * kBits + b] : 0u;
  }
  for (int i = threadIdx.x; i < kT * 8; i += blockDim.x) {
    const int t = i / 8, d = i % 8;
    tab.row[t][d] = d < kLevels ? bridge[t * kT + bridge_col(kLog, t, d < kLevels ? d : 0)]
                                : 0.0f;
  }
}

// The first point's low gray bits as masks (all ones where bit b is set).
__device__ __forceinline__ void quad_mask(uint32_t n0, uint32_t (&mask)[kQuadLowBits]) {
  const uint32_t g = n0 ^ (n0 >> 1);
#pragma unroll
  for (int b = 0; b < kQuadLowBits; ++b) mask[b] = 0u - ((g >> b) & 1u);
}

// The thread's points' words of dimension k: c_hi[k] XOR the first point's
// own gray bits (mask[b] all ones where bit b is set; bit 0 of gray(4q) is
// 0), then one direction a point: gray(n) ^ gray(n - 1) is bit ctz(n), so
// V[k][0] (and for 4 points then V[k][1] and V[k][0] again).
template <int kT, int kDims>
__device__ __forceinline__ void quad_words(const QuadTables<kT, kDims>& tab,
                                           const uint32_t (&mask)[kQuadLowBits], int k,
                                           uint32_t (&w)[kQuad]) {
  const uint4* v = reinterpret_cast<const uint4*>(tab.dir[k]);
  const uint4 a = v[0], b = v[1], c = v[2];
  const uint32_t dir[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
  uint32_t x = tab.c_hi[k];
#pragma unroll
  for (int bit = kQuad == 4 ? 1 : 0; bit < kQuadLowBits; ++bit) x ^= mask[bit] & dir[bit];
  w[0] = x;
#pragma unroll
  for (int i = 1; i < kQuad; ++i) w[i] = w[i - 1] ^ dir[(i & 1) ? 0 : 1];
}

// Row t's kLevels non-zeros, from the tables.
template <int kT, int kDims>
__device__ __forceinline__ void row_of(const QuadTables<kT, kDims>& tab, int t, float (&b)[8]) {
  const float4* r = reinterpret_cast<const float4*>(tab.row[t]);
  const float4 lo = r[0], hi = r[1];
  b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w;
  b[4] = hi.x, b[5] = hi.y, b[6] = hi.z, b[7] = hi.w;
}

// Row t's bridged normals of the thread's points: Σ_d B[t][col(t, d)]·z[col]
// over ascending d (ascending column), one rounding per multiply-add.
template <int kT, int kLevels>
__device__ __forceinline__ void bridge_row(const float (&b)[8], const float (&z)[kT][kQuad],
                                           int t, int log_t, float (&e)[kQuad]) {
#pragma unroll
  for (int i = 0; i < kQuad; ++i) e[i] = 0.0f;
#pragma unroll
  for (int d = 0; d < kLevels; ++d) {
    const int l = bridge_col(log_t, t, d);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) e[i] = __fmaf_rn(b[d], z[l][i], e[i]);
  }
}

template <int kT>
__global__ void __launch_bounds__(kThreads, kQuadMinBlocks) qmc_walk_sparse_kernel(
    const uint32_t* __restrict__ dirs, const uint32_t* __restrict__ shift,
    const float* __restrict__ bridge, const float* __restrict__ scalars,
    float* __restrict__ out, int64_t count, uint32_t start) {
  constexpr int kLog = log2_steps(kT);
  constexpr int kLevels = kLog + 1;
  __shared__ __align__(16) QuadTables<kT, kT> tab;
  const int c = blockIdx.y;
  const uint32_t lead = start & (kQuadBlock - 1);
  const uint32_t base = (start - lead) + static_cast<uint32_t>(blockIdx.x) * kQuadBlock;
  fill_quad_tables(tab, dirs, shift + static_cast<int64_t>(c) * kT, kT, bridge, base);
  __syncthreads();
  // this thread's points: p0 .. p0 + kQuad - 1 of [0, count)
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kQuadBlock + kQuad * threadIdx.x - lead;
  if (p0 + kQuad <= 0 || p0 >= count) return;
  uint32_t mask[kQuadLowBits];
  quad_mask(base + kQuad * threadIdx.x, mask);
  const float log_spot = scalars[3 * c], drift = scalars[3 * c + 1],
              vol_sdt = scalars[3 * c + 2];
  float z[kT][kQuad];
  float logx[kQuad], acc[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    logx[i] = log_spot;
    acc[i] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kT; ++t) {
#pragma unroll
    for (int d = 0; d < kLevels; ++d) {  // a column's normals when it enters
      const int span = d == 0 ? kT : kT >> (d - 1);
      if (t % span == 0) {
        const int l = bridge_col(kLog, t, d);
        uint32_t w[kQuad];
        quad_words(tab, mask, l, w);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) z[l][i] = word_normal(w[i]);
      }
    }
    float b[8];
    row_of(tab, t, b);
    float e[kQuad];
    bridge_row<kT, kLevels>(b, z, t, kLog, e);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      logx[i] = __fadd_rn(__fadd_rn(logx[i], drift), __fmul_rn(vol_sdt, e[i]));
      acc[i] = __fadd_rn(acc[i], logx[i]);
    }
  }
  float* out_c = out + static_cast<int64_t>(c) * count;
  const int64_t at = static_cast<int64_t>(c) * count + p0;
  if (p0 >= 0 && p0 + kQuad <= count && at % kQuad == 0) {  // one vector store
    if constexpr (kQuad == 4) {
      *reinterpret_cast<float4*>(out_c + p0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      *reinterpret_cast<float2*>(out_c + p0) = make_float2(acc[0], acc[1]);
    }
  } else {  // points on an edge of [start, start + count), or off the vector's alignment
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      if (p0 + i >= 0 && p0 + i < count) out_c[p0 + i] = acc[i];
    }
  }
}

// The thread's points' words of every Sobol dimension into words_out
// [sdims, count] (checks only).
template <int kT, int kDims>
__device__ __forceinline__ void copy_words(const QuadTables<kT, kDims>& tab,
                                           const uint32_t (&mask)[kQuadLowBits], int sdims,
                                           const bool (&in)[kQuad], int64_t count,
                                           uint32_t* __restrict__ words_c) {
  for (int k = 0; k < sdims; ++k) {
    uint32_t w[kQuad];
    quad_words(tab, mask, k, w);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      if (in[i]) words_c[static_cast<int64_t>(k) * count + i] = w[i];
    }
  }
}

// The thread's points' padded normals of one flat dimension (col: that
// dimension's row of the pad input at the first point); 0 off the range.
__device__ __forceinline__ void pad_normals(const float* __restrict__ col,
                                            const bool (&in)[kQuad], float (&z)[kQuad]) {
#pragma unroll
  for (int i = 0; i < kQuad; ++i) z[i] = in[i] ? col[i] : 0.0f;
}

// The thread's points' values of one output row: one vector store where
// the pair is aligned and whole, else one store a point on the range.
__device__ __forceinline__ void store_row(float* __restrict__ o, const float (&e)[kQuad],
                                          const bool (&in)[kQuad], bool vec) {
  if (vec) {
    if constexpr (kQuad == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(e[0], e[1], e[2], e[3]);
    } else {
      *reinterpret_cast<float2*>(o) = make_float2(e[0], e[1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      if (in[i]) o[i] = e[i];
    }
  }
}

// One factor's T rows of the thread's points, stored from o on (one row of
// paths every row_stride floats). Each normal is made when its column enters
// a row: flat dimension l·F + f, a Sobol word below sdims, else (kPadded:
// some of this factor's dimensions lie past the table) read from pad_c.
template <int kT, bool kPadded>
__device__ __forceinline__ void bridge_factor_rows(const QuadTables<kT, kMaxDims>& tab,
                                                   const uint32_t (&mask)[kQuadLowBits], int f,
                                                   int factors, int sdims,
                                                   const float* __restrict__ pad_c, int64_t count,
                                                   const bool (&in)[kQuad], bool vec,
                                                   float* __restrict__ o, int64_t row_stride) {
  constexpr int kLog = log2_steps(kT);
  constexpr int kLevels = kLog + 1;
  float z[kT][kQuad];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
#pragma unroll
    for (int d = 0; d < kLevels; ++d) {  // a column's normals when it enters
      const int span = d == 0 ? kT : kT >> (d - 1);
      if (t % span == 0) {
        const int l = bridge_col(kLog, t, d);
        const int k = l * factors + f;
        if (!kPadded || k < sdims) {
          uint32_t w[kQuad];
          quad_words(tab, mask, k, w);
#pragma unroll
          for (int i = 0; i < kQuad; ++i) z[l][i] = word_normal(w[i]);
        } else {
          pad_normals(pad_c + static_cast<int64_t>(k - sdims) * count, in, z[l]);
        }
      }
    }
    float b[8];
    row_of(tab, t, b);
    float e[kQuad];
    bridge_row<kT, kLevels>(b, z, t, kLog, e);
    store_row(o, e, in, vec);
    o += row_stride;
  }
}

template <int kT>
__global__ void __launch_bounds__(kThreads, kQuadMinBlocks) qmc_bridge_sparse_kernel(
    const uint32_t* __restrict__ dirs, const uint32_t* __restrict__ shift,
    const float* __restrict__ bridge, const float* __restrict__ pad, float* __restrict__ out,
    uint32_t* __restrict__ words_out, int factors, int sdims, int64_t count, uint32_t start) {
  __shared__ __align__(16) QuadTables<kT, kMaxDims> tab;
  const int c = blockIdx.y;
  const uint32_t lead = start & (kQuadBlock - 1);
  const uint32_t base = (start - lead) + static_cast<uint32_t>(blockIdx.x) * kQuadBlock;
  fill_quad_tables(tab, dirs, shift + static_cast<int64_t>(c) * sdims, sdims, bridge, base);
  __syncthreads();
  // this thread's points: p0 .. p0 + kQuad - 1 of [0, count)
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kQuadBlock + kQuad * threadIdx.x - lead;
  if (p0 + kQuad <= 0 || p0 >= count) return;
  uint32_t mask[kQuadLowBits];
  quad_mask(base + kQuad * threadIdx.x, mask);
  bool in[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) in[i] = p0 + i >= 0 && p0 + i < count;
  if (words_out != nullptr) {
    copy_words(tab, mask, sdims, in, count,
               words_out + static_cast<int64_t>(c) * sdims * count + p0);
  }
  const int flat = kT * factors;
  const float* pad_c =
      pad == nullptr ? nullptr : pad + static_cast<int64_t>(c) * (flat - sdims) * count + p0;
  float* out_c = out + static_cast<int64_t>(c) * flat * count + p0;
  // every row starts at a multiple of count, and out at a 256-byte boundary
  const bool vec = p0 >= 0 && p0 + kQuad <= count && count % kQuad == 0 && p0 % kQuad == 0;
  const int64_t row_stride = static_cast<int64_t>(factors) * count;
  for (int f = 0; f < factors; ++f) {
    if ((kT - 1) * factors + f < sdims) {  // every column of this factor a Sobol word
      bridge_factor_rows<kT, false>(tab, mask, f, factors, sdims, pad_c, count, in, vec,
                                    out_c + f * count, row_stride);
    } else {
      bridge_factor_rows<kT, true>(tab, mask, f, factors, sdims, pad_c, count, in, vec,
                                   out_c + f * count, row_stride);
    }
  }
}

inline dim3 grid_of(int contracts, int64_t count, uint32_t start, int block_points = kThreads) {
  const int64_t span = static_cast<int64_t>(start & (block_points - 1)) + count;
  return dim3(static_cast<unsigned>((span + block_points - 1) / block_points),
              static_cast<unsigned>(contracts));
}

}  // namespace

// dirs [sdims, 32] and shift [contracts, sdims] uint32; bridge [T, T] f32; pad
// [contracts, T·F − sdims, count] f32 or null; out [contracts, T, F, count];
// words_out [contracts, sdims, count] uint32 or null (checks only). sparse =
// 1 (T = 8, 16, 32 or 64, the caller having checked the matrix's zeros)
// launches qmc_bridge_sparse_kernel, sparse = 0 the dense bridge.
extern "C" int qmc_bridge_launch(const void* dirs, const void* shift, const void* bridge,
                                 const void* pad, void* out, void* words_out, int contracts,
                                 int timesteps, int factors, int sdims, long long count,
                                 unsigned start, int sparse, void* stream) {
  if (sdims > kMaxDims || sdims > timesteps * factors) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* dp = static_cast<const uint32_t*>(dirs);
  const uint32_t* sp = static_cast<const uint32_t*>(shift);
  const float* bp = static_cast<const float*>(bridge);
  const float* pp = static_cast<const float*>(pad);
  float* op = static_cast<float*>(out);
  uint32_t* wp = static_cast<uint32_t*>(words_out);
  if (sparse) {
    const dim3 quads = grid_of(contracts, count, start, kQuadBlock);
#define SPARSE(KT)                                                                        \
  qmc_bridge_sparse_kernel<KT><<<quads, kThreads, 0, st>>>(dp, sp, bp, pp, op, wp, factors, \
                                                           sdims, count, start)
    switch (timesteps) {
      case 8: SPARSE(8); break;
      case 16: SPARSE(16); break;
      case 32: SPARSE(32); break;
      case 64: SPARSE(64); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SPARSE
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = grid_of(contracts, count, start);
#define BRIDGE(KMAXT) \
  qmc_bridge_kernel<KMAXT><<<grid, kThreads, 0, st>>>(dp, sp, bp, pp, op, wp, timesteps, factors, \
                                                       sdims, count, start)
  if (timesteps <= 8) {
    BRIDGE(8);
  } else if (timesteps <= 16) {
    BRIDGE(16);
  } else if (timesteps <= 32) {
    BRIDGE(32);
  } else if (timesteps <= 64) {
    BRIDGE(64);
  } else {
    BRIDGE(0);
  }
#undef BRIDGE
  return static_cast<int>(cudaGetLastError());
}

// dirs [T, 32], shift [contracts, T] uint32; bridge [T, T] f32; scalars
// [contracts, 3] = (log spot, drift, vol√dt) f32; out [contracts, count].
// sparse = 1 (T = 8, 16, 32 or 64, the caller having checked the matrix's
// zeros) launches qmc_walk_sparse_kernel, sparse = 0 the dense walk.
extern "C" int qmc_walk_launch(const void* dirs, const void* shift, const void* bridge,
                               const void* scalars, void* out, int contracts, int timesteps,
                               long long count, unsigned start, int sparse, void* stream) {
  if (timesteps > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* dp = static_cast<const uint32_t*>(dirs);
  const uint32_t* sp = static_cast<const uint32_t*>(shift);
  const float* bp = static_cast<const float*>(bridge);
  const float* cp = static_cast<const float*>(scalars);
  float* op = static_cast<float*>(out);
  if (sparse) {
    const dim3 quads = grid_of(contracts, count, start, kQuadBlock);
#define SPARSE(KT)                                                                         \
  qmc_walk_sparse_kernel<KT><<<quads, kThreads, 0, st>>>(dp, sp, bp, cp, op, count, start)
    switch (timesteps) {
      case 8: SPARSE(8); break;
      case 16: SPARSE(16); break;
      case 32: SPARSE(32); break;
      case 64: SPARSE(64); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SPARSE
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = grid_of(contracts, count, start);
#define WALK(KMAXT) \
  qmc_walk_kernel<KMAXT><<<grid, kThreads, 0, st>>>(dp, sp, bp, cp, op, timesteps, count, start)
  if (timesteps <= 8) {
    WALK(8);
  } else if (timesteps <= 16) {
    WALK(16);
  } else if (timesteps <= 32) {
    WALK(32);
  } else {
    WALK(64);
  }
#undef WALK
  return static_cast<int>(cudaGetLastError());
}
