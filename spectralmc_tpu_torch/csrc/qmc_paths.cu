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
// that fed the TPU's vector unit and the MXU dot. Here a block takes 256
// consecutive point indices aligned to 256, so the bits of gray(n) from bit 8
// up are the block's: its threads XOR those directions once into c_hi[k] in
// shared memory, and each thread adds its own 8 low bits. For T <= 64 the
// bridge matrix sits transposed in shared memory (a level's column read as
// float4s) and a factor's T accumulators in registers; longer bridges
// accumulate in the output itself (same order, same roundings) with the
// matrix read through the read-only cache.
//
// Bound on Hopper: the bridge kernel writes T·F floats per path and its
// operations per path are about T·F·(8 word ops + ~30 for erf⁻¹ + T
// multiply-adds); at T = 16, F = 1 that is ~740 operations for 64 bytes, so
// on the card's 67 TFLOP/s and 3.35 TB/s it is bound by operations. The walk
// kernel writes 4 bytes per path and is bound by operations outright.
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

inline dim3 grid_of(int contracts, int64_t count, uint32_t start) {
  const int64_t span = static_cast<int64_t>(start & (kThreads - 1)) + count;
  return dim3(static_cast<unsigned>((span + kThreads - 1) / kThreads),
              static_cast<unsigned>(contracts));
}

}  // namespace

// dirs [sdims, 32] and shift [contracts, sdims] uint32; bridge [T, T] f32; pad
// [contracts, T·F − sdims, count] f32 or null; out [contracts, T, F, count];
// words_out [contracts, sdims, count] uint32 or null (checks only).
extern "C" int qmc_bridge_launch(const void* dirs, const void* shift, const void* bridge,
                                 const void* pad, void* out, void* words_out, int contracts,
                                 int timesteps, int factors, int sdims, long long count,
                                 unsigned start, void* stream) {
  if (sdims > kMaxDims || sdims > timesteps * factors) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = grid_of(contracts, count, start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* dp = static_cast<const uint32_t*>(dirs);
  const uint32_t* sp = static_cast<const uint32_t*>(shift);
  const float* bp = static_cast<const float*>(bridge);
  const float* pp = static_cast<const float*>(pad);
  float* op = static_cast<float*>(out);
  uint32_t* wp = static_cast<uint32_t*>(words_out);
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
extern "C" int qmc_walk_launch(const void* dirs, const void* shift, const void* bridge,
                               const void* scalars, void* out, int contracts, int timesteps,
                               long long count, unsigned start, void* stream) {
  if (timesteps > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(contracts, count, start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* dp = static_cast<const uint32_t*>(dirs);
  const uint32_t* sp = static_cast<const uint32_t*>(shift);
  const float* bp = static_cast<const float*>(bridge);
  const float* cp = static_cast<const float*>(scalars);
  float* op = static_cast<float*>(out);
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
