// The exact compensated Merton step shared by the European Merton kernel
// (merton_paths_kernel, dynamics_paths.cu) and its monitor kernel
// (american_merton_kernel, american_dynamics.cu): one place, so the monitor
// kernel's last row stays the European TERMINAL value bit for bit.
//
// A step reads three words of the stream (path_stream.cuh::walk_triples: four
// steps on three whole Philox calls): the Box–Muller pair
// (z_d = r·cos θ for the diffusion, z_j = r·sin θ for the jump size) and the
// uniform of the Poisson count. Antithetic rows flip the pair and share the
// counts. The coefficients come from one per-contract table that torch
// computes once (ops/dynamics_cuda.py::merton_table), which kernel and plain
// twin both read:
//   [drift·dt, vol·√dt, μ_J, σ_J, level_0 .. level_15],
// the drift compensated (r − q − λ·(e^{μ_J + σ_J²/2} − 1) − σ²/2) and the
// levels the running Poisson cdf of λ·dt. The levels never decrease (each is
// the last plus p >= 0), so the count, the number of levels at or below the
// uniform, is the index past the last level it reaches. The count compares
// the first kCountFirst levels and takes the other 16 − kCountFirst only
// behind a branch on level kCountFirst − 1, which decides the same count on
// every uniform (tests/test_torch_dynamics_kernels.py checks all 2^24 of
// them). At the rates a training run draws (λ·dt <= 0.075) a uniform
// reaches level 2 at most once in about 15,000 draws; K = 3 ran 3% faster
// than K = 4 and as fast as K = 2 (chip_variants.py, PERF.md §6).
//
// Every rounding of the draw and the step is fixed (the merton_jump and
// american_merton_jump v2 streams): the draw is heston_step.cuh's
// box_muller_pinned, √n an exact constant below kCountFirst and one IEEE
// root past it, and the jump and the update are written out in __fmaf_rn,
// __fmul_rn and __fadd_rn, so nvcc contracts nothing the plain twin
// (ops/dynamics_cuda.py::merton_step_plain, the FMAs through
// ops/rng.py::fma32_exact) does not repeat: on the card the kernels'
// log-price is the twin's bit for bit.
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "heston_step.cuh"
#include "path_stream.cuh"

namespace {

constexpr int kPoissonTerms = 16;
constexpr int kMertonTable = 4 + kPoissonTerms;  // floats a contract
constexpr int kCountFirst = 3;  // levels compared on every step (K)

// √k for k = 0..16, each the float32 that __fsqrt_rn gives
__device__ __forceinline__ constexpr float sqrt_small(int k) {
  constexpr float kRoots[kPoissonTerms + 1] = {
      0.0f,       1.0f,       1.4142135f, 1.7320508f, 2.0f,       2.236068f,
      2.4494898f, 2.6457512f, 2.828427f,  3.0f,       3.1622777f, 3.3166249f,
      3.4641016f, 3.6055512f, 3.7416575f, 3.8729835f, 4.0f};
  return kRoots[k];
}

// One contract's row of the table: the four coefficients and the first
// kCountFirst levels in registers, the row itself for the rest.
struct MertonCoeffs {
  float drift, vol_sdt, jump_mean, jump_std;
  float lv[kCountFirst];
  const float* levels;
};

__device__ __forceinline__ MertonCoeffs merton_coeffs(const float* __restrict__ table, int c) {
  const float* row = table + static_cast<int64_t>(kMertonTable) * c;
  const float4 head = __ldg(reinterpret_cast<const float4*>(row));
  MertonCoeffs k;
  k.drift = head.x;
  k.vol_sdt = head.y;
  k.jump_mean = head.z;
  k.jump_std = head.w;
  k.levels = row + 4;
#pragma unroll
  for (int i = 0; i < kCountFirst; ++i) k.lv[i] = __ldg(k.levels + i);
  return k;
}

// The count n of levels at or below the uniform of word w, and √n.
__device__ __forceinline__ void merton_count(const MertonCoeffs& k, uint32_t w, float& n,
                                             float& root) {
  const float u = uniform_closed(w);
  n = 0.0f;
  root = 0.0f;
#pragma unroll
  for (int i = 0; i + 1 < kCountFirst; ++i) {
    const bool hit = u >= k.lv[i];
    n = hit ? static_cast<float>(i + 1) : n;
    root = hit ? sqrt_small(i + 1) : root;
  }
  if (__builtin_expect(u >= k.lv[kCountFirst - 1], 0)) {  // rare: n >= kCountFirst
    float m = static_cast<float>(kCountFirst);
#pragma unroll
    for (int i = kCountFirst; i < kPoissonTerms; ++i) {
      m = u >= __ldg(k.levels + i) ? static_cast<float>(i + 1) : m;
    }
    n = m;
    root = __fsqrt_rn(m);
  }
}

// The jump n·μ_J + (σ_J·√n)·z_j of the count's word w.
__device__ __forceinline__ float merton_jump(const MertonCoeffs& k, uint32_t w, float z_j) {
  float n, root;
  merton_count(k, w, n, root);
  return __fmaf_rn(__fmul_rn(k.jump_std, root), z_j, __fmul_rn(n, k.jump_mean));
}

// One step from the pair d and the count's word w: advances logx and returns
// the log-price increment. kSumFirst (the variance swap) sums the increment
// before adding it; otherwise the log-price takes its terms one by one
// ((logx + drift) + vol√dt·z_d, then the jump), as the TPU kernel does.
template <bool kSumFirst>
__device__ __forceinline__ float merton_step(const MertonCoeffs& k, float sign, uint2 d,
                                             uint32_t w, float& logx) {
  float rad, cs, sn;
  box_muller_pinned(d, rad, cs, sn);
  const float z_d = __fmul_rn(sign, __fmul_rn(rad, cs));
  const float z_j = __fmul_rn(sign, __fmul_rn(rad, sn));
  const float jump = merton_jump(k, w, z_j);
  float inc = 0.0f;
  if constexpr (kSumFirst) {
    inc = __fadd_rn(__fmaf_rn(k.vol_sdt, z_d, k.drift), jump);
    logx = __fadd_rn(logx, inc);
  } else {
    logx = __fadd_rn(__fmaf_rn(k.vol_sdt, z_d, __fadd_rn(logx, k.drift)), jump);
  }
  return inc;
}

}  // namespace
