// The flat GBM log-Euler steps and their Box–Muller transform, shared by the
// flat kernel (gbm_paths_kernel, gbm_paths.cu: every branch) and the GBM
// monitor kernel's pair steps (american_gbm_kernel, american_paths.cu): one
// place, so that with an even `every` the monitor kernel's last row stays
// the TERMINAL branch's value bit for bit. The pair walk (walk_pairs) also
// drives the cliquet kernel's periods (gbm_paths.cu) and the curved-term
// kernel's pair branches (gbm_term_kernel, dynamics_paths.cu).
//
// The transform (the gbm v2 stream, and american_gbm v3's pair steps):
// x = −2·ln u1 by heston_step.cuh's ln_pinned, the radius √x as x·rsqrt(x)
// on the SFU (path_stream.cuh's box_muller_root), and (cos 2πu2, sin 2πu2)
// by heston_step.cuh's sincos_2pi_pinned: an exact quarter-turn reduction of
// the 24-bit u2 and two short polynomials, within 1.2 ulp. The whole-SFU
// transform (box_muller_sfu: MUFU.LG2 and MUFU.SIN/COS too) is the faster,
// but against the twins it flips about 2.5 times as many barrier knocks and
// digital signs as libm's or this one, and it fails a card test's digital
// case (1 of 18,432 paths) that they pass (chip_variants.py; PERF.md §6).
// The antithetic sign is folded into vs = sign·vol√dt, which is exact.
// Every rounding of a step is written out (__fadd_rn, __fmul_rn,
// __fmaf_rn), so nvcc contracts nothing differently in the two kernels.
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "heston_step.cuh"
#include "path_stream.cuh"

namespace {

// Draw (a, b)'s (cos 2πu2, sin 2πu2), radius and the radius' square −2·ln u1.
__device__ __forceinline__ float box_muller_gbm(uint2 d, float& rad, float& cs, float& sn) {
  const float x = __fmul_rn(-2.0f, ln_pinned(uniform_open(d.x)));
  rad = box_muller_root(x);
  sincos_2pi_pinned(d.y, cs, sn);
  return x;
}

// Two steps from one draw: z1 + z2 = r·(cos 2πu2 + sin 2πu2), which is
// r·√2·sin(2πu2 + π/4), the pair-step of the TERMINAL branch.
__device__ __forceinline__ float gbm_pair_step(float logx, uint2 d, float two_drift, float vs) {
  float rad, cs, sn;
  box_muller_gbm(d, rad, cs, sn);
  return __fmaf_rn(vs, __fmul_rn(rad, __fadd_rn(cs, sn)), __fadd_rn(logx, two_drift));
}

// One step's normal z = r·cos 2πu2, its antithetic sign not applied.
__device__ __forceinline__ float gbm_normal(uint2 d) {
  float rad, cs, sn;
  box_muller_gbm(d, rad, cs, sn);
  return __fmul_rn(rad, cs);
}

// One step from one draw.
__device__ __forceinline__ float gbm_single_step(float logx, uint2 d, float drift, float vs) {
  return __fmaf_rn(vs, gbm_normal(d), __fadd_rn(logx, drift));
}

// Walks `pairs` draws of pair(d) and then, when `odd`, one draw of
// single(d), in the stream's draw order (draw j is words 2(j%2), 2(j%2)+1 of
// call j/2) with every word's place fixed when compiling: an iteration takes
// one whole call and two draws, no parity select; the tail takes at most one
// more call, whose second half, where the pairs end on a first half, is the
// single step's draw.
template <class Pair, class Single>
__device__ __forceinline__ void walk_pairs(const PathStream& s, int pairs, bool odd,
                                           Pair&& pair, Single&& single) {
  int j = 0;
  for (; j + 2 <= pairs; j += 2) {
    const uint4 w = s.call(j >> 1);
    pair(make_uint2(w.x, w.y));
    pair(make_uint2(w.z, w.w));
  }
  if (j < pairs) {
    const uint4 w = s.call(j >> 1);
    pair(make_uint2(w.x, w.y));
    if (odd) single(make_uint2(w.z, w.w));
  } else if (odd) {
    const uint4 w = s.call(j >> 1);
    single(make_uint2(w.x, w.y));
  }
}

// e^x on the SFU: ex2.approx of x·log2 e (the arithmetic Asian's running
// sum of prices; a few ulps at |x| of a log-price).
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.44269504f)));
  return y;
}

}  // namespace
