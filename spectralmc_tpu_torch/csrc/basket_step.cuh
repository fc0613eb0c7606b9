// The correlated log-Euler basket step shared by the European basket kernel
// (basket_paths_kernel, basket_paths.cu) and its monitor kernel
// (american_basket_kernel, american_dynamics.cu): one place, so the monitor
// kernel's last row stays the European TERMINAL value bit for bit.
//
// ⌈A/2⌉ Box–Muller draws a step: assets 2p and 2p + 1 take r·cos θ and r·sin θ
// of draw p (independent normals; an odd count's last draw computes its
// cosine alone), antithetic rows flip every normal; the static spec's lower
// Cholesky rows mix them as an FMA chain over the lower triangle (a zero entry
// adds an exact zero); each asset takes log x ← (log x + drift) + vol√dt·z_mixed.
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "basket_spec.cuh"
#include "path_stream.cuh"

namespace {

// A path's per-asset constants: the drift and vol·√dt of each log-Euler step.
template <int kA>
struct BasketCoeffs {
  float drift[kA], sig_sdt[kA];
};

// The coefficients from params [6] = spot strike T r q vol, and each asset's
// starting log-price in logx.
template <int kA>
__device__ __forceinline__ BasketCoeffs<kA> basket_coeffs(const float* p, int timesteps,
                                                          const BasketArgs& spec,
                                                          float (&logx)[kA]) {
  const float spot = p[0], maturity = p[2], rate = p[3], div = p[4], vol = p[5];
  const float dt = maturity / static_cast<float>(timesteps);
  const float sqrt_dt = sqrtf(dt);
  BasketCoeffs<kA> k;
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    const float sig = vol * spec.vol_mult[a];
    k.sig_sdt[a] = sig * sqrt_dt;
    k.drift[a] = ((rate - div) - 0.5f * (sig * sig)) * dt;
    logx[a] = logf(spot * spec.spot_mult[a]);
  }
  return k;
}

// One step from the step's draws d: advances logx and leaves each asset's
// log-increment drift + vol√dt·z_mixed in inc (the variance swap's).
template <int kA>
__device__ __forceinline__ void basket_step(const BasketArgs& spec, const BasketCoeffs<kA>& k,
                                            float sign, const uint2 (&d)[(kA + 1) / 2],
                                            float (&logx)[kA], float (&inc)[kA]) {
  float z[kA];
#pragma unroll
  for (int q = 0; q < (kA + 1) / 2; ++q) {
    float rad, cs, sn;
    if (2 * q + 1 < kA) {
      box_muller_sfu(d[q], rad, cs, sn);
      z[2 * q + 1] = sign * (rad * sn);
    } else {
      box_muller_sfu_cos(d[q], rad, cs);
    }
    z[2 * q] = sign * (rad * cs);
  }
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    float zm = spec.chol[a * kMaxAssets] * z[0];
#pragma unroll
    for (int b = 1; b <= a; ++b) zm = zm + spec.chol[a * kMaxAssets + b] * z[b];
    inc[a] = k.drift[a] + k.sig_sdt[a] * zm;
    logx[a] = (logx[a] + k.drift[a]) + k.sig_sdt[a] * zm;
  }
}

}  // namespace
