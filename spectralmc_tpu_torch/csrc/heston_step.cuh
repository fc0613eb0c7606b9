// The full-truncation Euler Heston step shared by the European Heston kernel
// (heston_paths_kernel, dynamics_paths.cu) and its monitor kernel
// (american_heston_kernel, american_dynamics.cu): one place, so the monitor
// kernel's last row stays the European TERMINAL value bit for bit.
//
// One draw a step: z_v = r·cos θ drives the variance, z_s = ρ·z_v + ρ̄·r·sin θ
// the spot, and √(v⁺·dt) is one IEEE square root. The RAW v stays the base of
// the recursion; only drift and diffusion see v⁺ = max(v, 0). The draw's
// Box–Muller is libm's (the heston and american_heston v1 streams): the
// root of a low variance amplifies an ulp from step to step, and the SFU
// transform's larger errors (path_stream.cuh's box_muller_sfu) put more of
// the variance swap's paths past the kernel-vs-twin gate than it allows
// (PERF.md §6).
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_stream.cuh"

namespace {

// The step's coefficients, from params [10] = spot strike T r q v0 kappa theta
// xi rho, rounded op by op as the plain version evaluates them.
struct HestonCoeffs {
  float dt, rho, rho_bar, rq_dt, kdt, ktheta_dt, xi;
};

__device__ __forceinline__ HestonCoeffs heston_coeffs(const float* p, int timesteps) {
  const float maturity = p[2], rate = p[3], div = p[4], kappa = p[6], theta = p[7],
              rho = p[9];
  HestonCoeffs h;
  h.dt = __fdiv_rn(maturity, static_cast<float>(timesteps));
  h.rho = rho;
  h.rho_bar = __fsqrt_rn(__fsub_rn(1.0f, __fmul_rn(rho, rho)));
  h.rq_dt = __fmul_rn(__fsub_rn(rate, div), h.dt);
  h.kdt = __fmul_rn(kappa, h.dt);
  h.ktheta_dt = __fmul_rn(__fmul_rn(kappa, theta), h.dt);
  h.xi = p[8];
  return h;
}

// One step from draw d: advances logx and v and returns the log-price
// increment. kSumFirst (the variance swap) sums the increment before adding
// it; otherwise the log-price takes its terms one by one, as the TPU kernel
// does.
template <bool kSumFirst>
__device__ __forceinline__ float heston_step(const HestonCoeffs& h, float sign, uint2 d,
                                             float& logx, float& v) {
  float rad, cs, sn;
  box_muller_libm(d, rad, cs, sn);
  const float z_v = sign * (rad * cs);
  const float z_s = h.rho * z_v + h.rho_bar * (sign * (rad * sn));
  const float v_plus = fmaxf(v, 0.0f);
  const float sv = sqrtf(v_plus * h.dt);
  float inc = 0.0f;
  if constexpr (kSumFirst) {
    inc = (h.rq_dt - (0.5f * v_plus) * h.dt) + sv * z_s;
    logx = logx + inc;
  } else {
    logx = ((logx + h.rq_dt) - (0.5f * v_plus) * h.dt) + sv * z_s;
  }
  v = ((v + h.ktheta_dt) - h.kdt * v_plus) + (h.xi * sv) * z_v;
  return inc;
}

}  // namespace
