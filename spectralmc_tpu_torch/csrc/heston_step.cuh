// The full-truncation Euler Heston step shared by the European Heston kernel
// (heston_paths_kernel, dynamics_paths.cu) and its monitor kernel
// (american_heston_kernel, american_dynamics.cu): one place, so the monitor
// kernel's last row stays the European TERMINAL value bit for bit.
//
// One draw a step: z_v = r·cos θ drives the variance, z_s = ρ·z_v + ρ̄·r·sin θ
// the spot, and √(v⁺·dt) is one IEEE square root. The RAW v stays the base of
// the recursion; only drift and diffusion see v⁺ = max(v, 0).
//
// Every rounding of the draw and the step is fixed (the heston and
// american_heston v2 streams): integer bit operations, __fmaf_rn, __fmul_rn,
// __fadd_rn and __fsqrt_rn only, so nvcc contracts nothing and there is no
// libm, and the plain twins (ops/dynamics_cuda.py::box_muller_pinned and
// heston_step_plain) repeat each operation with the same rounding, the FMAs
// exactly (ops/rng.py::fma32_exact). Kernel and twin then carry the same v,
// bit for bit, on every path. That matters here as nowhere else: √v⁺ is not
// Lipschitz at 0, so an ulp between the two sides grows from step to step
// wherever v nears 0, past the kernel-vs-twin gate (PERF.md §6).
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_stream.cuh"

namespace {

// The Box–Muller transform of the v2 streams on fixed roundings, each
// function within 1.2 ulp of float64 over every value the stream draws
// (tests/test_torch_heston_draw.py, exhaustively):
//   * ln u1, u1 = uniform_open(a) in [2^-25, 1]: u1 = 2^k·z with z in
//     [√½, √2) split off the bits, f = z − 1 exact (Sterbenz), ln(1 + f) =
//     f + f²·Q(f) (Q a degree-7 fit of (ln(1 + f) − f)/f²), then k·ln 2 in
//     two parts; u1 = 1 gives 0;
//   * the radius √(−2·ln u1), one IEEE root;
//   * cos 2πu2 and sin 2πu2, u2 = m·2^-24: the nearest quarter turn q and
//     the exact remainder r = 4u2 − q in [−½, ½) from the integer m, then
//     sin(πr/2) = r·(π/2 + r²·S(r²)) with π/2 in two parts, cos(πr/2) =
//     1 + r²·C(r²), and the quarter turn's swap and signs.
constexpr float kLn2Hi = 0.693145752f;  // ln 2's leading 15 bits
constexpr float kLn2Lo = 1.42860677e-06f;
constexpr float kHalfPiHi = 1.57079637f;
constexpr float kHalfPiLo = -4.37113883e-08f;

__device__ __forceinline__ float ln_pinned(float u1) {
  const int ix = __float_as_int(u1);
  const int tmp = ix - 0x3F3504F3;  // the bits of √½
  const int k = tmp >> 23;
  const float f = __fsub_rn(__int_as_float(ix - (tmp & static_cast<int>(0xFF800000u))), 1.0f);
  float q = 0.0880836695f;
  q = __fmaf_rn(q, f, -0.143519357f);
  q = __fmaf_rn(q, f, 0.149101794f);
  q = __fmaf_rn(q, f, -0.165631115f);
  q = __fmaf_rn(q, f, 0.199621201f);
  q = __fmaf_rn(q, f, -0.250021279f);
  q = __fmaf_rn(q, f, 0.333339572f);
  q = __fmaf_rn(q, f, -0.499999851f);
  const float y = __fmaf_rn(__fmul_rn(f, f), q, f);
  const float kf = static_cast<float>(k);
  return __fmaf_rn(kf, kLn2Hi, __fmaf_rn(kf, kLn2Lo, y));
}

// (cos 2πu2, sin 2πu2) of u2 = b·2^-24 (b the word's top 24 bits).
__device__ __forceinline__ void sincos_2pi_pinned(uint32_t b, float& cs, float& sn) {
  const int m = static_cast<int>(b >> 8);
  const int q = (m + (1 << 21)) >> 22;
  const float r = __fmul_rn(static_cast<float>(m - (q << 22)), 0x1p-22f);
  const float s = __fmul_rn(r, r);
  float ps = -0.00462198071f;
  ps = __fmaf_rn(ps, s, 0.0796870366f);
  ps = __fmaf_rn(ps, s, -0.645964026f);
  const float sin_r = __fmaf_rn(r, kHalfPiHi, __fmul_rn(r, __fmaf_rn(s, ps, kHalfPiLo)));
  float pc = 0.000906741712f;
  pc = __fmaf_rn(pc, s, -0.0208615288f);
  pc = __fmaf_rn(pc, s, 0.253669411f);
  pc = __fmaf_rn(pc, s, -1.23370051f);
  const float cos_r = __fmaf_rn(s, pc, 1.0f);
  const float c = (q & 1) ? sin_r : cos_r;
  const float si = (q & 1) ? cos_r : sin_r;
  cs = ((q + 1) & 2) ? -c : c;
  sn = (q & 2) ? -si : si;
}

// The radius and (cos 2πu2, sin 2πu2) of draw (a, b).
__device__ __forceinline__ void box_muller_pinned(uint2 d, float& rad, float& cs, float& sn) {
  rad = __fsqrt_rn(__fmul_rn(-2.0f, ln_pinned(uniform_open(d.x))));
  sincos_2pi_pinned(d.y, cs, sn);
}

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
// does. The FMAs are the ones nvcc contracts the plain expressions into
// (ρ̄·x + ρ·z_v; −½v⁺·dt onto the drift's base and √(v⁺dt)·z_s onto that;
// −κdt·v⁺ onto v + κθdt and ξ√(v⁺dt)·z_v onto that), every other
// operation is rounded alone.
template <bool kSumFirst>
__device__ __forceinline__ float heston_step(const HestonCoeffs& h, float sign, uint2 d,
                                             float& logx, float& v) {
  float rad, cs, sn;
  box_muller_pinned(d, rad, cs, sn);
  const float z_v = __fmul_rn(sign, __fmul_rn(rad, cs));
  const float z_s =
      __fmaf_rn(h.rho_bar, __fmul_rn(sign, __fmul_rn(rad, sn)), __fmul_rn(h.rho, z_v));
  const float v_plus = fmaxf(v, 0.0f);
  const float sv = __fsqrt_rn(__fmul_rn(v_plus, h.dt));
  const float drift_v = __fmul_rn(-0.5f, v_plus);
  float inc = 0.0f;
  if constexpr (kSumFirst) {
    inc = __fmaf_rn(sv, z_s, __fmaf_rn(drift_v, h.dt, h.rq_dt));
    logx = __fadd_rn(logx, inc);
  } else {
    logx = __fmaf_rn(sv, z_s, __fmaf_rn(drift_v, h.dt, __fadd_rn(logx, h.rq_dt)));
  }
  v = __fmaf_rn(__fmul_rn(h.xi, sv), z_v, __fmaf_rn(-h.kdt, v_plus, __fadd_rn(v, h.ktheta_dt)));
  return inc;
}

}  // namespace
