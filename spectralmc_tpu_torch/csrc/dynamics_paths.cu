// Payoff underliers under curved GBM, Heston and Merton dynamics for a batch of
// contracts: the "cuda" MC engine beyond flat GBM.
//
// Replaces three kernels of the JAX package's ops/gbm_pallas.py:
//   * _gbm_term_block_kernel: log-Euler GBM under piecewise-constant curves.
//     The draw order per branch is the flat kernel's (gbm_paths.cu); only the
//     coefficients come from a per-contract table computed outside the
//     kernel, step[t] = (a.x, a.y) = (drift_t·dt, vol_t·√dt). TERMINAL
//     advances two steps a draw: logx + (a.x + b.x) + sign·r·(a.y·cos θ +
//     b.y·sin θ) for the steps a = 2p, b = 2p + 1; the variance swap takes
//     both Box–Muller outputs of a draw as the two steps' normals (r·cos θ,
//     r·sin θ); barrier, lookback and Asian take one draw per step with z =
//     r·cos θ. An odd tail is one single step. The stream (gbm_term v2)
//     walks whole Philox calls with every word's place fixed when compiling
//     (gbm_step.cuh's walk_pairs for the pair branches, four steps a call;
//     walk_draws<1> for the others, two), and the draw is heston_step.cuh's
//     box_muller_pinned, every rounding of the draw and the steps written
//     out so that the twin repeats them bit for bit. The TPU kernel's second
//     table, (R, φ) for r·R·sin(θ + 2πφ), saved a sine there; here the
//     pinned transform gives cos θ and sin θ from one exact quarter-turn
//     reduction of the 24-bit u2, which cannot take the off-grid θ + 2πφ,
//     so the pair step reads both outputs and the table is gone.
//   * _heston_block_kernel: full-truncation Euler Heston, the step of
//     heston_step.cuh (shared with the monitor kernel): one draw per step,
//     z_v = r·cos θ drives the variance, z_s = ρ·z_v + ρ̄·r·sin θ the spot, and
//     √(v⁺·dt) is one square root. The RAW v stays the base of the recursion;
//     only drift and diffusion see v⁺ = max(v, 0). The variance-swap branch
//     sums its increment first, the others add term by term, as the TPU
//     kernel does. Forward start walks the whole path and captures ln S_m
//     after step m − 1. The draws are walked in pairs (walk_draws): one
//     Philox call feeds steps j and j + 1 from words (x, y) and (z, w), with
//     no parity test or word select; an odd step count ends in one tail
//     step. The draw and the step run on fixed roundings that the twin
//     repeats bit for bit (stream heston v2; heston_step.cuh says why).
//   * _merton_block_kernel: the exact compensated Merton step of
//     merton_step.cuh (shared with the monitor kernel), the coefficients and
//     the 16 running-cdf levels of lam·dt from one per-contract table that
//     torch computes and the twin reads too. A step reads three words: the
//     Box–Muller pair (z_d = r·cos θ for the diffusion, z_j = r·sin θ for the
//     jump size), then the Poisson count's uniform; the walk (walk_triples)
//     takes four steps from three whole Philox calls, every word used and its
//     place fixed when compiling. The count compares the first kCountFirst
//     levels and the rest behind a rare branch, exactly the 16-level count.
//     jump = n·μ_J + σ_J·√n·z_j. Antithetic rows flip the pair and share the
//     counts. The draw and the step run on fixed roundings that the twin
//     repeats bit for bit (stream merton_jump v2); the launch can write each
//     path's final log-price beside its value (log_out), which the checks
//     hold to the twin's.
// What they drop is what the TPU needed: the hardware PRNG, the polynomial
// sine, the 256x256 blocks, the SMEM tables and the unroll caps. One thread
// owns one path and keeps its whole state in registers; every thread of a
// block belongs to one contract (blockIdx.y), so a table entry is one
// broadcast load through the read-only cache.
//
// Bound on Hopper: the rate of transcendental and integer instructions, as
// for the flat kernel. Per step the Heston and Merton kernels add a second
// trigonometric output and a square root; Merton runs three quarters of a
// Philox call and kCountFirst compares (PERF.md §6 has their SASS by part);
// Heston half a call, the term kernel's one-draw branches half a call and
// its pair branches a quarter, none of them a select.
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gbm_step.cuh"
#include "heston_step.cuh"
#include "merton_step.cuh"
#include "path_stream.cuh"

namespace {

constexpr int kForward = 5;  // Heston only: spot·S_T/S_m with ln S_m captured

__device__ __forceinline__ bool tracks_max(int family, int variant) {
  return family == kBarrier ? variant == 1 : (variant == 0 || variant == 3);
}

// The epilogue the branches share: `logx` the terminal log-price, `acc` the
// running extreme (log), the running sum, or the captured ln S_m.
template <int kFamily>
__device__ __forceinline__ float finish(float logx, float acc, float spot, float strike,
                                        float maturity, int timesteps, int variant,
                                        float barrier_rel) {
  if constexpr (kFamily == kTerminal) {
    return expf(logx);
  } else if constexpr (kFamily == kVariance) {
    return __fdiv_rn(acc, maturity);
  } else if constexpr (kFamily == kForward) {
    return spot * expf(logx - acc);
  } else if constexpr (kFamily == kAsian) {
    const float inv_n = static_cast<float>(1.0 / timesteps);
    return variant ? expf(acc * inv_n) : acc * inv_n;
  } else if constexpr (kFamily == kBarrier) {
    const float level = logf(__fmul_rn(spot, barrier_rel));
    const bool knocked = tracks_max(kFamily, variant) ? acc >= level : acc <= level;
    return knocked ? strike : expf(logx);
  } else {
    const float ext = expf(acc), terminal = expf(logx);
    return variant == 0 ? 2.0f * strike - ext
         : variant == 1 ? ext
         : variant == 2 ? strike - (terminal - ext)
                        : strike - (ext - terminal);
  }
}

// Folds the new log-price into the branch's accumulator.
template <int kFamily>
__device__ __forceinline__ float observe(float acc, float logx, bool up, int variant) {
  if constexpr (kFamily == kAsian) {
    return acc + (variant ? logx : expf(logx));
  } else if constexpr (kFamily == kBarrier || kFamily == kLookback) {
    return up ? fmaxf(acc, logx) : fminf(acc, logx);
  } else {
    return acc;
  }
}

// The term kernel's draw: the radius with the antithetic sign folded in
// (exact) and (cos 2πu2, sin 2πu2), box_muller_pinned's.
__device__ __forceinline__ float term_draw(uint2 d, float sign, float& cs, float& sn) {
  float rad;
  box_muller_pinned(d, rad, cs, sn);
  return sign * rad;
}

// One step a from one draw: logx + a.x + a.y·(sign·r·cos θ).
__device__ __forceinline__ float term_single_step(float logx, uint2 d, float2 a, float sign) {
  float cs, sn;
  const float srad = term_draw(d, sign, cs, sn);
  return __fmaf_rn(a.y, __fmul_rn(srad, cs), __fadd_rn(logx, a.x));
}

// Log-Euler GBM under curves: step [C, T, 2] = (drift_t·dt, vol_t·√dt).
template <int kFamily>
__global__ void gbm_term_kernel(const float* __restrict__ params,
                                const uint32_t* __restrict__ keys,
                                const float2* __restrict__ step, float* __restrict__ out,
                                int64_t rows, int64_t cols, int timesteps, int variant,
                                float barrier_rel, int64_t half, int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const float sign = s.sign;
  const float* p = params + 6 * c;
  const float spot = p[0], strike = p[1], maturity = p[2];
  const float2* st = step + static_cast<int64_t>(c) * timesteps;
  float logx = logf(spot);
  float acc = (kFamily == kBarrier || kFamily == kLookback) ? logx : 0.0f;

  if constexpr (kFamily == kTerminal) {
    walk_pairs(
        s, timesteps / 2, timesteps & 1,
        [&](uint2 d) {
          const float2 a = __ldg(st), b = __ldg(st + 1);
          st += 2;
          float cs, sn;
          const float srad = term_draw(d, sign, cs, sn);
          const float mix = __fmaf_rn(a.y, cs, __fmul_rn(b.y, sn));
          logx = __fmaf_rn(srad, mix, __fadd_rn(logx, __fadd_rn(a.x, b.x)));
        },
        [&](uint2 d) { logx = term_single_step(logx, d, __ldg(st), sign); });
  } else if constexpr (kFamily == kVariance) {
    walk_pairs(
        s, timesteps / 2, timesteps & 1,
        [&](uint2 d) {
          const float2 a = __ldg(st), b = __ldg(st + 1);
          st += 2;
          float cs, sn;
          const float srad = term_draw(d, sign, cs, sn);
          const float inc_a = __fmaf_rn(a.y, __fmul_rn(srad, cs), a.x);
          const float inc_b = __fmaf_rn(b.y, __fmul_rn(srad, sn), b.x);
          acc = __fmaf_rn(inc_b, inc_b, __fmaf_rn(inc_a, inc_a, acc));
        },
        [&](uint2 d) {
          const float2 a = __ldg(st);
          float cs, sn;
          const float srad = term_draw(d, sign, cs, sn);
          const float inc = __fmaf_rn(a.y, __fmul_rn(srad, cs), a.x);
          acc = __fmaf_rn(inc, inc, acc);
        });
  } else {  // barrier, lookback, Asian: one draw per step
    const bool up = tracks_max(kFamily, variant);
    walk_draws<1>(s, timesteps, [&](int j, const uint2 (&d)[1]) {
      logx = term_single_step(logx, d[0], __ldg(st + j), sign);
      acc = observe<kFamily>(acc, logx, up, variant);
    });
  }
  out[static_cast<int64_t>(c) * rows * cols + local] =
      finish<kFamily>(logx, acc, spot, strike, maturity, timesteps, variant, barrier_rel);
}

// Full-truncation Euler Heston: params [C, 10] = spot strike T r q v0 kappa
// theta xi rho. The step is heston_step.cuh's; the draws are walked in pairs,
// one Philox call feeding steps j and j + 1 (walk_draws).
template <int kFamily>
__global__ void heston_paths_kernel(const float* __restrict__ params,
                                    const uint32_t* __restrict__ keys, float* __restrict__ out,
                                    int64_t rows, int64_t cols, int timesteps, int variant,
                                    float barrier_rel, int forward_step, int64_t half,
                                    int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const float sign = s.sign;
  const float* p = params + 10 * c;
  const float spot = p[0], strike = p[1], maturity = p[2], v0 = p[5];
  const HestonCoeffs h = heston_coeffs(p, timesteps);
  const bool up = tracks_max(kFamily, variant);
  float logx = logf(spot);
  float v = v0;
  float acc = (kFamily == kBarrier || kFamily == kLookback || kFamily == kForward) ? logx : 0.0f;
  walk_draws<1>(s, timesteps, [&](int j, const uint2 (&d)[1]) {
    const float inc = heston_step<kFamily == kVariance>(h, sign, d[0], logx, v);
    if constexpr (kFamily == kVariance) {
      acc = __fmaf_rn(inc, inc, acc);  // nvcc's contraction, pinned
    } else if constexpr (kFamily == kForward) {
      if (j == forward_step - 1) acc = logx;
    } else {
      acc = observe<kFamily>(acc, logx, up, variant);
    }
  });
  out[static_cast<int64_t>(c) * rows * cols + local] =
      finish<kFamily>(logx, acc, spot, strike, maturity, timesteps, variant, barrier_rel);
}

// The exact Merton step: params [C, 9] = spot strike T r q vol lam jump_mean
// jump_std; table [C, 20] merton_step.cuh's coefficients and levels; log_out,
// where not null, takes each path's final log-price.
template <int kFamily>
__global__ void merton_paths_kernel(const float* __restrict__ params,
                                    const uint32_t* __restrict__ keys,
                                    const float* __restrict__ table, float* __restrict__ out,
                                    float* __restrict__ log_out, int64_t rows, int64_t cols,
                                    int timesteps, int variant, float barrier_rel, int64_t half,
                                    int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const float sign = s.sign;
  const float* p = params + 9 * c;
  const float spot = p[0], strike = p[1], maturity = p[2];
  const MertonCoeffs k = merton_coeffs(table, c);
  const bool up = tracks_max(kFamily, variant);
  float logx = logf(spot);
  float acc = (kFamily == kBarrier || kFamily == kLookback) ? logx : 0.0f;
  walk_triples(s, timesteps, [&](int, uint2 d, uint32_t w) {
    const float inc = merton_step<kFamily == kVariance>(k, sign, d, w, logx);
    if constexpr (kFamily == kVariance) {
      acc = __fmaf_rn(inc, inc, acc);  // nvcc's contraction, pinned
    } else {
      acc = observe<kFamily>(acc, logx, up, variant);
    }
  });
  const int64_t at = static_cast<int64_t>(c) * rows * cols + local;
  out[at] = finish<kFamily>(logx, acc, spot, strike, maturity, timesteps, variant, barrier_rel);
  if (log_out != nullptr) log_out[at] = logx;
}

constexpr int kThreads = 256;

}  // namespace

// Launches KERNEL<family> for the families listed in the switch.
#define LAUNCH_FAMILY(KERNEL, FAMILY, ...)                                              \
  case FAMILY:                                                                          \
    KERNEL<FAMILY><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__); \
    break;

extern "C" int gbm_term_launch(const void* params, const void* keys, const void* step,
                               void* out, int contracts, long long rows, long long cols,
                               int timesteps, int family, int variant, float barrier_rel,
                               long long half, long long row_offset, void* stream) {
  const dim3 grid = grid_of(contracts, rows, cols, kThreads);
  const float* pp = static_cast<const float*>(params);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  const float2* sp = static_cast<const float2*>(step);
  float* op = static_cast<float*>(out);
#define TERM_ARGS pp, kp, sp, op, rows, cols, timesteps, variant, barrier_rel, half, row_offset
  switch (family) {
    LAUNCH_FAMILY(gbm_term_kernel, kTerminal, TERM_ARGS)
    LAUNCH_FAMILY(gbm_term_kernel, kBarrier, TERM_ARGS)
    LAUNCH_FAMILY(gbm_term_kernel, kLookback, TERM_ARGS)
    LAUNCH_FAMILY(gbm_term_kernel, kVariance, TERM_ARGS)
    LAUNCH_FAMILY(gbm_term_kernel, kAsian, TERM_ARGS)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TERM_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int heston_paths_launch(const void* params, const void* keys, void* out,
                                   int contracts, long long rows, long long cols,
                                   int timesteps, int family, int variant, float barrier_rel,
                                   int forward_step, long long half, long long row_offset,
                                   void* stream) {
  const dim3 grid = grid_of(contracts, rows, cols, kThreads);
  const float* pp = static_cast<const float*>(params);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  float* op = static_cast<float*>(out);
#define HESTON_ARGS \
  pp, kp, op, rows, cols, timesteps, variant, barrier_rel, forward_step, half, row_offset
  switch (family) {
    LAUNCH_FAMILY(heston_paths_kernel, kTerminal, HESTON_ARGS)
    LAUNCH_FAMILY(heston_paths_kernel, kBarrier, HESTON_ARGS)
    LAUNCH_FAMILY(heston_paths_kernel, kLookback, HESTON_ARGS)
    LAUNCH_FAMILY(heston_paths_kernel, kVariance, HESTON_ARGS)
    LAUNCH_FAMILY(heston_paths_kernel, kAsian, HESTON_ARGS)
    LAUNCH_FAMILY(heston_paths_kernel, kForward, HESTON_ARGS)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HESTON_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int merton_paths_launch(const void* params, const void* keys, const void* table,
                                   void* out, void* log_out, int contracts, long long rows,
                                   long long cols, int timesteps, int family, int variant,
                                   float barrier_rel, long long half, long long row_offset,
                                   void* stream) {
  const dim3 grid = grid_of(contracts, rows, cols, kThreads);
  const float* pp = static_cast<const float*>(params);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  float* lp = static_cast<float*>(log_out);
#define MERTON_ARGS \
  pp, kp, tp, op, lp, rows, cols, timesteps, variant, barrier_rel, half, row_offset
  switch (family) {
    LAUNCH_FAMILY(merton_paths_kernel, kTerminal, MERTON_ARGS)
    LAUNCH_FAMILY(merton_paths_kernel, kBarrier, MERTON_ARGS)
    LAUNCH_FAMILY(merton_paths_kernel, kLookback, MERTON_ARGS)
    LAUNCH_FAMILY(merton_paths_kernel, kVariance, MERTON_ARGS)
    LAUNCH_FAMILY(merton_paths_kernel, kAsian, MERTON_ARGS)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MERTON_ARGS
  return static_cast<int>(cudaGetLastError());
}
