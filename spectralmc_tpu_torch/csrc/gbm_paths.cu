// Flat GBM payoff underliers for a batch of contracts: the "cuda" MC engine.
//
// Replaces two kernels of the JAX package's ops/gbm_pallas.py:
//   * _gbm_block_kernel (launched by _simulate_rows_pallas_f32): every payoff
//     branch, both path schemes -- TERMINAL, barrier/lookback (running
//     extreme), variance swap (sum of squared log-increments) and Asian
//     (running sum, arithmetic or geometric);
//   * _gbm_cliquet_block_kernel (launched by _simulate_cliquet_rows_pallas_f32):
//     the cliquet sum of clipped period returns under log-Euler.
// What they keep of the TPU kernels is the math and the draw order:
//   * uniforms from the top 24 bits of a word: u1 = b·2^-24 + 2^-25 (so
//     log u1 is finite), u2 = b·2^-24; Box–Muller radius r = sqrt(-2 ln u1);
//   * TERMINAL under log-Euler: two steps share one draw, since
//     z1 + z2 = r·(cos θ + sin θ) = r·√2·sin(θ + π/4); an odd tail takes one
//     single step with z = r·cos θ;
//   * barrier, lookback and Asian: one draw per step, z = r·cos θ -- every
//     intermediate state is observed, so the pair-step does not apply;
//   * variance swap under log-Euler: the pair-step survives the square,
//     (a + b·z1)² + (a + b·z2)² = 2a² + b²·x + 2·a·b·r·(cos θ + sin θ) with
//     x = r² = -2 ln u1; antithetic mirroring flips only the cross term; an
//     odd tail takes one single step inc²; under Euler one draw per step
//     with inc = log|1 + (r−q)dt + vol√dt·z|; the output is Σ inc² / T;
//   * cliquet: one Gaussian per reset period, N(k·drift, k·vol²·dt) -- the
//     exact law of the period's log-return -- with two periods sharing one
//     draw through z1 = r·cos θ, z2 = r·sin θ, and one extra r·cos θ draw for
//     an odd period count; u = Σ clip(e^L − 1, floor, cap), L = k·drift +
//     √k·vol√dt·z in one FMA;
//   * reflection-Euler: x ← |x·(1 + (r−q)dt + vol√dt·z)|, a fresh z per step;
//   * antithetic mirroring and one float written per path.
// What they drop is what the TPU needed: the hardware PRNG (here a
// Philox-4x32-10 stream keyed by the contract's two threefry words, with the
// counter (path index lo, path index hi, call index, 0); draw j takes words
// 2(j%2), 2(j%2)+1 of call j/2, so the stream is a pure function of (key,
// global row, col, draw) and stays put under contract chunking or row
// sharding) and the 256x256 VMEM blocks. One thread owns one path and loops
// over time steps.
//
// Bound on Hopper: the rate of transcendental and integer instructions. A
// path reads 24 bytes of contract and 8 of key once and stores 4 bytes at the
// end, so memory traffic is negligible; per draw it costs half a Philox call
// (10 rounds of two 32-bit mul-hi/lo) and a Box–Muller transform, plus the
// branch's own work per step. So the flat kernel (the gbm v2 stream) walks
// whole Philox calls, two draws a call with each word's place fixed when
// compiling (walk_draws, and gbm_step.cuh's walk_pairs for the pair-step
// branches: no parity select), and takes gbm_step.cuh's transform (ln u1
// and the sine and cosine on fixed roundings, the root on the SFU) in place
// of libm's logf, sqrtf and sinpif; the arithmetic Asian's per-step price is
// ex2.approx of log x·log2 e. The TERMINAL pair step is gbm_step.cuh's,
// which the GBM monitor kernel's pair steps share. The family, the scheme
// and what a branch does each step (the Asian's mean, the barrier's and
// lookback's extreme) are template parameters, so each instantiation has one
// loop and keeps only its own state in registers (TERMINAL: log x;
// barrier/lookback: log x and the running extreme; variance: the
// accumulator; Asian: log x and the sum). The cliquet kernel (the
// gbm_cliquet v2 stream) walks its period pairs with walk_pairs too, one
// whole call feeding four periods, on heston_step.cuh's box_muller_pinned
// (the IEEE root; ln u1 and the angle on fixed roundings) with the period's
// return, its clip and the sum on fixed roundings, so that its twin repeats
// every path bit for bit. The design keeps the whole path in registers and
// never materializes a normals matrix in device memory.
//
// Antithetic: global row r >= half reuses row r - half's words with z negated
// (the threefry engine's global-half convention, not the TPU's in-block mirror).
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gbm_step.cuh"
#include "path_stream.cuh"

namespace {

constexpr int kLogEuler = 0;  // the Python side's _SCHEME_CODE
constexpr int kEuler = 1;

// The flat-GBM kernel, one instantiation per payoff family, scheme and
// step rule: kFlag is the geometric mean for the Asian and the maximum for
// the barrier and lookback (up-and-out; fixed call, floating put), else
// false; `variant` still picks the lookback's encoding at the end.
template <int kFamily, int kScheme, bool kFlag>
__global__ void gbm_paths_kernel(const float* __restrict__ params,
                                 const uint32_t* __restrict__ keys, float* __restrict__ out,
                                 int64_t rows, int64_t cols, int timesteps, int variant,
                                 float barrier_rel, int64_t half, int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const int64_t n = rows * cols;

  const float* p = params + 6 * c;
  const float spot = p[0], strike = p[1], maturity = p[2], rate = p[3], div = p[4],
              vol = p[5];
  // scalar set-up rounded op by op, as the plain version evaluates it
  const float dt = __fdiv_rn(maturity, static_cast<float>(timesteps));
  const float vol_sdt = __fmul_rn(vol, __fsqrt_rn(dt));
  const float carry = __fsub_rn(rate, div);
  const float vs = s.sign * vol_sdt;  // the antithetic sign folded in (exact)
  float result;

  if constexpr (kScheme == kLogEuler) {
    const float drift =
        __fmul_rn(__fsub_rn(carry, __fmul_rn(__fmul_rn(0.5f, vol), vol)), dt);
    if constexpr (kFamily == kTerminal) {
      const float two_drift = __fmul_rn(2.0f, drift);
      float logx = logf(spot);
      walk_pairs(
          s, timesteps / 2, timesteps & 1,
          [&](uint2 d) { logx = gbm_pair_step(logx, d, two_drift, vs); },
          [&](uint2 d) { logx = gbm_single_step(logx, d, drift, vs); });
      result = expf(logx);
    } else if constexpr (kFamily == kVariance) {
      const float base_c = __fmul_rn(__fmul_rn(2.0f, drift), drift);
      const float b_sq = __fmul_rn(vol_sdt, vol_sdt);
      const float cross_c = s.sign * __fmul_rn(__fmul_rn(2.0f, drift), vol_sdt);
      float acc = 0.0f;
      walk_pairs(
          s, timesteps / 2, timesteps & 1,
          [&](uint2 d) {
            float rad, cs, sn;
            const float x = box_muller_gbm(d, rad, cs, sn);
            acc = acc + ((base_c + b_sq * x) + cross_c * (rad * (cs + sn)));
          },
          [&](uint2 d) {
            const float inc = drift + vs * gbm_normal(d);
            acc = acc + inc * inc;
          });
      result = __fdiv_rn(acc, maturity);
    } else {  // barrier, lookback, Asian: one draw per step
      const float log0 = logf(spot);
      float logx = log0;
      float acc = (kFamily == kAsian) ? 0.0f : log0;  // the sum, or the running extreme
      walk_draws<1>(s, timesteps, [&](int, const uint2 (&d)[1]) {
        logx = gbm_single_step(logx, d[0], drift, vs);
        if constexpr (kFamily == kAsian) {
          acc = acc + (kFlag ? logx : exp_sfu(logx));
        } else {
          acc = kFlag ? fmaxf(acc, logx) : fminf(acc, logx);
        }
      });
      if constexpr (kFamily == kAsian) {
        const float inv_n = static_cast<float>(1.0 / timesteps);
        result = kFlag ? expf(acc * inv_n) : acc * inv_n;
      } else if constexpr (kFamily == kBarrier) {
        const float level = logf(__fmul_rn(spot, barrier_rel));
        const bool knocked = kFlag ? acc >= level : acc <= level;
        result = knocked ? strike : expf(logx);
      } else {
        const float ext = expf(acc), terminal = expf(logx);
        result = variant == 0 ? 2.0f * strike - ext
               : variant == 1 ? ext
               : variant == 2 ? strike - (terminal - ext)
                              : strike - (ext - terminal);
      }
    }
  } else {  // reflection-Euler: one draw per step
    const float growth = __fadd_rn(1.0f, __fmul_rn(carry, dt));
    if constexpr (kFamily == kVariance) {
      float acc = 0.0f;
      walk_draws<1>(s, timesteps, [&](int, const uint2 (&d)[1]) {
        const float inc = logf(fabsf(growth + vs * gbm_normal(d[0])));
        acc = acc + inc * inc;
      });
      result = __fdiv_rn(acc, maturity);
    } else {
      float x = spot;
      float acc = (kFamily == kAsian) ? 0.0f : spot;
      walk_draws<1>(s, timesteps, [&](int, const uint2 (&d)[1]) {
        x = fabsf(x * (growth + vs * gbm_normal(d[0])));
        if constexpr (kFamily == kAsian) {
          acc = acc + (kFlag ? logf(x) : x);
        } else if constexpr (kFamily != kTerminal) {
          acc = kFlag ? fmaxf(acc, x) : fminf(acc, x);
        }
      });
      if constexpr (kFamily == kTerminal) {
        result = x;
      } else if constexpr (kFamily == kAsian) {
        const float inv_n = static_cast<float>(1.0 / timesteps);
        result = kFlag ? expf(acc * inv_n) : acc * inv_n;
      } else if constexpr (kFamily == kBarrier) {
        const float level = __fmul_rn(spot, barrier_rel);
        const bool knocked = kFlag ? acc >= level : acc <= level;
        result = knocked ? strike : x;
      } else {
        result = variant == 0 ? 2.0f * strike - acc
               : variant == 1 ? acc
               : variant == 2 ? strike - (x - acc)
                              : strike - (acc - x);
      }
    }
  }
  out[static_cast<int64_t>(c) * n + local] = result;
}

// The cliquet: one Gaussian per reset period (log-Euler only), two periods a
// draw and four a Philox call (walk_pairs).
__global__ void gbm_cliquet_kernel(const float* __restrict__ params,
                                   const uint32_t* __restrict__ keys, float* __restrict__ out,
                                   int64_t rows, int64_t cols, int timesteps, int reset_every,
                                   float floor, float cap, int64_t half, int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const int64_t n = rows * cols;
  const float sign = s.sign;

  const float* p = params + 6 * c;
  const float maturity = p[2], rate = p[3], div = p[4], vol = p[5];
  const float dt = __fdiv_rn(maturity, static_cast<float>(timesteps));
  const float k = static_cast<float>(reset_every);
  const float period_drift = __fmul_rn(
      __fmul_rn(__fsub_rn(__fsub_rn(rate, div), __fmul_rn(__fmul_rn(0.5f, vol), vol)), dt), k);
  const float period_vol = __fmul_rn(vol, __fsqrt_rn(__fmul_rn(dt, k)));
  const int periods = timesteps / reset_every;
  // the period's clipped return, every rounding written out
  auto clipped = [&](float z) {
    const float ret = __fsub_rn(expf(__fmaf_rn(period_vol, z, period_drift)), 1.0f);
    return fminf(fmaxf(ret, floor), cap);
  };
  float acc = 0.0f;
  walk_pairs(
      s, periods / 2, periods & 1,
      [&](uint2 d) {
        float rad, cs, sn;
        box_muller_pinned(d, rad, cs, sn);
        const float srad = sign * rad;
        const float za = __fmul_rn(srad, cs), zb = __fmul_rn(srad, sn);
        acc = __fadd_rn(__fadd_rn(acc, clipped(za)), clipped(zb));
      },
      [&](uint2 d) {
        float rad, cs, sn;
        box_muller_pinned(d, rad, cs, sn);
        acc = __fadd_rn(acc, clipped(__fmul_rn(sign * rad, cs)));
      });
  out[static_cast<int64_t>(c) * n + local] = acc;
}

// One family's launch under either scheme and, where the family has one,
// either step rule.
template <int kFamily, int kScheme>
void launch_scheme(dim3 grid, int threads, cudaStream_t st, bool flag, const float* pp,
                   const uint32_t* kp, float* op, long long rows, long long cols, int timesteps,
                   int variant, float barrier_rel, long long half, long long row_offset) {
  if constexpr (kFamily == kAsian || kFamily == kBarrier || kFamily == kLookback) {
    if (flag) {
      gbm_paths_kernel<kFamily, kScheme, true><<<grid, threads, 0, st>>>(
          pp, kp, op, rows, cols, timesteps, variant, barrier_rel, half, row_offset);
      return;
    }
  }
  gbm_paths_kernel<kFamily, kScheme, false><<<grid, threads, 0, st>>>(
      pp, kp, op, rows, cols, timesteps, variant, barrier_rel, half, row_offset);
}

template <int kFamily>
void launch_family(dim3 grid, int threads, cudaStream_t st, int scheme, bool flag,
                   const float* pp, const uint32_t* kp, float* op, long long rows, long long cols,
                   int timesteps, int variant, float barrier_rel, long long half,
                   long long row_offset) {
  if (scheme == kLogEuler) {
    launch_scheme<kFamily, kLogEuler>(grid, threads, st, flag, pp, kp, op, rows, cols,
                                      timesteps, variant, barrier_rel, half, row_offset);
  } else {
    launch_scheme<kFamily, kEuler>(grid, threads, st, flag, pp, kp, op, rows, cols, timesteps,
                                   variant, barrier_rel, half, row_offset);
  }
}

}  // namespace

extern "C" int gbm_paths_launch(const void* params, const void* keys, void* out, int contracts,
                                long long rows, long long cols, int timesteps, int scheme,
                                int family, int variant, float barrier_rel, long long half,
                                long long row_offset, void* stream) {
  if (scheme != kLogEuler && scheme != kEuler) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const dim3 grid = grid_of(contracts, rows, cols, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(params);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  float* op = static_cast<float*>(out);
  // the step rule: the geometric Asian's mean, the barrier's up-and-out, the
  // lookback's running maximum (fixed call, floating put)
  const bool flag = family == kAsian ? variant == 1
                  : family == kBarrier ? variant == 1
                  : family == kLookback ? (variant == 0 || variant == 3)
                                        : false;
#define FAMILY(F)                                                                            \
  launch_family<F>(grid, threads, st, scheme, flag, pp, kp, op, rows, cols, timesteps,      \
                   variant, barrier_rel, half, row_offset)
  switch (family) {
    case kTerminal:
      FAMILY(kTerminal);
      break;
    case kBarrier:
      FAMILY(kBarrier);
      break;
    case kLookback:
      FAMILY(kLookback);
      break;
    case kVariance:
      FAMILY(kVariance);
      break;
    case kAsian:
      FAMILY(kAsian);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FAMILY
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gbm_terminal_launch(const void* params, const void* keys, void* out,
                                   int contracts, long long rows, long long cols,
                                   int timesteps, int scheme, long long half,
                                   long long row_offset, void* stream) {
  return gbm_paths_launch(params, keys, out, contracts, rows, cols, timesteps, scheme,
                          kTerminal, 0, 1.0f, half, row_offset, stream);
}

extern "C" int gbm_cliquet_launch(const void* params, const void* keys, void* out,
                                  int contracts, long long rows, long long cols, int timesteps,
                                  int reset_every, float floor, float cap, long long half,
                                  long long row_offset, void* stream) {
  const int threads = 256;
  gbm_cliquet_kernel<<<grid_of(contracts, rows, cols, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const uint32_t*>(keys),
      static_cast<float*>(out), rows, cols, timesteps, reset_every, floor, cap, half,
      row_offset);
  return static_cast<int>(cudaGetLastError());
}
