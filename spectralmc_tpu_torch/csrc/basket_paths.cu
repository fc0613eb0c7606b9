// Basket payoff underliers for a batch of contracts: A correlated log-Euler
// GBM assets per path, the "cuda" MC engine for model "basket_gbm".
//
// Replaces the JAX package's ops/gbm_pallas.py::_basket_block_kernel. What it
// keeps of the TPU kernel is the math and the draw order:
//   * the step (basket_step.cuh, shared with the monitor kernel): ⌈A/2⌉
//     Box–Muller draws; assets 2p and 2p + 1 take r·cos θ and r·sin θ of draw
//     p, the static spec's lower Cholesky rows mix them, each asset takes
//     log x ← (log x + drift) + vol√dt·z_mixed; antithetic rows flip every
//     normal;
//   * the payoff reads the basket value: Σ wᵢ·e^{log xᵢ} (arithmetic) or
//     e^{Σ wᵢ·log xᵢ} (geometric). TERMINAL, barrier and lookback (running
//     extreme of the basket value), variance swap (squared increments of
//     ln B, each formed as Σ wᵢ·Δlog xᵢ or ln(B_t/B_{t−1}) rather than as a
//     difference of two values near ln S, whose ulps would be ~1e-5 of an
//     increment), Asian (running sum of B or ln B) and the arithmetic forward start
//     (B_m captured after step m − 1, u = B₀·B_T/B_m). The digital and the
//     geometric forward start are routes through TERMINAL (the wrapper's);
//     the barrier level is spot times a float32 factor the host computes in
//     double exactly as the TPU kernel does.
// What it drops is what the TPU needed: the hardware PRNG (here the
// Philox stream of path_stream.cuh, draw j = t·⌈A/2⌉ + p), the polynomial
// sine and the 256x256 blocks. The spec arrives by value as a kernel
// argument, and the asset count and the combine are template parameters, so
// the per-asset scalars, the state and the mix live in registers and unroll,
// and a step holds only its own combine's code. One thread owns one path;
// every thread of a block belongs to one contract (blockIdx.y).
//
// Bound on Hopper: instruction issue (a path reads 32 bytes of contract and
// key and writes 4). The design spends it as follows (stream basket_gbm v2):
//   * walk_draws hands each step its draws' words with their places fixed
//     when compiling: a 3-asset step is one whole Philox call (its round keys
//     are loop-invariant, and nvcc adds them outside the loop), with no
//     parity test or word select;
//   * the Box–Muller runs on the SFU (box_muller_sfu): MUFU.LG2 or a short
//     polynomial in the exact u1 − 1 for the log, MUFU.RSQ for the root,
//     MUFU.SIN and MUFU.COS for the angle, in place of libm's logf, sqrtf and
//     sincospif (PERF.md §6 counts both); an odd asset count's last draw
//     takes its cosine alone;
//   * A(A+1)/2 FMAs of the mix and A state updates a step, and the basket
//     value's A expf where the branch reads it each step.
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "basket_spec.cuh"
#include "basket_step.cuh"
#include "path_stream.cuh"

namespace {

constexpr int kForward = 5;  // the arithmetic forward start: B_m captured in the walk

// The step's log-return of the basket value, ln B_t − ln B_{t−1}, without
// subtracting two values near ln S: Σ wᵢ·(log-increment)ᵢ for the geometric
// combine, ln(B_t / B_{t−1}) for the arithmetic one (prev holds B_{t−1} and
// takes B_t).
template <int kA, bool kGeo>
__device__ __forceinline__ float step_log_return(const float (&logx)[kA], const float (&inc)[kA],
                                                 const BasketArgs& spec, float& prev) {
  if constexpr (kGeo) {
    float acc = spec.weights[0] * inc[0];
#pragma unroll
    for (int a = 1; a < kA; ++a) acc = acc + spec.weights[a] * inc[a];
    return acc;
  }
  const float v = basket_value<kA, false>(logx, spec);
  const float ratio = v / prev;
  prev = v;
  return logf(ratio);
}

template <int kA, int kFamily, bool kGeo>
__global__ void basket_paths_kernel(const float* __restrict__ params,
                                    const uint32_t* __restrict__ keys, const BasketArgs spec,
                                    float* __restrict__ out, int64_t rows, int64_t cols,
                                    int timesteps, int variant, float barrier_factor,
                                    int forward_step, int64_t half, int64_t row_offset) {
  constexpr int kPairs = (kA + 1) / 2;
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const float sign = s.sign;
  const float* p = params + 6 * c;
  const float spot = p[0], strike = p[1], maturity = p[2];
  float logx[kA];
  const BasketCoeffs<kA> k = basket_coeffs<kA>(p, timesteps, spec, logx);
  const bool up = kFamily == kBarrier ? variant == 1 : (variant == 0 || variant == 3);
  const float b0 = basket_value<kA, kGeo>(logx, spec);
  float acc = (kFamily == kBarrier || kFamily == kLookback || kFamily == kForward) ? b0 : 0.0f;
  float prev = b0;  // the variance swap's last basket value
  walk_draws<kPairs>(s, timesteps, [&](int t, const uint2 (&d)[kPairs]) {
    float step_inc[kA];  // each asset's log-increment drift + vol√dt·z_mixed
    basket_step<kA>(spec, k, sign, d, logx, step_inc);
    if constexpr (kFamily == kBarrier || kFamily == kLookback) {
      const float v = basket_value<kA, kGeo>(logx, spec);
      acc = up ? fmaxf(acc, v) : fminf(acc, v);
    } else if constexpr (kFamily == kAsian) {
      const float v = basket_value<kA, kGeo>(logx, spec);
      acc = acc + (variant ? logf(v) : v);
    } else if constexpr (kFamily == kVariance) {
      const float inc = step_log_return<kA, kGeo>(logx, step_inc, spec, prev);
      acc = acc + inc * inc;
    } else if constexpr (kFamily == kForward) {
      if (t == forward_step - 1) acc = basket_value<kA, kGeo>(logx, spec);
    }
  });
  float result;
  if constexpr (kFamily == kTerminal) {
    result = basket_value<kA, kGeo>(logx, spec);
  } else if constexpr (kFamily == kVariance) {
    result = acc / maturity;
  } else if constexpr (kFamily == kAsian) {
    const float inv_n = static_cast<float>(1.0 / timesteps);
    result = variant ? expf(acc * inv_n) : acc * inv_n;
  } else if constexpr (kFamily == kForward) {
    result = b0 * basket_value<kA, kGeo>(logx, spec) / acc;
  } else if constexpr (kFamily == kBarrier) {
    const float level = __fmul_rn(spot, barrier_factor);
    const bool knocked = up ? acc >= level : acc <= level;
    result = knocked ? strike : basket_value<kA, kGeo>(logx, spec);
  } else {  // lookback: the running extreme is already in price units
    const float terminal = basket_value<kA, kGeo>(logx, spec);
    result = variant == 0 ? 2.0f * strike - acc
           : variant == 1 ? acc
           : variant == 2 ? strike - (terminal - acc)
                          : strike - (acc - terminal);
  }
  out[static_cast<int64_t>(c) * rows * cols + local] = result;
}

constexpr int kThreads = 256;

// The kernels' Box–Muller on its own, for the card tests: draw i's words
// (a, b) to (r·cos 2πu2, r·sin 2πu2).
__global__ void box_muller_sfu_kernel(const uint2* __restrict__ words, float2* __restrict__ out,
                                      int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rad, cs, sn;
  box_muller_sfu(words[i], rad, cs, sn);
  out[i] = make_float2(rad * cs, rad * sn);
}

template <int kA, bool kGeo>
int launch_assets(const float* params, const uint32_t* keys, const BasketArgs& spec, float* out,
                  int contracts, long long rows, long long cols, int timesteps, int family,
                  int variant, float barrier_factor, int forward_step, long long half,
                  long long row_offset, cudaStream_t stream) {
  const dim3 grid = grid_of(contracts, rows, cols, kThreads);
#define BASKET_CASE(FAMILY)                                                                 \
  case FAMILY:                                                                              \
    basket_paths_kernel<kA, FAMILY, kGeo><<<grid, kThreads, 0, stream>>>(                   \
        params, keys, spec, out, rows, cols, timesteps, variant, barrier_factor, forward_step, \
        half, row_offset);                                                                  \
    break;
  switch (family) {
    BASKET_CASE(kTerminal)
    BASKET_CASE(kBarrier)
    BASKET_CASE(kLookback)
    BASKET_CASE(kVariance)
    BASKET_CASE(kAsian)
    BASKET_CASE(kForward)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BASKET_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: int32 [n, 2]; out: float32 [n, 2].
extern "C" int box_muller_sfu_launch(const void* words, void* out, long long n, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  box_muller_sfu_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(words), static_cast<float2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// spec_host: host float32 [3·8 + 8·8] (ops/basket_cuda.py::spec_table), copied
// into the by-value kernel argument.
extern "C" int basket_paths_launch(const void* params, const void* keys, const void* spec_host,
                                   void* out, int contracts, long long rows, long long cols,
                                   int timesteps, int assets, int family, int variant,
                                   int geometric, float barrier_factor, int forward_step,
                                   long long half, long long row_offset, void* stream) {
  BasketArgs spec;
  memcpy(&spec, spec_host, sizeof(spec));
  const float* pp = static_cast<const float*>(params);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ASSETS_CASE(A)                                                                       \
  case A:                                                                                    \
    return geometric ? launch_assets<A, true>(pp, kp, spec, op, contracts, rows, cols,       \
                                              timesteps, family, variant, barrier_factor,    \
                                              forward_step, half, row_offset, st)            \
                     : launch_assets<A, false>(pp, kp, spec, op, contracts, rows, cols,      \
                                               timesteps, family, variant, barrier_factor,   \
                                               forward_step, half, row_offset, st);
  switch (assets) {
    ASSETS_CASE(1)
    ASSETS_CASE(2)
    ASSETS_CASE(3)
    ASSETS_CASE(4)
    ASSETS_CASE(5)
    ASSETS_CASE(6)
    ASSETS_CASE(7)
    ASSETS_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ASSETS_CASE
}
