// American (Bermudan) monitor rows under Heston, Merton and basket dynamics
// for a batch of contracts: the forward of the "cuda" MC engine's LSMC
// pricing beyond GBM.
//
// Replaces three kernels of the JAX package's ops/gbm_pallas.py:
//   * _heston_monitor_block_kernel (american_heston_kernel): full-truncation
//     Euler Heston writing exp(log S) AND max(v, 0) at every monitor date —
//     both state variables, because the continuation value depends on the
//     variance too (the regression basis adds [v, v·x, v²]);
//   * _merton_monitor_block_kernel (american_merton_kernel): the exact
//     compensated Merton step writing exp(log S) (the spot alone is Markov);
//   * _basket_monitor_block_kernel (american_basket_kernel<A, geometric>):
//     A correlated log-Euler assets writing the basket value and, for the
//     arithmetic combine, the log dispersion ln(B_arith) − Σ wᵢ·log xᵢ (the
//     second regression state). The TPU kernel writes zeros for a geometric
//     combine and its launch drops them; here a geometric launch writes the
//     one output.
// The per-step code of each is the matching European kernel's TERMINAL
// branch, with its draws, its draw order and its roundings: each calls the
// very step function its European kernel calls (heston_step.cuh: one
// Box–Muller draw a step, z_v = r·cos θ driving the variance and z_s = ρ·z_v
// + ρ̄·r·sin θ the spot; merton_step.cuh: three words a step, the pair and
// then the count's uniform, the coefficients and cdf levels from the same
// per-contract table; basket_step.cuh: ⌈A/2⌉ draws a step mixed by the
// static Cholesky rows), on the same Philox stream (path_stream.cuh). None
// of the three has a pair-step shortcut, so the last monitor row is the path
// the European TERMINAL branch walks, for any `every`. After every `every`
// steps the kernel stores the monitor values; nothing else changes. These
// are the american_heston, american_merton_jump and american_basket_gbm v2
// streams (Heston's and Merton's draws and steps on fixed roundings,
// heston_step.cuh and merton_step.cuh; the basket's Box–Muller on the SFU).
// At every = 1, the main path's grid, each kernel walks whole Philox calls
// with every word's place fixed when compiling, as its European kernel walks
// its steps (Heston two dates a call, walk_draws; Merton four dates on three
// calls, walk_triples; the basket ⌈A/2⌉ draws a date, an odd pair count two
// dates an iteration and an odd tail date), and stores through pointers that
// move one row of paths a date. The walks read the words the rolled loops of
// the other grids read (PathStream::draw, PathStream::triple), so the rows
// are the rolled loop's bit for bit. The other grids keep their date and
// step loops rolled (#pragma unroll 1); a date of odd length takes its draws
// one by one.
//
// What they drop is what the TPU needed: the hardware PRNG, the VMEM block
// budget (_monitor_block_rows), the 256x256 blocks and the polynomial sine.
// One thread owns one path and keeps its state in registers; every thread of
// a block belongs to one contract (blockIdx.y). The monitor count stays
// capped at 128 (ops/gbm_cuda.py::MAX_MONITOR_DATES), the asset count is a
// template parameter (1..8).
//
// Bound on Hopper, at every = 1: Heston by its instruction issue (the
// European Heston step, its SASS in PERF.md §6, plus two stores a date: its
// 2 × 4 bytes a path-date of output need 10.3 ms at 256 × 2048 × 512 × 16,
// under the issue time); Merton by its issue too (the European Merton step,
// three quarters of a Philox call and kCountFirst compares, plus an expf and
// a store a date); the basket by its issue (⌈A/2⌉ draws and A(A+1)/2 FMAs a
// step, A expf a date for the arithmetic value and a logf for the
// dispersion). Simple first: no TMA, no wgmma, no shared memory.
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "basket_spec.cuh"
#include "basket_step.cuh"
#include "heston_step.cuh"
#include "merton_step.cuh"
#include "path_stream.cuh"

namespace {

constexpr int kThreads = 256;

// Heston: params [C, 10] = spot strike T r q v0 kappa theta xi rho; price and
// var [C, monitors, rows·cols]. The step is heston_step.cuh's.
__global__ void american_heston_kernel(const float* __restrict__ params,
                                       const uint32_t* __restrict__ keys,
                                       float* __restrict__ price, float* __restrict__ var,
                                       int64_t rows, int64_t cols, int timesteps, int every,
                                       int64_t half, int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const int64_t n = rows * cols;
  const float sign = s.sign;
  const float* p = params + 10 * c;
  const float spot = p[0], v0 = p[5];
  const HestonCoeffs h = heston_coeffs(p, timesteps);
  const int monitors = timesteps / every;
  const int64_t base = static_cast<int64_t>(c) * monitors * n + local;
  float* po = price + base;
  float* vo = var + base;
  float logx = logf(spot);
  float v = v0;
  if (every == 1) {  // the main path's grid: a date a step, two a Philox call
    walk_draws<1>(s, timesteps, [&](int, const uint2 (&d)[1]) {
      heston_step<false>(h, sign, d[0], logx, v);
      *po = expf(logx);
      *vo = fmaxf(v, 0.0f);
      po += n;
      vo += n;
    });
    return;
  }
  int j = 0;
#pragma unroll 1
  for (int d = 0; d < monitors; ++d) {
#pragma unroll 1
    for (int q = 0; q < every; ++q, ++j) {
      uint2 w;
      s.draw(j, w);
      heston_step<false>(h, sign, w, logx, v);
    }
    *po = expf(logx);
    *vo = fmaxf(v, 0.0f);
    po += n;
    vo += n;
  }
}

// Merton: params [C, 9] = spot strike T r q vol lam jump_mean jump_std;
// table [C, 20] merton_step.cuh's coefficients and levels; price [C,
// monitors, n]. The step is merton_step.cuh's.
__global__ void american_merton_kernel(const float* __restrict__ params,
                                       const uint32_t* __restrict__ keys,
                                       const float* __restrict__ table,
                                       float* __restrict__ price, int64_t rows, int64_t cols,
                                       int timesteps, int every, int64_t half,
                                       int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const int64_t n = rows * cols;
  const float sign = s.sign;
  const MertonCoeffs k = merton_coeffs(table, c);
  const int monitors = timesteps / every;
  float* o = price + static_cast<int64_t>(c) * monitors * n + local;
  float logx = logf(params[9 * c]);
  if (every == 1) {  // the main path's grid: a date a step, four on three Philox calls
    walk_triples(s, timesteps, [&](int, uint2 d, uint32_t w) {
      merton_step<false>(k, sign, d, w, logx);
      *o = expf(logx); o += n;  // one line: chip_smoke.py's SASS split reads it as the stores
    });
    return;
  }
  int t = 0;
#pragma unroll 1
  for (int m = 0; m < monitors; ++m) {
#pragma unroll 1
    for (int q = 0; q < every; ++q, ++t) {
      uint2 d;
      uint32_t w;
      s.triple(t, d, w);
      merton_step<false>(k, sign, d, w, logx);
    }
    *o = expf(logx); o += n;
  }
}

// Baskets: params [C, 6]; price (and, arithmetic, disp) [C, monitors, n]. The
// step is basket_step.cuh's.
template <int kA, bool kGeo>
__global__ void american_basket_kernel(const float* __restrict__ params,
                                       const uint32_t* __restrict__ keys, const BasketArgs spec,
                                       float* __restrict__ price, float* __restrict__ disp,
                                       int64_t rows, int64_t cols, int timesteps, int every,
                                       int64_t half, int64_t row_offset) {
  constexpr int kPairs = (kA + 1) / 2;
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const int64_t n = rows * cols;
  const float sign = s.sign;
  float logx[kA];
  const BasketCoeffs<kA> k = basket_coeffs<kA>(params + 6 * c, timesteps, spec, logx);
  const int monitors = timesteps / every;
  const int64_t base = static_cast<int64_t>(c) * monitors * n + local;
  if (every == 1) {  // the main path's grid: a date a step, whole Philox calls
    float* po = price + base;
    float* dp = kGeo ? nullptr : disp + base;
    walk_draws<kPairs>(s, timesteps, [&](int, const uint2 (&d)[kPairs]) {
      float inc[kA];
      basket_step<kA>(spec, k, sign, d, logx, inc);
      const float value = basket_value<kA, kGeo>(logx, spec);
      *po = value;
      po += n;
      if constexpr (!kGeo) {
        *dp = logf(value) - log_geometric<kA>(logx, spec);
        dp += n;
      }
    });
    return;
  }
  int j = 0;
#pragma unroll 1
  for (int d = 0; d < monitors; ++d) {
#pragma unroll 1
    for (int q = 0; q < every; ++q) {
      uint2 w[kPairs];
#pragma unroll
      for (int r = 0; r < kPairs; ++r, ++j) s.draw(j, w[r]);
      float inc[kA];
      basket_step<kA>(spec, k, sign, w, logx, inc);
    }
    const int64_t at = base + static_cast<int64_t>(d) * n;
    const float value = basket_value<kA, kGeo>(logx, spec);
    price[at] = value;
    if constexpr (!kGeo) disp[at] = logf(value) - log_geometric<kA>(logx, spec);
  }
}

template <int kA>
int launch_basket(const float* params, const uint32_t* keys, const BasketArgs& spec, float* price,
                  float* disp, int contracts, long long rows, long long cols, int timesteps,
                  int every, int geometric, long long half, long long row_offset,
                  cudaStream_t stream) {
  const dim3 grid = grid_of(contracts, rows, cols, kThreads);
  if (geometric) {
    american_basket_kernel<kA, true><<<grid, kThreads, 0, stream>>>(
        params, keys, spec, price, disp, rows, cols, timesteps, every, half, row_offset);
  } else {
    american_basket_kernel<kA, false><<<grid, kThreads, 0, stream>>>(
        params, keys, spec, price, disp, rows, cols, timesteps, every, half, row_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int american_heston_launch(const void* params, const void* keys, void* price,
                                      void* var, int contracts, long long rows, long long cols,
                                      int timesteps, int every, long long half,
                                      long long row_offset, void* stream) {
  american_heston_kernel<<<grid_of(contracts, rows, cols, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const uint32_t*>(keys),
      static_cast<float*>(price), static_cast<float*>(var), rows, cols, timesteps, every, half,
      row_offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int american_merton_launch(const void* params, const void* keys, const void* table,
                                      void* price, int contracts, long long rows, long long cols,
                                      int timesteps, int every, long long half,
                                      long long row_offset, void* stream) {
  american_merton_kernel<<<grid_of(contracts, rows, cols, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const uint32_t*>(keys),
      static_cast<const float*>(table), static_cast<float*>(price), rows, cols, timesteps,
      every, half, row_offset);
  return static_cast<int>(cudaGetLastError());
}

// spec_host: host float32 [3·8 + 8·8] (ops/basket_cuda.py::spec_table), copied
// into the by-value kernel argument; disp is unused (may be null) when
// geometric.
extern "C" int american_basket_launch(const void* params, const void* keys,
                                      const void* spec_host, void* price, void* disp,
                                      int contracts, long long rows, long long cols,
                                      int timesteps, int every, int assets, int geometric,
                                      long long half, long long row_offset, void* stream) {
  BasketArgs spec;
  memcpy(&spec, spec_host, sizeof(spec));
  const float* pp = static_cast<const float*>(params);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  float* po = static_cast<float*>(price);
  float* dp = static_cast<float*>(disp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ASSETS_CASE(A)                                                                        \
  case A:                                                                                     \
    return launch_basket<A>(pp, kp, spec, po, dp, contracts, rows, cols, timesteps, every,     \
                            geometric, half, row_offset, st);
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
