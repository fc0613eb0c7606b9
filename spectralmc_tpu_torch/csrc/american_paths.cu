// American (Bermudan) pricing under flat GBM for a batch of contracts: the
// monitor-row forward and the Longstaff–Schwartz backward of the "cuda" MC
// engine.
//
// Replaces three kernels of the JAX package:
//   * ops/gbm_pallas.py::_gbm_monitor_block_kernel (american_gbm_kernel):
//     log-Euler GBM writing exp(log S) at every monitor date. Per monitor
//     segment of `every` steps: every/2 pair steps (one Box–Muller draw
//     advances two steps, z1 + z2 = r·√2·sin(θ + π/4), as the flat kernel's
//     TERMINAL branch does), then one single step z = r·cos θ when `every` is
//     odd. That draw order per segment is the american_gbm v1 stream; with
//     `every` even the last monitor row is the TERMINAL branch's value. The
//     TPU's VMEM block budget is dropped; the monitor count stays capped at
//     128 (ops/gbm_cuda.py::MAX_MONITOR_DATES).
//   * ops/lsmc_pallas.py::_fused_backward_kernel (the carrier resident in
//     VMEM, up to 2^20 paths) and ::_streamed_backward_kernel (the carrier in
//     HBM past that) (lsmc_sweep_kernel + lsmc_solve_kernel). The two split
//     only on the TPU core's VMEM; here the carrier of a contract chunk lives
//     in device memory at any size, so one schedule serves both: the
//     streamed kernel's lagged one. Per monitor date g (walking maturity →
//     t_1) one sweep reads row g and the carrier, applies the exercise policy
//     with β_g, writes the carrier, and accumulates the regression moments of
//     date g − 1 from row g − 1 and the new carrier: 4 slabs per date where
//     an unfused pass moves 5. The seed sweep writes immediate(row n−1) and
//     the moments of date n − 2; the last sweep folds the final discount and
//     the encode u = K − disc·cf/df. Between sweeps a small launch reduces
//     each contract's per-block partial moments and solves the k×k ridge
//     system (ops/american.py::_ridge_chol_solve's order of operations).
//
// The estimator: basis x^a with x = 5·(S/K − 1), weights itm = [payoff > 0],
// moments Σ itm·x^a (a ≤ 2d) and Σ itm·disc·cf·x^a (a ≤ d) scaled by 1/N,
// the continuation value by Horner, exercise where itm and payoff > it.
// Reductions: each thread sums its 16 paths in order, each block folds its
// 256 threads by a halving tree in shared memory, and the solve sums the
// blocks' partials (thread t: blocks t, t + 256, …, in order) and folds its
// threads the same way. No atomics and no FMA contraction (every operation
// of the moments, the policy and the solve is an _rn intrinsic), so a run is
// deterministic and the plain twin (ops/american_cuda.py) reproduces β and
// every exercise decision bit for bit.
//
// Bound on Hopper: the forward by its output (n_monitor floats a path) at
// every = 1 and by its draws' transcendentals at every ≥ 4; the backward by
// bytes — the function reads each monitor row once and writes u once, the
// lagged schedule moves 4 slabs a date (the JAX kernel's own cost model
// counts (n + 1) slabs, so this schedule cannot pass ≈ 27% of that bound at
// 16 dates). Simple first: no TMA, no persistent grid.
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; each C entry point returns the first cudaGetLastError() that
// is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include "path_stream.cuh"

namespace {

constexpr float kSqrt2 = 1.41421356f;
constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kBlockPaths = kThreads * kPerThread;

// The monitor-row GBM forward: out[c][d][path] = S at monitor date d + 1.
__global__ void american_gbm_kernel(const float* __restrict__ params,
                                    const uint32_t* __restrict__ keys, float* __restrict__ out,
                                    int64_t rows, int64_t cols, int timesteps, int every,
                                    int64_t half, int64_t row_offset) {
  int64_t local;
  int c;
  PathStream s;
  if (!path_setup(keys, rows, cols, half, row_offset, local, c, s)) return;
  const int64_t n = rows * cols;
  const float sign = s.sign;

  const float* p = params + 6 * c;
  const float spot = p[0], maturity = p[2], rate = p[3], div = p[4], vol = p[5];
  // scalar set-up rounded op by op, as the plain version evaluates it
  const float dt = __fdiv_rn(maturity, static_cast<float>(timesteps));
  const float vol_sdt = __fmul_rn(vol, __fsqrt_rn(dt));
  const float drift =
      __fmul_rn(__fsub_rn(__fsub_rn(rate, div), __fmul_rn(__fmul_rn(0.5f, vol), vol)), dt);
  const float two_drift = __fmul_rn(2.0f, drift);
  const int monitors = timesteps / every;
  const int pairs = every / 2;
  float* o = out + static_cast<int64_t>(c) * monitors * n + local;
  float logx = logf(spot);
  float u1, u2;
  int j = 0;
  for (int d = 0; d < monitors; ++d) {
    for (int q = 0; q < pairs; ++q, ++j) {
      s.draw(j, u1, u2);
      const float rad = sqrtf(-2.0f * logf(u1));
      const float z = sign * (rad * kSqrt2 * sinpif(2.0f * u2 + 0.25f));
      logx = (logx + two_drift) + vol_sdt * z;
    }
    if (every & 1) {
      s.draw(j, u1, u2);
      ++j;
      const float z = sign * (sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2));
      logx = (logx + drift) + vol_sdt * z;
    }
    o[static_cast<int64_t>(d) * n] = expf(logx);
  }
}

template <bool kPut>
__device__ __forceinline__ float immediate(float s, float strike) {
  return fmaxf(kPut ? __fsub_rn(strike, s) : __fsub_rn(s, strike), 0.0f);
}

__device__ __forceinline__ float moneyness(float s, float strike) {
  return __fmul_rn(__fsub_rn(__fdiv_rn(s, strike), 1.0f), 5.0f);
}

// Folds red[a][0..255] into red[a][0] by a halving tree (tid < stride adds
// tid + stride), the order the twin reproduces.
template <int kM>
__device__ __forceinline__ void tree_fold(float (&red)[kM][kThreads], int tid) {
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int a = 0; a < kM; ++a) red[a][tid] = __fadd_rn(red[a][tid], red[a][tid + stride]);
    }
    __syncthreads();
  }
}

// Sweep modes: the seed (carrier = immediate(row n−1)), a policy date, and
// the last policy date (t_1: discount to t = 0 and encode, no moments).
constexpr int kSeed = 0;
constexpr int kPolicy = 1;
constexpr int kLast = 2;

// One sweep over every path of every contract: the policy at row `policy`
// and, but for the last, the moments of row policy − 1 into per-block
// partials [C, blocks, 3d + 2].
template <int kDegree, bool kPut>
__global__ void __launch_bounds__(kThreads)
lsmc_sweep_kernel(const float* __restrict__ rows, float* __restrict__ carrier,
                  const float* __restrict__ beta, const float* __restrict__ scal,
                  float* __restrict__ partials, int64_t n, int monitors, int policy, int mode) {
  constexpr int kProd = 2 * kDegree + 1;
  constexpr int kK = kDegree + 1;
  constexpr int kM = kProd + kK;
  __shared__ float red[kM][kThreads];
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const float strike = scal[3 * c], disc = scal[3 * c + 1], df = scal[3 * c + 2];
  const float* row = rows + (static_cast<int64_t>(c) * monitors + policy) * n;
  float* car = carrier + static_cast<int64_t>(c) * n;
  float b[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) b[j] = mode == kSeed ? 0.0f : beta[c * kK + j];
  float acc[kM];
#pragma unroll
  for (int a = 0; a < kM; ++a) acc[a] = 0.0f;

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlockPaths + tid;
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    if (i >= n) break;
    const float sv = row[i];
    const float ex = immediate<kPut>(sv, strike);
    float cf = ex;
    if (mode != kSeed) {
      const float y = __fmul_rn(disc, car[i]);
      const float x = moneyness(sv, strike);
      float cont = b[kDegree];
#pragma unroll
      for (int j = kDegree - 1; j >= 0; --j) cont = __fadd_rn(__fmul_rn(cont, x), b[j]);
      cf = (ex > 0.0f && ex > cont) ? ex : y;
    }
    if (mode == kLast) {
      car[i] = __fsub_rn(strike, __fdiv_rn(__fmul_rn(disc, cf), df));
      continue;
    }
    car[i] = cf;
    const float s1 = row[i - n];  // the row of the date before
    const float itm = immediate<kPut>(s1, strike) > 0.0f ? 1.0f : 0.0f;
    const float wy = __fmul_rn(itm, __fmul_rn(disc, cf));
    const float x1 = moneyness(s1, strike);
    float pw = 1.0f;
#pragma unroll
    for (int a = 0; a < kProd; ++a) {
      acc[a] = __fadd_rn(acc[a], __fmul_rn(itm, pw));
      if (a < kK) acc[kProd + a] = __fadd_rn(acc[kProd + a], __fmul_rn(wy, pw));
      if (a + 1 < kProd) pw = __fmul_rn(pw, x1);
    }
  }
  if (mode == kLast) return;  // uniform over the grid: no block is left at a barrier
#pragma unroll
  for (int a = 0; a < kM; ++a) red[a][tid] = acc[a];
  __syncthreads();
  tree_fold<kM>(red, tid);
  if (tid < kM) {
    partials[(static_cast<int64_t>(c) * gridDim.x + blockIdx.x) * kM + tid] = red[tid][0];
  }
}

// (G + λ diag) β = rhs, k = kK, one thread: ops/american.py::_ridge_chol_solve
// op for op (a Python sum is a left fold from 0).
template <int kK>
__device__ void ridge_chol_solve(const float* mom, const float* rhs, float* beta) {
  const float eps = 1e-6f;
  const float tiny = 1e-30f;
  const float eps8 = __fmul_rn(8.0f, eps);
  float a[kK][kK];
  for (int i = 0; i < kK; ++i)
    for (int j = 0; j < kK; ++j) a[i][j] = mom[i + j];
  for (int i = 0; i < kK; ++i) a[i][i] = __fadd_rn(a[i][i], __fmul_rn(eps, fmaxf(a[i][i], tiny)));
  float low[kK][kK];
  float keep[kK];
  for (int j = 0; j < kK; ++j) {
    float sum = 0.0f;
    for (int m = 0; m < j; ++m) sum = __fadd_rn(sum, __fmul_rn(low[j][m], low[j][m]));
    const float d = __fsub_rn(a[j][j], sum);
    keep[j] = d >= __fmul_rn(eps8, a[j][j]) ? 1.0f : 0.0f;
    low[j][j] = __fsqrt_rn(fmaxf(fmaxf(d, __fmul_rn(eps, a[j][j])), tiny));
    for (int i = j + 1; i < kK; ++i) {
      float s = 0.0f;
      for (int m = 0; m < j; ++m) s = __fadd_rn(s, __fmul_rn(low[i][m], low[j][m]));
      low[i][j] = __fmul_rn(keep[j], __fdiv_rn(__fsub_rn(a[i][j], s), low[j][j]));
    }
  }
  float z[kK];
  for (int i = 0; i < kK; ++i) {
    float sum = 0.0f;
    for (int m = 0; m < i; ++m) sum = __fadd_rn(sum, __fmul_rn(low[i][m], z[m]));
    z[i] = __fmul_rn(keep[i], __fdiv_rn(__fsub_rn(rhs[i], sum), low[i][i]));
  }
  float out[kK];
  for (int i = kK - 1; i >= 0; --i) {
    float sum = 0.0f;
    for (int m = i + 1; m < kK; ++m) sum = __fadd_rn(sum, __fmul_rn(low[m][i], out[m]));
    out[i] = __fmul_rn(keep[i], __fdiv_rn(__fsub_rn(z[i], sum), low[i][i]));
  }
  for (int i = 0; i < kK; ++i) beta[i] = out[i];
}

// One block per contract: the partials summed in fixed block order, then
// the ridge solve into beta [C, d + 1].
template <int kDegree>
__global__ void __launch_bounds__(kThreads)
lsmc_solve_kernel(const float* __restrict__ partials, float* __restrict__ beta, int blocks,
                  float inv_n) {
  constexpr int kProd = 2 * kDegree + 1;
  constexpr int kK = kDegree + 1;
  constexpr int kM = kProd + kK;
  __shared__ float red[kM][kThreads];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float* p = partials + static_cast<int64_t>(c) * blocks * kM;
  float acc[kM];
#pragma unroll
  for (int a = 0; a < kM; ++a) acc[a] = 0.0f;
  for (int blk = tid; blk < blocks; blk += kThreads) {
#pragma unroll
    for (int a = 0; a < kM; ++a) acc[a] = __fadd_rn(acc[a], p[static_cast<int64_t>(blk) * kM + a]);
  }
#pragma unroll
  for (int a = 0; a < kM; ++a) red[a][tid] = acc[a];
  __syncthreads();
  tree_fold<kM>(red, tid);
  if (tid == 0) {
    float mom[kProd], rhs[kK];
    for (int a = 0; a < kProd; ++a) mom[a] = __fmul_rn(red[a][0], inv_n);
    for (int j = 0; j < kK; ++j) rhs[j] = __fmul_rn(red[kProd + j][0], inv_n);
    ridge_chol_solve<kK>(mom, rhs, beta + c * kK);
  }
}

template <int kDegree, bool kPut>
int lsmc_backward(const float* rows, float* carrier, float* beta, const float* scal,
                  float* partials, int contracts, long long n, int monitors, float inv_n,
                  cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + kBlockPaths - 1) / kBlockPaths);
  const dim3 grid(blocks, static_cast<unsigned>(contracts));
  lsmc_sweep_kernel<kDegree, kPut><<<grid, kThreads, 0, st>>>(
      rows, carrier, beta, scal, partials, n, monitors, monitors - 1, kSeed);
  cudaError_t err = cudaGetLastError();
  for (int policy = monitors - 2; policy >= 0 && err == cudaSuccess; --policy) {
    lsmc_solve_kernel<kDegree><<<contracts, kThreads, 0, st>>>(partials, beta,
                                                               static_cast<int>(blocks), inv_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    lsmc_sweep_kernel<kDegree, kPut><<<grid, kThreads, 0, st>>>(
        rows, carrier, beta, scal, partials, n, monitors, policy, policy == 0 ? kLast : kPolicy);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <int kDegree>
int lsmc_backward_side(int put, const float* rows, float* carrier, float* beta,
                       const float* scal, float* partials, int contracts, long long n,
                       int monitors, float inv_n, cudaStream_t st) {
  return put ? lsmc_backward<kDegree, true>(rows, carrier, beta, scal, partials, contracts, n,
                                            monitors, inv_n, st)
             : lsmc_backward<kDegree, false>(rows, carrier, beta, scal, partials, contracts, n,
                                             monitors, inv_n, st);
}

}  // namespace

extern "C" int american_gbm_launch(const void* params, const void* keys, void* out,
                                   int contracts, long long rows, long long cols, int timesteps,
                                   int every, long long half, long long row_offset,
                                   void* stream) {
  const int threads = 256;
  american_gbm_kernel<<<grid_of(contracts, rows, cols, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const uint32_t*>(keys),
      static_cast<float*>(out), rows, cols, timesteps, every, half, row_offset);
  return static_cast<int>(cudaGetLastError());
}

// rows [C, monitors, n] price rows; carrier [C, n] receives u; beta [C, d + 1]
// and partials [C, ceil(n / 4096), 3d + 2] are scratch; scal [C, 3] holds
// (strike, one-monitor-step discount, df(0, T)).
extern "C" int lsmc_backward_launch(const void* rows, void* carrier, void* beta,
                                    const void* scal, void* partials, int contracts,
                                    long long n, int monitors, int degree, int put, float inv_n,
                                    void* stream) {
  const float* r = static_cast<const float*>(rows);
  float* car = static_cast<float*>(carrier);
  float* b = static_cast<float*>(beta);
  const float* sc = static_cast<const float*>(scal);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (monitors < 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (degree) {
    case 1: return lsmc_backward_side<1>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 2: return lsmc_backward_side<2>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 3: return lsmc_backward_side<3>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 4: return lsmc_backward_side<4>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 5: return lsmc_backward_side<5>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 6: return lsmc_backward_side<6>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 7: return lsmc_backward_side<7>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    case 8: return lsmc_backward_side<8>(put, r, car, b, sc, part, contracts, n, monitors, inv_n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
