// American (Bermudan) pricing under flat GBM for a batch of contracts: the
// monitor-row forward of the "cuda" MC engine (the backward that turns its
// rows into exercise cashflows is csrc/lsmc_backward.cuh).
//
// Replaces ops/gbm_pallas.py::_gbm_monitor_block_kernel (american_gbm_kernel):
// log-Euler GBM writing exp(log S) at every monitor date. Per monitor
// segment of `every` steps: every/2 pair steps (one Box–Muller draw advances
// two steps, z1 + z2 = r·(cos θ + sin θ): the flat kernel's TERMINAL pair
// step itself, gbm_step.cuh's gbm_pair_step and its transform), then one
// single step z = r·cos θ when `every` is odd, its transform on the SFU
// (path_stream.cuh's box_muller_sfu_cos, the basket kernels' odd-asset
// draw). That draw order per segment is the american_gbm v3 stream; with
// `every` even the last monitor row is the TERMINAL branch's value bit for
// bit (the same pair step on the same words). The TPU's VMEM block budget is
// dropped; the monitor count stays capped at 128
// (ops/gbm_cuda.py::MAX_MONITOR_DATES).
//
// Bound on Hopper: by its output (n_monitor floats a path) at every = 1 and
// by its draws' transcendentals at every ≥ 4. At every = 1 its issue holds
// it far from the byte bound (PERF.md §6), so the main path's case has a
// loop of its own: whole Philox calls walked two dates a call, each word's
// place fixed when compiling (walk_draws, no parity select), the single
// step's transform on the SFU, and a store pointer that moves one row of
// paths a date (no 64-bit index product). Other grids keep the rolled loop,
// which draws one by one (PathStream::draw).
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gbm_step.cuh"
#include "path_stream.cuh"

namespace {

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
  float* o = out + static_cast<int64_t>(c) * monitors * n + local;
  float logx = logf(spot);
  if (every == 1) {
    walk_draws<1>(s, monitors, [&](int, const uint2 (&d)[1]) {
      float rad, cs;
      box_muller_sfu_cos(d[0], rad, cs);
      logx = (logx + drift) + vol_sdt * (sign * (rad * cs));
      *o = expf(logx);
      o += n;
    });
    return;
  }
  const int pairs = every / 2;
  const float vs = sign * vol_sdt;  // the antithetic sign folded in (exact)
  int j = 0;
  for (int d = 0; d < monitors; ++d) {
    for (int q = 0; q < pairs; ++q, ++j) {
      uint2 w;
      s.draw(j, w);
      logx = gbm_pair_step(logx, w, two_drift, vs);
    }
    if (every & 1) {
      uint2 w;
      s.draw(j++, w);
      float rad, cs;
      box_muller_sfu_cos(w, rad, cs);
      logx = (logx + drift) + vol_sdt * (sign * (rad * cs));
    }
    *o = expf(logx);
    o += n;
  }
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
