// Terminal GBM values for a batch of contracts: the "cuda" MC engine.
//
// Replaces the TERMINAL branch of the JAX package's
// ops/gbm_pallas.py::_gbm_block_kernel (launched by _simulate_rows_pallas_f32),
// both path schemes. What it keeps of that kernel is the math:
//   * uniforms from the top 24 bits of a word: u1 = b·2^-24 + 2^-25 (so
//     log u1 is finite), u2 = b·2^-24;
//   * Box–Muller radius r = sqrt(-2 ln u1);
//   * log-Euler pair-step: two steps share one draw, since
//     z1 + z2 = r·(cos θ + sin θ) = r·√2·sin(θ + π/4); an odd tail takes one
//     single step with z = r·cos θ;
//   * reflection-Euler: x ← |x·(1 + (r−q)dt + vol√dt·z)|, a fresh z per step;
//   * antithetic mirroring and one float written per path.
// What it drops is what the TPU needed: the hardware PRNG (here a Philox-4x32-10
// stream keyed by the contract's two threefry words, with the counter
// (path index lo, path index hi, call index, 0), so the stream is a pure
// function of (key, global row, col, step) and stays put under contract
// chunking or row sharding), the polynomial sine, the rsqrt radius and the
// 256x256 VMEM blocks. One thread owns one path and loops over time steps.
//
// Bound on Hopper: transcendental and integer issue. Per two log-Euler steps a
// path costs half a Philox call (10 rounds of two 32-bit mul-hi/lo), one logf,
// one sqrtf and one sinpif; it reads 24 bytes of contract once and stores 4
// bytes at the end, so memory traffic is negligible. The design keeps the
// whole path in registers and never materializes a normals matrix in device
// memory.
//
// Antithetic: global row r >= half reuses row r - half's words with z negated
// (the threefry engine's global-half convention, not the TPU's in-block mirror).
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr float kSqrt2 = 1.41421356f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_open(uint32_t w) {
  return static_cast<float>(w >> 8) * 0x1p-24f + 0x1p-25f;
}

__device__ __forceinline__ float uniform_closed(uint32_t w) {
  return static_cast<float>(w >> 8) * 0x1p-24f;
}

__global__ void gbm_terminal_kernel(const float* __restrict__ params,
                                    const uint32_t* __restrict__ keys,
                                    float* __restrict__ out, int64_t rows, int64_t cols,
                                    int timesteps, int scheme, int64_t half,
                                    int64_t row_offset) {
  const int64_t n = rows * cols;
  const int64_t local = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (local >= n) return;
  const int c = blockIdx.y;
  const int64_t lrow = local / cols;
  const int64_t col = local - lrow * cols;
  int64_t row = row_offset + lrow;
  float sign = 1.0f;
  if (half > 0 && row >= half) {
    row -= half;
    sign = -1.0f;
  }
  const uint64_t path = static_cast<uint64_t>(row) * static_cast<uint64_t>(cols) +
                        static_cast<uint64_t>(col);
  const uint32_t c0 = static_cast<uint32_t>(path);
  const uint32_t c1 = static_cast<uint32_t>(path >> 32);
  const uint32_t k0 = keys[2 * c];
  const uint32_t k1 = keys[2 * c + 1];

  const float* p = params + 6 * c;
  const float spot = p[0], maturity = p[2], rate = p[3], div = p[4], vol = p[5];
  // scalar set-up rounded op by op, as the plain version evaluates it
  const float dt = __fdiv_rn(maturity, static_cast<float>(timesteps));
  const float vol_sdt = __fmul_rn(vol, __fsqrt_rn(dt));
  const float carry = __fsub_rn(rate, div);

  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (scheme == 0) {  // log-Euler
    const float drift =
        __fmul_rn(__fsub_rn(carry, __fmul_rn(__fmul_rn(0.5f, vol), vol)), dt);
    const float two_drift = __fmul_rn(2.0f, drift);
    const int pairs = timesteps / 2;
    const int draws = pairs + (timesteps & 1);
    float logx = logf(spot);
    for (int j = 0; j < draws; ++j) {
      if ((j & 1) == 0) w = philox4x32_10(make_uint4(c0, c1, j >> 1, 0u), k0, k1);
      const float u1 = uniform_open((j & 1) ? w.z : w.x);
      const float u2 = uniform_closed((j & 1) ? w.w : w.y);
      const float rad = sqrtf(-2.0f * logf(u1));
      if (j < pairs) {
        const float z = sign * (rad * kSqrt2 * sinpif(2.0f * u2 + 0.25f));
        logx = (logx + two_drift) + vol_sdt * z;
      } else {
        const float z = sign * (rad * cospif(2.0f * u2));
        logx = (logx + drift) + vol_sdt * z;
      }
    }
    out[static_cast<int64_t>(c) * n + local] = expf(logx);
  } else {  // reflection-Euler
    const float growth = __fadd_rn(1.0f, __fmul_rn(carry, dt));
    float x = spot;
    for (int j = 0; j < timesteps; ++j) {
      if ((j & 1) == 0) w = philox4x32_10(make_uint4(c0, c1, j >> 1, 0u), k0, k1);
      const float u1 = uniform_open((j & 1) ? w.z : w.x);
      const float u2 = uniform_closed((j & 1) ? w.w : w.y);
      const float z = sign * (sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2));
      x = fabsf(x * (growth + vol_sdt * z));
    }
    out[static_cast<int64_t>(c) * n + local] = x;
  }
}

}  // namespace

extern "C" int gbm_terminal_launch(const void* params, const void* keys, void* out,
                                   int contracts, long long rows, long long cols,
                                   int timesteps, int scheme, long long half,
                                   long long row_offset, void* stream) {
  const int threads = 256;
  const long long paths = rows * cols;
  const dim3 grid(static_cast<unsigned>((paths + threads - 1) / threads),
                  static_cast<unsigned>(contracts));
  gbm_terminal_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const uint32_t*>(keys),
      static_cast<float*>(out), rows, cols, timesteps, scheme, half, row_offset);
  return static_cast<int>(cudaGetLastError());
}
