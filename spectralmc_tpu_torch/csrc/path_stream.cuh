// The Philox-4x32-10 path stream shared by the "cuda" MC engine's kernels.
//
// One thread owns one path. Its stream is keyed by the contract's two threefry
// words with the counter (path index lo, path index hi, call index, 0), where
// path = base_row * cols + col and base_row is the GLOBAL row (row_offset
// included) folded onto the first half under antithetic pairing: global row
// r >= half reuses row r - half's words with the sign -1. The stream is thus a
// pure function of (key, global row, col, call) and stays put under contract
// chunking or row sharding. The payoff family codes are shared too.
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// payoff families (the Python side's _FAMILY_CODE)
constexpr int kTerminal = 0;
constexpr int kBarrier = 1;   // variant: 1 = up-and-out, 0 = down-and-out
constexpr int kLookback = 2;  // variant: 0 fixed call, 1 fixed put, 2 float call, 3 float put
constexpr int kVariance = 3;
constexpr int kAsian = 4;     // variant: 0 arithmetic, 1 geometric

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

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

// One thread's path: its Philox counter, key and antithetic sign.
struct PathStream {
  uint32_t c0, c1, k0, k1;
  float sign;
  uint4 w;

  // Uniforms (u1, u2) of draw j; a new Philox call every other draw.
  __device__ __forceinline__ void draw(int j, float& u1, float& u2) {
    if ((j & 1) == 0) w = philox4x32_10(make_uint4(c0, c1, j >> 1, 0u), k0, k1);
    u1 = uniform_open((j & 1) ? w.z : w.x);
    u2 = uniform_closed((j & 1) ? w.w : w.y);
  }
};

// Sets up the thread's path; false when the thread has no path.
__device__ __forceinline__ bool path_setup(const uint32_t* __restrict__ keys, int64_t rows,
                                           int64_t cols, int64_t half, int64_t row_offset,
                                           int64_t& local, int& c, PathStream& s) {
  const int64_t n = rows * cols;
  local = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (local >= n) return false;
  c = blockIdx.y;
  const int64_t lrow = local / cols;
  const int64_t col = local - lrow * cols;
  int64_t row = row_offset + lrow;
  s.sign = 1.0f;
  if (half > 0 && row >= half) {
    row -= half;
    s.sign = -1.0f;
  }
  const uint64_t path = static_cast<uint64_t>(row) * static_cast<uint64_t>(cols) +
                        static_cast<uint64_t>(col);
  s.c0 = static_cast<uint32_t>(path);
  s.c1 = static_cast<uint32_t>(path >> 32);
  s.k0 = keys[2 * c];
  s.k1 = keys[2 * c + 1];
  s.w = make_uint4(0u, 0u, 0u, 0u);
  return true;
}

inline dim3 grid_of(int contracts, long long rows, long long cols, int threads) {
  const long long paths = rows * cols;
  return dim3(static_cast<unsigned>((paths + threads - 1) / threads),
              static_cast<unsigned>(contracts));
}

}  // namespace
