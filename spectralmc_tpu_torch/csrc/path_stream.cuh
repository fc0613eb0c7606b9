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

  // Philox call i's four words.
  __device__ __forceinline__ uint4 call(int i) const {
    return philox4x32_10(make_uint4(c0, c1, static_cast<uint32_t>(i), 0u), k0, k1);
  }

  // The words (a, b) of draw j, a new call every other draw: the rolled
  // loops of the monitor kernels, where a date may hold an odd step count.
  __device__ __forceinline__ void draw(int j, uint2& d) {
    if ((j & 1) == 0) w = call(j >> 1);
    d = (j & 1) ? make_uint2(w.z, w.w) : make_uint2(w.x, w.y);
  }

  // The pair d (words 3t, 3t + 1) and the third word c (3t + 2) of step t
  // of a three-word walk (walk_triples' layout), called for t = 0, 1, 2, ...
  // in order: the rolled loops of the Merton monitor kernel. Every step but
  // each fourth starts a call.
  __device__ __forceinline__ void triple(int t, uint2& d, uint32_t& c) {
    const int first = (t >> 2) * 3;
    switch (t & 3) {
      case 0:
        w = call(first);
        d = make_uint2(w.x, w.y);
        c = w.z;
        break;
      case 1: {
        const uint32_t a = w.w;
        w = call(first + 1);
        d = make_uint2(a, w.x);
        c = w.y;
        break;
      }
      case 2:
        d = make_uint2(w.z, w.w);
        w = call(first + 2);
        c = w.x;
        break;
      default:
        d = make_uint2(w.y, w.z);
        c = w.w;
    }
  }
};

// Sets up the thread's path; false when the thread has no path. Where every
// global path index of the launch fits in 31 bits (the main path's shapes),
// the row, the column and the counter come from 32-bit arithmetic (one
// unsigned division, no carries into a high word); otherwise from 64-bit.
// Both give the same counter, so the stream does not depend on the route.
__device__ __forceinline__ bool path_setup(const uint32_t* __restrict__ keys, int64_t rows,
                                           int64_t cols, int64_t half, int64_t row_offset,
                                           int64_t& local, int& c, PathStream& s) {
  const int64_t n = rows * cols;
  local = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (local >= n) return false;
  c = blockIdx.y;
  s.sign = 1.0f;
  const bool narrow = (row_offset + rows) * cols < (int64_t{1} << 31) && half < (int64_t{1} << 31);
  if (narrow) {
    const uint32_t w = static_cast<uint32_t>(cols), l = static_cast<uint32_t>(local);
    const uint32_t lrow = l / w;
    uint32_t row = static_cast<uint32_t>(row_offset) + lrow;
    if (half > 0 && row >= static_cast<uint32_t>(half)) {
      row -= static_cast<uint32_t>(half);
      s.sign = -1.0f;
    }
    s.c0 = row * w + (l - lrow * w);
    s.c1 = 0u;
  } else {
    const int64_t lrow = local / cols;
    const int64_t col = local - lrow * cols;
    int64_t row = row_offset + lrow;
    if (half > 0 && row >= half) {
      row -= half;
      s.sign = -1.0f;
    }
    const uint64_t path = static_cast<uint64_t>(row) * static_cast<uint64_t>(cols) +
                          static_cast<uint64_t>(col);
    s.c0 = static_cast<uint32_t>(path);
    s.c1 = static_cast<uint32_t>(path >> 32);
  }
  s.k0 = keys[2 * c];
  s.k1 = keys[2 * c + 1];
  s.w = make_uint4(0u, 0u, 0u, 0u);
  return true;
}

// ---------------------------------------------------------------------------
// Two walks over whole Philox calls: walk_draws, of two-word draws
// (heston_paths_kernel, basket_paths_kernel, every branch of
// gbm_paths_kernel, the one-draw branches of gbm_term_kernel, and at one
// date a step american_gbm_kernel, american_heston_kernel and
// american_basket_kernel), and walk_triples, of three-word steps
// (merton_paths_kernel, and at one date a step american_merton_kernel); and
// the SFU's Box–Muller transform, of the basket_gbm and american_basket_gbm
// v2 streams and american_gbm's single steps (heston_step.cuh has the
// fixed-rounding transform of the Heston, Merton, curved-term GBM and
// cliquet streams, and gbm_step.cuh the flat GBM streams' own, which takes
// its root from here: box_muller_root).
// ---------------------------------------------------------------------------

// Walks `steps` steps of kP draws each in the stream's draw order (draw
// j = t·kP + p is words 2(j%2), 2(j%2)+1 of call j/2) with every word's place
// known when compiling: an iteration covers kL steps, kL = 2 for odd kP and 1
// for even, so it takes kL·kP/2 whole calls and needs no parity test or
// select; for odd kP and odd `steps` one tail step follows, its last draw the
// first half of its call. step(t, d) advances step t on its draws' words d[p].
template <int kP, class Step>
__device__ __forceinline__ void walk_draws(const PathStream& s, int steps, Step&& step) {
  constexpr int kL = kP % 2 ? 2 : 1;
  constexpr int kCalls = kL * kP / 2;
  int t = 0;
  for (; t + kL <= steps; t += kL) {
    const int first = t / kL * kCalls;
    uint4 w[kCalls];
#pragma unroll
    for (int i = 0; i < kCalls; ++i) w[i] = s.call(first + i);
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      uint2 d[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const uint4& c = w[(l * kP + p) / 2];
        d[p] = (l * kP + p) % 2 ? make_uint2(c.z, c.w) : make_uint2(c.x, c.y);
      }
      step(t + l, d);
    }
  }
  if (kL == 2 && t < steps) {
    const int first = t / kL * kCalls;
    uint2 d[kP];
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p % 2 == 0) c = s.call(first + p / 2);
      d[p] = p % 2 ? make_uint2(c.z, c.w) : make_uint2(c.x, c.y);
    }
    step(t, d);
  }
}

// Walks `steps` steps of three words each in the stream's word order (step t
// reads words 3t, 3t + 1 and 3t + 2, word i being word i % 4 of call i / 4)
// with every word's place known when compiling: an iteration covers four
// steps on three whole calls, each made just before the first step that
// reads it (made all three first, ptxas split many of their products into
// IMAD.HI and IMAD pairs: chip_variants.py's `eager`, PERF.md §6); a tail
// of steps % 4
// steps takes the calls it reaches, the last of them for one word where the
// tail is three steps. step(t, d, c) advances step t on the pair d and the
// third word c.
template <class Step>
__device__ __forceinline__ void walk_triples(const PathStream& s, int steps, Step&& step) {
  int t = 0;
  for (; t + 4 <= steps; t += 4) {
    const int first = t / 4 * 3;
    const uint4 a = s.call(first);
    step(t, make_uint2(a.x, a.y), a.z);
    const uint4 b = s.call(first + 1);
    step(t + 1, make_uint2(a.w, b.x), b.y);
    const uint4 c = s.call(first + 2);
    step(t + 2, make_uint2(b.z, b.w), c.x);
    step(t + 3, make_uint2(c.y, c.z), c.w);
  }
  if (t < steps) {
    const int first = t / 4 * 3;
    const uint4 a = s.call(first);
    step(t, make_uint2(a.x, a.y), a.z);
    if (t + 1 < steps) {
      const uint4 b = s.call(first + 1);
      step(t + 1, make_uint2(a.w, b.x), b.y);
      if (t + 2 < steps) step(t + 2, make_uint2(b.z, b.w), s.call(first + 2).x);
    }
  }
}

// The Box–Muller transform on the SFU. u1 = uniform_open(a) lies in
// [2^-25, 1] (1 itself once in 2^24 words: the FMA rounds 1 − 2^-25 up), so
// −2·ln u1 is taken two ways, both relative-accurate:
//   * u1 < ½: MUFU.LG2 (lg2.approx, 2 ulp there) times −2·ln 2;
//   * u1 >= ½: d = u1 − 1 is exact (Sterbenz) and −2·ln(1 + d) =
//     −2d + d²·Q(d), Q a degree-7 fit of (−2·ln(1 + d) + 2d)/d² on [−½, 0],
//     the exact −2d added last (1.6 ulp over every u1 ≥ ½ of the stream:
//     tests/test_torch_sfu_streams.py), so the radius keeps its relative
//     accuracy as u1 nears 1, where MUFU's absolute error (2^-22) would
//     swamp it.
// The root is x·rsqrt(x) on MUFU.RSQ, x floored at FLT_MIN inside the root
// so that u1 = 1 gives a zero radius. The angle 2π·u2 is reduced to
// θ = 2π·(u2 − ½) in [−π, π) (u2 − ½ is exact), where MUFU.SIN and MUFU.COS
// hold an absolute error of 2^-21.4; cos 2πu2 = −cos θ and sin 2πu2 = −sin θ.
constexpr float kMinusTwoLn2 = -1.38629436f;
constexpr float kTwoPi = 6.28318548f;
__device__ __forceinline__ float lg2_sfu(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_sfu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sin_sfu(float x) {
  float y;
  asm("sin.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float cos_sfu(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// −2·ln u1, > 0 but for u1 = 1.
__device__ __forceinline__ float minus_two_log(float u1) {
  const float d = u1 - 1.0f;
  float q = -2.9005215f;
  q = fmaf(q, d, -3.4206872f);
  q = fmaf(q, d, -2.5309794f);
  q = fmaf(q, d, -0.4091283f);
  q = fmaf(q, d, -0.5381754f);
  q = fmaf(q, d, 0.48604572f);
  q = fmaf(q, d, -0.66734076f);
  q = fmaf(q, d, 0.9999889f);
  return u1 < 0.5f ? kMinusTwoLn2 * lg2_sfu(u1) : fmaf(d * d, q, -2.0f * d);
}

// The radius √x of its square x = −2·ln u1 (x·rsqrt(x) on the SFU).
__device__ __forceinline__ float box_muller_root(float x) {
  return x * rsqrt_sfu(fmaxf(x, 1.17549435e-38f));
}

// The radius √(−2·ln u1) of draw (a, ·).
__device__ __forceinline__ float box_muller_radius(uint32_t a) {
  return box_muller_root(minus_two_log(uniform_open(a)));
}

// θ of draw (·, b): 2π·u2 less π.
__device__ __forceinline__ float box_muller_angle(uint32_t b) {
  return kTwoPi * (uniform_closed(b) - 0.5f);
}

// The pair (cos 2πu2, sin 2πu2) of draw (a, b) and its radius.
__device__ __forceinline__ void box_muller_sfu(uint2 d, float& rad, float& cs, float& sn) {
  rad = box_muller_radius(d.x);
  const float theta = box_muller_angle(d.y);
  cs = -cos_sfu(theta);
  sn = -sin_sfu(theta);
}

// The cosine alone: a draw whose sine no one reads.
__device__ __forceinline__ void box_muller_sfu_cos(uint2 d, float& rad, float& cs) {
  rad = box_muller_radius(d.x);
  cs = -cos_sfu(box_muller_angle(d.y));
}

inline dim3 grid_of(int contracts, long long rows, long long cols, int threads) {
  const long long paths = rows * cols;
  return dim3(static_cast<unsigned>((paths + threads - 1) / threads),
              static_cast<unsigned>(contracts));
}

}  // namespace
