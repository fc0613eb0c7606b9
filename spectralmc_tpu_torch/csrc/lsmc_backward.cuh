// The Longstaff–Schwartz backward of the "cuda" MC engine, for a batch of
// contracts, in one persistent cooperative launch.
//
// Replaces ops/lsmc_pallas.py::_fused_backward_kernel (the carrier resident
// in VMEM, up to 2^20 paths) and ::_streamed_backward_kernel (the carrier in
// HBM past that). The TPU split on VMEM becomes a split on what this card
// holds on chip:
//   * resident (kResident): each CTA keeps, for the 4096-path tiles it owns,
//     the carrier and the last row read in shared memory across all dates
//     (8 B a path, 12 B with a second state). Contracts run in waves; a
//     wave's contracts split the grid into groups of CTAs, one contract a
//     group. Each monitor row is read from HBM once and u written once: the
//     n + 1 slabs of the bound (2n with a second state, whose row n − 1 no
//     regression reads).
//   * streamed: the carrier lives in the output buffer in HBM and the policy
//     row is read again, the lagged schedule of 4 slabs a date; every
//     contract of the batch is in flight at once, its tiles dealt
//     round-robin over the grid.
// Both are one launch a backward: a CTA walks its tiles date by date. Per
// date and contract each tile writes its partial moments; an atomic ticket
// picks the last CTA to arrive, which sums the partials in the fixed order
// below, solves the ridge system and publishes β with a release store; the
// CTAs that need β wait on that flag with an acquire load. The ticket
// decides who solves, never the order of a sum. The grid is sized from the
// occupancy calculator and launched cooperatively, so every CTA is
// co-resident and a wait always ends (a wait past ~5 s traps). A CTA walks
// its tiles in (date, contract) order and a tile waits only on tiles of an
// earlier date, so the earliest unfinished tile never waits.
//
// The estimator (ops/american.py::lsmc_backward, the JAX package's
// _lsmc_backward): basis x^a with x = 5·(S/K − 1) and, with a second state
// (kTwo), the columns [v, v·x, v²] of v = 20·extra; weights itm = [payoff >
// 0]; the normal equations as moments scaled by 1/N; the continuation value
// by Horner in x plus the three state terms; exercise where itm and payoff >
// continuation. Reductions: each thread sums its 16 paths of a tile (paths
// tile·4096 + k·256 + t, k in order) and the solver sums the tiles'
// partials (thread t: tiles t, t + 256, …, in order); then each folds its
// 256 threads — single state (version 3) by the halving tree over all 256,
// the order of the sweep/solve pair that version 3 first ran, so u stays bit
// for bit that pair's; two states (version 4) by a halving tree over each
// warp's 32 lanes and then the 8 warps in order, which needs one barrier
// where the 256-thread tree needs four. No atomics in a sum and no FMA
// contraction (every operation of the moments, the policy and the solve is
// an _rn intrinsic): a run is deterministic, and the plain twin
// (ops/american_cuda.py) reproduces β and every exercise decision of both.
//
// Bound on Hopper: bytes (4 per path and slab) against instruction issue
// (≈ 100 SASS a path-date at degree 5, single state, two IEEE divisions
// among them); what the time spends beyond that goes to the per-tile folds'
// barriers and to the wait from a date's last tile to the next date's β.
//
// Contract: launches on the given stream, allocates nothing, does not
// synchronise; the caller zeroes the [2C] ticket/epoch words before each
// launch; each C entry point returns the first CUDA error, if any.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lsmc {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTilePaths = kThreads * kPerThread;
constexpr int kMaxSlots = 8;
constexpr long long kWaitCycles = 10000000000LL;  // ~5 s at 1.98 GHz

// The basis of degree kDegree (columns (j, 0), j ≤ d; with kTwo also
// (0, 1), (1, 1), (0, 2) as exponents of (x, v)) and its moment layout:
// the products (a, b) grouped by b — (a, 0) a ≤ 2d; (a, 1) a ≤ d + 1;
// (a, 2) a ≤ max(d, 2); (a, 3) a ≤ 1; (0, 4) — then the kK right-hand
// sides in column order.
template <int kDegree, bool kTwo>
struct Basis {
  static constexpr int kBaseK = kDegree + 1;
  static constexpr int kK = kBaseK + (kTwo ? 3 : 0);
  static constexpr int kX = 2 * kDegree + 1;
  static constexpr int kLen1 = kDegree + 2;
  static constexpr int kLen2 = (kDegree > 2 ? kDegree : 2) + 1;
  static constexpr int kOff1 = kX;
  static constexpr int kOff2 = kOff1 + kLen1;
  static constexpr int kOff3 = kOff2 + kLen2;
  static constexpr int kOff4 = kOff3 + 2;
  static constexpr int kP = kTwo ? kOff4 + 1 : kX;
  static constexpr int kM = kP + kK;
  static constexpr int kState = kTwo ? 3 : 2;  // floats a path kept on chip

  __host__ __device__ static constexpr int idx(int a, int b) {
    return b == 0 ? a : b == 1 ? kOff1 + a : b == 2 ? kOff2 + a : b == 3 ? kOff3 + a : kOff4 + a;
  }
  __host__ __device__ static constexpr int col_a(int j) {
    return j < kBaseK ? j : (j == kBaseK + 1 ? 1 : 0);
  }
  __host__ __device__ static constexpr int col_b(int j) {
    return j < kBaseK ? 0 : (j == kBaseK + 2 ? 2 : 1);
  }
};

struct Args {
  const float* rows;    // [C, monitors, n] prices
  const float* extra;   // [C, monitors, n] second state (kTwo) or null
  float* out;           // [C, n] u (and the streamed carrier)
  const float* scal;    // [C, 3] strike, one-date discount, df(0, T)
  float* partials;      // [C, tiles, kM]
  float* beta;          // [C, kK]
  unsigned* tickets;    // [C], zero at launch
  unsigned* epochs;     // [C], zero at launch
  int contracts;
  int monitors;
  int tiles;
  int wave;             // contracts per wave (resident)
  long long n;
  float inv_n;
  int put;
};

__device__ __forceinline__ float immediate(float s, float strike, int put) {
  return fmaxf(put ? __fsub_rn(strike, s) : __fsub_rn(s, strike), 0.0f);
}

__device__ __forceinline__ float moneyness(float s, float strike) {
  return __fmul_rn(__fsub_rn(__fdiv_rn(s, strike), 1.0f), 5.0f);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// atomicAdd(p, 1) with acquire-release semantics: this thread's earlier
// writes (a tile's partials) are visible to whoever acquires the count, and
// the last to take it sees every earlier taker's.
__device__ __forceinline__ unsigned ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The 256-thread halving tree (at stride s thread t < s adds thread t + s),
// kChunk moments a pass: strides 128 (in two halves), 64 and 32 through
// the two [kChunk][64] buffers of `scratch` in turn, so each stage needs one
// barrier (a buffer is written again only after a barrier that every reader
// of its last stage has passed); then 16 … 1 by shuffles in warp 0. Thread
// 0 ends with the sums. Every thread of the CTA calls it.
constexpr int kChunk = 18;
constexpr int kScratchFloats = 2 * kChunk * 64;

template <int kM>
__device__ __forceinline__ void tree_fold(float (&v)[kM], float* scratch, int tid) {
  float* buf0 = scratch;
  float* buf1 = scratch + kChunk * 64;
#pragma unroll
  for (int first = 0; first < kM; first += kChunk) {
    const int last = first + kChunk < kM ? first + kChunk : kM;
    if (tid >= 128 && tid < 192) {
#pragma unroll
      for (int a = first; a < last; ++a) buf0[(a - first) * 64 + tid - 128] = v[a];
    }
    __syncthreads();
    if (tid < 64) {
#pragma unroll
      for (int a = first; a < last; ++a) v[a] = __fadd_rn(v[a], buf0[(a - first) * 64 + tid]);
    }
    if (tid >= 192) {
#pragma unroll
      for (int a = first; a < last; ++a) buf1[(a - first) * 64 + tid - 192] = v[a];
    }
    __syncthreads();
    if (tid >= 64 && tid < 128) {
#pragma unroll
      for (int a = first; a < last; ++a) {
        v[a] = __fadd_rn(v[a], buf1[(a - first) * 64 + tid - 64]);
        buf0[(a - first) * 64 + tid - 64] = v[a];  // stride 64
      }
    }
    __syncthreads();
    if (tid < 64) {
#pragma unroll
      for (int a = first; a < last; ++a) v[a] = __fadd_rn(v[a], buf0[(a - first) * 64 + tid]);
    }
    if (tid >= 32 && tid < 64) {
#pragma unroll
      for (int a = first; a < last; ++a) buf1[(a - first) * 64 + tid - 32] = v[a];  // stride 32
    }
    __syncthreads();
    if (tid < 32) {
#pragma unroll
      for (int a = first; a < last; ++a) v[a] = __fadd_rn(v[a], buf1[(a - first) * 64 + tid]);
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
      for (int a = 0; a < kM; ++a) v[a] = __fadd_rn(v[a], __shfl_down_sync(0xffffffffu, v[a], s));
    }
  }
}

// Version 4's fold (two states) of a CTA's 256 per-thread sums: a halving
// tree over each warp's 32 lanes by shuffles, then the 8 warps' sums in warp
// order by warp 0, whose lane l returns moment l's total in `lo` and moment
// l + 32's in `hi` (kM ≤ 51). One barrier; `xch` holds [8][kM].
template <int kM>
__device__ __forceinline__ void warp_fold(float (&v)[kM], float* xch, int tid, float& lo,
                                          float& hi) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int a = 0; a < kM; ++a) v[a] = __fadd_rn(v[a], __shfl_down_sync(0xffffffffu, v[a], s));
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < kM; ++a) xch[warp * kM + a] = v[a];
  }
  __syncthreads();
  lo = 0.0f;
  hi = 0.0f;
  if (warp == 0) {
    if (lane < kM) {
      lo = xch[lane];
      for (int w = 1; w < 8; ++w) lo = __fadd_rn(lo, xch[w * kM + lane]);
    }
    if (lane + 32 < kM) {
      hi = xch[lane + 32];
      for (int w = 1; w < 8; ++w) hi = __fadd_rn(hi, xch[w * kM + lane + 32]);
    }
  }
}

// One path's moments of a date: row s1 (and state e1) with the carrier cf.
template <class B>
__device__ __forceinline__ void accumulate(float (&acc)[B::kM], float s1, float e1, float cf,
                                           float strike, float disc, int put) {
  const float itm = immediate(s1, strike, put) > 0.0f ? 1.0f : 0.0f;
  const float wy = __fmul_rn(itm, __fmul_rn(disc, cf));
  const float x1 = moneyness(s1, strike);
  float xp[B::kX];
  float pw = 1.0f;
#pragma unroll
  for (int a = 0; a < B::kX; ++a) {
    xp[a] = pw;
    acc[a] = __fadd_rn(acc[a], __fmul_rn(itm, pw));
    if (a < B::kBaseK) acc[B::kP + a] = __fadd_rn(acc[B::kP + a], __fmul_rn(wy, pw));
    if (a + 1 < B::kX) pw = __fmul_rn(pw, x1);
  }
  if constexpr (B::kK > B::kBaseK) {
    float vp[5];
    vp[0] = 1.0f;
    vp[1] = __fmul_rn(e1, 20.0f);
#pragma unroll
    for (int b = 2; b < 5; ++b) vp[b] = __fmul_rn(vp[b - 1], vp[1]);
#pragma unroll
    for (int a = 0; a < B::kLen1; ++a)
      acc[B::kOff1 + a] = __fadd_rn(acc[B::kOff1 + a], __fmul_rn(itm, __fmul_rn(xp[a], vp[1])));
#pragma unroll
    for (int a = 0; a < B::kLen2; ++a)
      acc[B::kOff2 + a] = __fadd_rn(acc[B::kOff2 + a], __fmul_rn(itm, __fmul_rn(xp[a], vp[2])));
#pragma unroll
    for (int a = 0; a < 2; ++a)
      acc[B::kOff3 + a] = __fadd_rn(acc[B::kOff3 + a], __fmul_rn(itm, __fmul_rn(xp[a], vp[3])));
    acc[B::kOff4] = __fadd_rn(acc[B::kOff4], __fmul_rn(itm, __fmul_rn(xp[0], vp[4])));
#pragma unroll
    for (int j = B::kBaseK; j < B::kK; ++j) {
      acc[B::kP + j] = __fadd_rn(acc[B::kP + j],
                                 __fmul_rn(wy, __fmul_rn(xp[B::col_a(j)], vp[B::col_b(j)])));
    }
  }
}

// The exercise policy at a date: row sv (state ev), carrier car, β.
template <class B, int kDegree>
__device__ __forceinline__ float policy(float sv, float ev, float car, const float* b,
                                        float strike, float disc, int put) {
  const float ex = immediate(sv, strike, put);
  const float y = __fmul_rn(disc, car);
  const float x = moneyness(sv, strike);
  float cont = b[kDegree];
#pragma unroll
  for (int j = kDegree - 1; j >= 0; --j) cont = __fadd_rn(__fmul_rn(cont, x), b[j]);
  if constexpr (B::kK > B::kBaseK) {
    const float v = __fmul_rn(ev, 20.0f);
    cont = __fadd_rn(cont, __fmul_rn(b[B::kBaseK], v));
    cont = __fadd_rn(cont, __fmul_rn(b[B::kBaseK + 1], __fmul_rn(x, v)));
    cont = __fadd_rn(cont, __fmul_rn(b[B::kBaseK + 2], __fmul_rn(v, v)));
  }
  return (ex > 0.0f && ex > cont) ? ex : y;
}

// (G + λ diag) β = rhs, one thread: ops/american.py::_ridge_chol_solve op
// for op (a Python sum is a left fold from 0), unrolled so the system stays
// in registers: it lies on the path from a date's last tile to the next
// date's first.
template <int kK>
__device__ __forceinline__ void ridge_chol_solve(float (&a)[kK][kK], const float* rhs,
                                                 float* beta) {
  const float eps = 1e-6f;
  const float tiny = 1e-30f;
  const float eps8 = __fmul_rn(8.0f, eps);
#pragma unroll
  for (int i = 0; i < kK; ++i) a[i][i] = __fadd_rn(a[i][i], __fmul_rn(eps, fmaxf(a[i][i], tiny)));
  float low[kK][kK];
  float keep[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    float sum = 0.0f;
#pragma unroll
    for (int m = 0; m < j; ++m) sum = __fadd_rn(sum, __fmul_rn(low[j][m], low[j][m]));
    const float d = __fsub_rn(a[j][j], sum);
    keep[j] = d >= __fmul_rn(eps8, a[j][j]) ? 1.0f : 0.0f;
    low[j][j] = __fsqrt_rn(fmaxf(fmaxf(d, __fmul_rn(eps, a[j][j])), tiny));
#pragma unroll
    for (int i = j + 1; i < kK; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < j; ++m) s = __fadd_rn(s, __fmul_rn(low[i][m], low[j][m]));
      low[i][j] = __fmul_rn(keep[j], __fdiv_rn(__fsub_rn(a[i][j], s), low[j][j]));
    }
  }
  float z[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int m = 0; m < i; ++m) sum = __fadd_rn(sum, __fmul_rn(low[i][m], z[m]));
    z[i] = __fmul_rn(keep[i], __fdiv_rn(__fsub_rn(rhs[i], sum), low[i][i]));
  }
  float out[kK];
#pragma unroll
  for (int i = kK - 1; i >= 0; --i) {
    float sum = 0.0f;
#pragma unroll
    for (int m = i + 1; m < kK; ++m) sum = __fadd_rn(sum, __fmul_rn(low[m][i], out[m]));
    out[i] = __fmul_rn(keep[i], __fdiv_rn(__fsub_rn(z[i], sum), low[i][i]));
  }
#pragma unroll
  for (int i = 0; i < kK; ++i) beta[i] = out[i];
}

// The last CTA of a date: contract c's partials summed in the fixed order,
// the solve, β published as epoch `epoch`.
template <class B>
__device__ void solve_contract(const Args& a, int c, unsigned epoch, float* scratch, int tid) {
  float acc[B::kM];
#pragma unroll
  for (int m = 0; m < B::kM; ++m) acc[m] = 0.0f;
  const float* p = a.partials + static_cast<long long>(c) * a.tiles * B::kM;
  for (int blk = tid; blk < a.tiles; blk += kThreads) {
#pragma unroll
    for (int m = 0; m < B::kM; ++m)
      acc[m] = __fadd_rn(acc[m], __ldcg(p + static_cast<long long>(blk) * B::kM + m));
  }
  if constexpr (B::kK > B::kBaseK) {
    float lo, hi;
    float* xch = scratch + 8 * B::kM;  // not the tiles' buffer: warp 0 may still read it
    warp_fold<B::kM>(acc, xch, tid, lo, hi);
    float* tot = xch + 8 * B::kM;
    if (tid < 32) {  // warp 0 holds the totals
      if (tid < B::kM) tot[tid] = lo;
      if (tid + 32 < B::kM) tot[tid + 32] = hi;
      __syncwarp();
      if (tid == 0) {
#pragma unroll
        for (int m = 0; m < B::kM; ++m) acc[m] = tot[m];
      }
    }
  } else {
    tree_fold<B::kM>(acc, scratch, tid);
  }
  if (tid == 0) {
    float gram[B::kK][B::kK];
    float rhs[B::kK];
#pragma unroll
    for (int i = 0; i < B::kK; ++i) {
#pragma unroll
      for (int j = 0; j < B::kK; ++j) {
        gram[i][j] = __fmul_rn(acc[B::idx(B::col_a(i) + B::col_a(j), B::col_b(i) + B::col_b(j))],
                               a.inv_n);
      }
      rhs[i] = __fmul_rn(acc[B::kP + i], a.inv_n);
    }
    ridge_chol_solve<B::kK>(gram, rhs, a.beta + c * B::kK);
    store_release(a.epochs + c, epoch);  // β's writes before the flag
  }
}

// Waits until contract c's β of epoch `epoch` is published, then copies it
// to `sbeta` (one of two buffers used in turn, so the CTA's readers of the
// other are never overtaken) for the CTA.
template <int kK>
__device__ __forceinline__ void wait_beta(const Args& a, int c, unsigned epoch, float* sbeta,
                                          int tid) {
  if (tid == 0) {
    const unsigned* flag = a.epochs + c;
    if (load_acquire(flag) < epoch) {
      const long long start = clock64();
      while (load_acquire(flag) < epoch) {
        __nanosleep(64);
        if (clock64() - start > kWaitCycles) __trap();
      }
    }
#pragma unroll
    for (int j = 0; j < kK; ++j) sbeta[j] = __ldcg(a.beta + c * kK + j);
  }
  __syncthreads();
}

// Shared memory: the fold's buffers (the tree's two [kChunk][64]; version
// 4's tile exchange [8][kM], the solve's [8][kM] and its totals [kM]), two β
// buffers, the last-CTA flag, then (resident) `slots` tiles of kState floats
// a path.
template <class B>
__host__ __device__ constexpr int fold_floats() {  // the tree's buffers, or version 4's
  return B::kK > B::kBaseK ? 17 * B::kM : kScratchFloats;
}

template <class B>
__host__ __device__ constexpr int scratch_floats() {
  return fold_floats<B>() + 2 * 16 + 4;
}

template <class B>
__host__ __device__ constexpr long long smem_bytes(int slots) {
  return 4LL * (scratch_floats<B>() + static_cast<long long>(slots) * B::kState * kTilePaths);
}

// One item: contract c's tile at step s (0: the seed, carrier =
// immediate(row n − 1); s ≥ 1: the policy at date p = n − 1 − s with β of
// epoch s, waited for into `sbeta` where `wait`, else already there); then,
// but at p = 0, the moments of the next date back into the partials, and
// the solve if this CTA is the last of the date.
template <int kDegree, bool kTwo, bool kResident>
__device__ __forceinline__ void item(const Args& a, int s, int c, int tile, bool wait,
                                     float* slot, float* scratch, float* sbeta, int* sflag,
                                     int tid) {
  using B = Basis<kDegree, kTwo>;
  const long long n = a.n;
  const int p = a.monitors - 1 - s;
  const bool moments = s == 0 || p > 0;
  const float strike = a.scal[3 * c], disc = a.scal[3 * c + 1], df = a.scal[3 * c + 2];
  const float* rows = a.rows + static_cast<long long>(c) * a.monitors * n;
  const float* extra = kTwo ? a.extra + static_cast<long long>(c) * a.monitors * n : nullptr;
  float* out = a.out + static_cast<long long>(c) * n;
  const long long first = static_cast<long long>(tile) * kTilePaths + tid;
  const int mrow = s == 0 ? a.monitors - 2 : p - 1;  // the moments' date

  // the moments' rows (and, streamed, the policy's row and carrier), all
  // loaded before the wait for β
  float s1[kPerThread], e1[kPerThread];
  float sv[kResident ? 1 : kPerThread], ev[kResident || !kTwo ? 1 : kPerThread];
  float cv[kResident ? 1 : kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    const bool in = i < n;
    s1[k] = (moments && in) ? __ldg(rows + mrow * n + i) : 0.0f;
    e1[k] = (kTwo && moments && in) ? __ldg(extra + mrow * n + i) : 0.0f;
    if constexpr (!kResident) {
      const bool policy_in = s > 0 && in;
      sv[k] = policy_in ? __ldg(rows + p * n + i) : 0.0f;
      cv[k] = policy_in ? out[i] : 0.0f;
      if constexpr (kTwo) ev[k] = policy_in ? __ldg(extra + p * n + i) : 0.0f;
    }
  }
  if (s > 0 && wait) wait_beta<B::kK>(a, c, static_cast<unsigned>(s), sbeta, tid);
  float b[B::kK];
#pragma unroll
  for (int j = 0; j < B::kK; ++j) b[j] = s > 0 ? sbeta[j] : 0.0f;

  float acc[B::kM];
#pragma unroll
  for (int m = 0; m < B::kM; ++m) acc[m] = 0.0f;
  float* car_s = slot;
  float* row_s = slot + kTilePaths;
  float* ext_s = slot + 2 * kTilePaths;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    if (i >= n) break;
    const int on = k * kThreads + tid;  // the path's place in a slot
    float cf;
    if (s == 0) {
      cf = immediate(__ldg(rows + static_cast<long long>(a.monitors - 1) * n + i), strike, a.put);
    } else {
      float sp, ep = 0.0f, cp;
      if constexpr (kResident) {
        sp = row_s[on];
        cp = car_s[on];
        if constexpr (kTwo) ep = ext_s[on];
      } else {
        sp = sv[k];
        cp = cv[k];
        if constexpr (kTwo) ep = ev[k];
      }
      cf = policy<B, kDegree>(sp, ep, cp, b, strike, disc, a.put);
    }
    if (!moments) {
      out[i] = __fsub_rn(strike, __fdiv_rn(__fmul_rn(disc, cf), df));
      continue;
    }
    accumulate<B>(acc, s1[k], e1[k], cf, strike, disc, a.put);
    if (kResident) {
      car_s[on] = cf;
      row_s[on] = s1[k];
      if (kTwo) ext_s[on] = e1[k];
    } else {
      out[i] = cf;
    }
  }
  if (!moments) return;  // uniform over the CTA
  float* part = a.partials + (static_cast<long long>(c) * a.tiles + tile) * B::kM;
  const unsigned last = static_cast<unsigned>(s + 1) * static_cast<unsigned>(a.tiles) - 1u;
  if constexpr (kTwo) {
    float lo, hi;
    warp_fold<B::kM>(acc, scratch, tid, lo, hi);
    if (tid < 32) {
      if (tid < B::kM) part[tid] = lo;
      if (tid + 32 < B::kM) part[tid + 32] = hi;
      __threadfence();
      __syncwarp();
      if (tid == 0) {
        const bool is_last = ticket(a.tickets + c) == last;
        *sflag = is_last ? 1 : 0;
      }
    }
  } else {
    tree_fold<B::kM>(acc, scratch, tid);
    if (tid == 0) {
#pragma unroll
      for (int m = 0; m < B::kM; ++m) part[m] = acc[m];
      const bool is_last = ticket(a.tickets + c) == last;
      *sflag = is_last ? 1 : 0;
    }
  }
  __syncthreads();
  if (*sflag) solve_contract<B>(a, c, static_cast<unsigned>(s + 1), scratch, tid);
}

// CTAs an SM the registers must allow, so one CTA's moments run while
// another waits for β: three for the resident single-state kernel (two
// 32 KB slots each), two otherwise, one for the widest two-state bases.
template <int kDegree, bool kTwo, bool kResident>
constexpr int kMinBlocks = kTwo ? (kDegree > 5 ? 1 : 2) : (kResident ? 3 : 2);

// Resident: a wave's contracts split the grid into contiguous groups of CTAs,
// one contract a group (block b of G serves contract ⌊b·W/G⌋), and a CTA
// keeps the group's tiles me, me + members, … in its slots. A CTA then waits
// for one β a date, and the CTAs an SM holds (consecutive groups) belong to
// different contracts, so one's moments run while another's β is solved.
// Streamed: every contract at once, items (contract, tile) dealt round-robin.
template <int kDegree, bool kTwo, bool kResident>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<kDegree, kTwo, kResident>))
backward_kernel(const Args a) {
  using B = Basis<kDegree, kTwo>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* scratch = smem;
  float* sbeta = smem + fold_floats<B>();  // [2][16]
  int* sflag = reinterpret_cast<int*>(sbeta + 32);
  float* slots = smem + scratch_floats<B>();
  const int tid = threadIdx.x;
  const int grid = static_cast<int>(gridDim.x);
  const int block = static_cast<int>(blockIdx.x);
  if constexpr (kResident) {
    for (int c0 = 0; c0 < a.contracts; c0 += a.wave) {
      const int wc = min(a.wave, a.contracts - c0);
      const int j = static_cast<int>(static_cast<long long>(block) * wc / grid);
      const int first = static_cast<int>((static_cast<long long>(j) * grid + wc - 1) / wc);
      const int next = static_cast<int>((static_cast<long long>(j + 1) * grid + wc - 1) / wc);
      for (int s = 0; s < a.monitors; ++s) {
        int k = 0;
        for (int t = block - first; t < a.tiles; t += next - first, ++k) {
          item<kDegree, kTwo, true>(a, s, c0 + j, t, k == 0,
                                    slots + static_cast<long long>(k) * B::kState * kTilePaths,
                                    scratch, sbeta + 16 * (s & 1), sflag, tid);
        }
      }
    }
  } else {
    int parity = 0;  // the β buffer of the next item
    const int items = a.contracts * a.tiles;
    for (int s = 0; s < a.monitors; ++s) {
      for (int i = block; i < items; i += grid) {
        item<kDegree, kTwo, false>(a, s, i / a.tiles, i % a.tiles, true, nullptr, scratch,
                                   sbeta + 16 * parity, sflag, tid);
        parity ^= 1;
      }
    }
  }
}

// The co-resident grid and the resident kernel's slots a CTA: the slot count
// (1 … kMaxSlots) that holds the most tiles on the card, ties to more CTAs;
// computed once per device and kernel.
template <int kDegree, bool kTwo, bool kResident>
cudaError_t plan_one(int* grid, int* slots) {
  using B = Basis<kDegree, kTwo>;
  static int cached_device = -1, cached_grid = 0, cached_slots = 0;
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device == cached_device) {
    *grid = cached_grid;
    *slots = cached_slots;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(&backward_kernel<kDegree, kTwo, kResident>);
  int best_items = 0, best_grid = 0, best_slots = 0;
  for (int sl = kResident ? 1 : 0; sl <= (kResident ? kMaxSlots : 0); ++sl) {
    const long long bytes = smem_bytes<B>(sl);
    if (bytes > optin) break;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    int occ = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads,
                                                          static_cast<size_t>(bytes));
    if (err != cudaSuccess) return err;
    const int items = occ * sms * (kResident ? sl : 1);
    if (items > best_items) {
      best_items = items;
      best_grid = occ * sms;
      best_slots = sl;
    }
  }
  if (best_grid == 0) return cudaErrorInvalidConfiguration;
  *grid = cached_grid = best_grid;
  *slots = cached_slots = best_slots;
  cached_device = device;
  return cudaSuccess;
}

template <int kDegree, bool kTwo, bool kResident>
cudaError_t launch_one(Args a, cudaStream_t st) {
  using B = Basis<kDegree, kTwo>;
  int grid = 0, slots = 0;
  cudaError_t err = plan_one<kDegree, kTwo, kResident>(&grid, &slots);
  if (err != cudaSuccess) return err;
  if (kResident && (a.wave < 1 || a.wave > grid ||
                    static_cast<long long>(grid / a.wave) * slots < a.tiles)) {
    return cudaErrorInvalidValue;  // a contract's group of CTAs must hold its tiles
  }
  const long long bytes = smem_bytes<B>(slots);
  const void* fn = reinterpret_cast<const void*>(&backward_kernel<kDegree, kTwo, kResident>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params,
                                    static_cast<size_t>(bytes), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kTwo, int kDegree>
cudaError_t dispatch_route(bool resident, Args a, cudaStream_t st, int* grid, int* slots,
                           bool plan) {
  if (plan) {
    return resident ? plan_one<kDegree, kTwo, true>(grid, slots)
                    : plan_one<kDegree, kTwo, false>(grid, slots);
  }
  return resident ? launch_one<kDegree, kTwo, true>(a, st)
                  : launch_one<kDegree, kTwo, false>(a, st);
}

template <bool kTwo>
cudaError_t dispatch(int degree, bool resident, Args a, cudaStream_t st, int* grid, int* slots,
                     bool plan) {
  switch (degree) {
    case 1: return dispatch_route<kTwo, 1>(resident, a, st, grid, slots, plan);
    case 2: return dispatch_route<kTwo, 2>(resident, a, st, grid, slots, plan);
    case 3: return dispatch_route<kTwo, 3>(resident, a, st, grid, slots, plan);
    case 4: return dispatch_route<kTwo, 4>(resident, a, st, grid, slots, plan);
    case 5: return dispatch_route<kTwo, 5>(resident, a, st, grid, slots, plan);
    case 6: return dispatch_route<kTwo, 6>(resident, a, st, grid, slots, plan);
    case 7: return dispatch_route<kTwo, 7>(resident, a, st, grid, slots, plan);
    case 8: return dispatch_route<kTwo, 8>(resident, a, st, grid, slots, plan);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lsmc

// The C entry points of one mode (kTwo): the plan (co-resident CTAs and the
// resident kernel's slots a CTA) and the launch.
#define LSMC_ENTRY_POINTS(kTwo)                                                               \
  extern "C" int lsmc_plan(int degree, int resident, int* grid, int* slots) {                 \
    return static_cast<int>(lsmc::dispatch<kTwo>(degree, resident != 0, lsmc::Args{}, nullptr, \
                                                 grid, slots, true));                         \
  }                                                                                           \
  extern "C" int lsmc_launch(const void* rows, const void* extra, void* out, const void* scal, \
                             void* partials, void* beta, void* sync, int contracts,           \
                             long long n, int monitors, int degree, int put, int resident,    \
                             int wave, float inv_n, void* stream) {                           \
    if (monitors < 2 || contracts < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue); \
    lsmc::Args a;                                                                             \
    a.rows = static_cast<const float*>(rows);                                                 \
    a.extra = static_cast<const float*>(extra);                                               \
    a.out = static_cast<float*>(out);                                                         \
    a.scal = static_cast<const float*>(scal);                                                 \
    a.partials = static_cast<float*>(partials);                                               \
    a.beta = static_cast<float*>(beta);                                                       \
    a.tickets = static_cast<unsigned*>(sync);                                                 \
    a.epochs = static_cast<unsigned*>(sync) + contracts;                                      \
    a.contracts = contracts;                                                                  \
    a.monitors = monitors;                                                                    \
    a.tiles = static_cast<int>((n + lsmc::kTilePaths - 1) / lsmc::kTilePaths);                \
    a.wave = wave;                                                                            \
    a.n = n;                                                                                  \
    a.inv_n = inv_n;                                                                          \
    a.put = put;                                                                              \
    if (resident && wave < 1) return static_cast<int>(cudaErrorInvalidValue);                 \
    int grid = 0, slots = 0;                                                                  \
    return static_cast<int>(lsmc::dispatch<kTwo>(degree, resident != 0, a,                    \
                                                 static_cast<cudaStream_t>(stream), &grid,    \
                                                 &slots, false));                             \
  }
