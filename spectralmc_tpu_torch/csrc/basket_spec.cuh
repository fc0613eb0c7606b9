// The basket spec shared by the "cuda" engine's basket kernels
// (basket_paths.cu, american_dynamics.cu): the static spec a launch takes by
// value, and the basket value of a path's per-asset log-prices.
//
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxAssets = 8;

// The static spec, passed by value (ops/basket_cuda.py::spec_table's layout).
struct BasketArgs {
  float weights[kMaxAssets];
  float spot_mult[kMaxAssets];
  float vol_mult[kMaxAssets];
  float chol[kMaxAssets * kMaxAssets];  // lower rows, zero above the diagonal
};

// Σ wᵢ·log xᵢ, the log of the geometric basket value.
template <int kA>
__device__ __forceinline__ float log_geometric(const float (&logx)[kA], const BasketArgs& spec) {
  float acc = spec.weights[0] * logx[0];
#pragma unroll
  for (int a = 1; a < kA; ++a) acc = acc + spec.weights[a] * logx[a];
  return acc;
}

template <int kA, bool kGeo>
__device__ __forceinline__ float basket_value(const float (&logx)[kA], const BasketArgs& spec) {
  if constexpr (kGeo) return expf(log_geometric<kA>(logx, spec));
  float acc = spec.weights[0] * expf(logx[0]);
#pragma unroll
  for (int a = 1; a < kA; ++a) acc = acc + spec.weights[a] * expf(logx[a]);
  return acc;
}

}  // namespace
