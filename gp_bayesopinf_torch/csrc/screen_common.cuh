// Device helpers shared by the ensemble-screen kernels
// (quadratic_screen.cu, cahbn_screen.cu). Each kernel source includes
// this header once; everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kDivergeCap = 1e6f;  // DIVERGE_CAP of the TPU kernels
constexpr unsigned kFullMask = 0xffffffffu;

// Clip to +-kDivergeCap that keeps NaN, as jnp.clip does (fminf/fmaxf
// would return the other operand and turn a NaN draw into a finite one).
__device__ __forceinline__ float clip_keep_nan(float x) {
  return x < -kDivergeCap ? -kDivergeCap : (x > kDivergeCap ? kDivergeCap : x);
}

// Maximum that is NaN when either operand is, as jnp.maximum is.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// Squared error of the candidate's draw mean against snaps[:, s]; the
// value is complete in lane 0 only. Every lane of the warp must call it.
template <int R>
__device__ __forceinline__ float mean_sq_error(const float (&q)[R], bool active, int nd,
                                               const float* __restrict__ snaps, int k,
                                               int s) {
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float v = active ? q[i] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
    const float diff = v / static_cast<float>(nd) - __ldg(snaps + static_cast<size_t>(i) * k + s);
    e += diff * diff;
  }
  return e;
}

}  // namespace
