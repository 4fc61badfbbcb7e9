// Device helpers shared by the ensemble-screen kernels
// (quadratic_screen.cu, cahbn_screen.cu). Each kernel source includes
// this header once; everything here has internal linkage.
//
// Two layouts. The templated instances of both kernels (r a template
// parameter, the operator row in registers) are row-parallel: a draw of an
// r-state ROM takes a group of kLanes = (the power of two >= r) lanes of a
// warp, lane i of the group owning row i of the draw's operator. A warp
// holds 32 / kLanes draws; a candidate's nd draws take W = ceil(nd / (32 /
// kLanes)) warps, one block of one warp each, so the warps of a launch
// spread over the SMs. Block (g W + w, l) is warp w of candidate g of
// problem (trajectory) l. Lanes at or above r in a group, and groups past
// the candidate's nd draws, take part in every shuffle and write nothing.
// The runtime-dimension kernels take one warp per draw (below).

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

__host__ __device__ constexpr int lanes_per_draw(int r) {
  return r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : r <= 8 ? 8 : 16;
}

// Lanes of one draw and draws of one warp for an r-state ROM.
template <int R>
struct Rows {
  static_assert(R >= 1 && R <= 16, "a draw's rows must fit in half a warp");
  static constexpr int kLanes = lanes_per_draw(R);
  static constexpr int kDrawsPerWarp = 32 / kLanes;
};

// Warps per candidate of nd draws in the templated instances' layout;
// the wrapper sizes its scratch by it.
__host__ __device__ constexpr int warps_per_candidate(int r, int nd) {
  return (nd + 32 / lanes_per_draw(r) - 1) / (32 / lanes_per_draw(r));
}

// ---------------------------------------------------------------------------
// The runtime-dimension layout (the "any r" kernels of quadratic_screen.cu
// and cahbn_screen.cu, for the state and input dimensions above the
// templated instances): one draw per warp, so a candidate's nd draws take
// nd warps, one block of one warp each; block (g nd + w, l) is draw w of
// candidate g of problem l. Lane i owns rows i, i + 32, ...; the draw's
// vectors live in the block's shared memory, and the operator too where it
// fits there (transposed, so that the lanes' reads of one column hit
// consecutive words), else it is read from device memory.

constexpr int kMaxDynamicShared = 232448;  // 227 KB, a block's most on sm_90

// A draw's (r, d) operator: entry (i, j) at p[i si + j sj].
struct OpView {
  const float* p;
  int si, sj;
  __device__ __forceinline__ float operator()(int i, int j) const { return p[i * si + j * sj]; }
};

// Bytes of dynamic shared memory for `vectors` r-vectors plus `extra`
// floats, with the (r, d) operator staged when it fits; sets `staged`.
__host__ inline size_t any_r_shared_bytes(int r, int d, int vectors, int extra, bool* staged) {
  const size_t base = (static_cast<size_t>(vectors) * r + extra) * sizeof(float);
  const size_t with_op = base + static_cast<size_t>(r) * d * sizeof(float);
  *staged = with_op <= static_cast<size_t>(kMaxDynamicShared);
  return *staged ? with_op : base;
}

// Draw n's operator, copied into shared memory at `dst` transposed (entry
// (i, j) at dst[j r + i]) when `staged`, else viewed in device memory.
// The copy reads the draw's r d floats in order (coalesced); the caller
// synchronizes the warp before the first read.
__device__ __forceinline__ OpView stage_operator(const float* __restrict__ Ohat, size_t n,
                                                 int r, int d, bool staged, float* dst) {
  const float* src = Ohat + n * r * d;
  if (!staged) return OpView{src, d, 1};
  for (int e = threadIdx.x; e < r * d; e += 32) {
    const int i = e / d;
    dst[(e - i * d) * r + i] = __ldg(src + e);
  }
  return OpView{dst, 1, r};
}

// Where a thread sits in the screen grid.
template <int R>
struct Slot {
  int problem;  // trajectory l
  int warp;     // warp w of candidate g: the block's index g W + w
  int row;      // operator row this lane owns (>= R: none)
  int n;        // global draw index; a group past nd shadows the candidate's draw 0
  bool active;  // the group holds one of the candidate's nd draws

  __device__ __forceinline__ Slot(int nd, int W) {
    constexpr int kLanes = Rows<R>::kLanes;
    problem = blockIdx.y;
    warp = blockIdx.x;
    const int cand = blockIdx.x / W;
    const int lane = threadIdx.x;
    row = lane % kLanes;
    const int draw = (blockIdx.x - cand * W) * Rows<R>::kDrawsPerWarp + lane / kLanes;
    active = draw < nd;
    n = cand * nd + (active ? draw : 0);
  }
};

// All-gather within the group: out[j] = the v of the lane that owns row j.
template <int R>
__device__ __forceinline__ void all_gather(float v, float (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = __shfl_sync(kFullMask, v, j, Rows<R>::kLanes);
}

// x[row] for a lane's row, selected without indexing x at run time (which
// would move x to local memory); rows >= R get x[0].
template <int R>
__device__ __forceinline__ float own(const float (&x)[R], int row) {
  float v = x[0];
#pragma unroll
  for (int j = 1; j < R; ++j) v = row == j ? x[j] : v;
  return v;
}

// The sum over this warp's active draws of the (replicated) state q,
// written by lane 0 to out[0..R): a shuffle tree over the group leaders
// (lanes 0, kLanes, 2 kLanes, ...) in a fixed order. Every lane must call it.
template <int R>
__device__ __forceinline__ void warp_draw_sum(const float (&q)[R], bool active,
                                              float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float v = active ? q[i] : 0.f;
#pragma unroll
    for (int off = 16; off >= Rows<R>::kLanes; off >>= 1)
      v += __shfl_down_sync(kFullMask, v, off);
    if (threadIdx.x == 0) out[i] = v;
  }
}

// err_sq[l, g] = sum over output times s, t0 included, of sum over i of
// (mean over the candidate's nd draws of q_i(t_s) - snaps[l, i, s])^2,
// from the screen kernel's per-warp draw sums partial[l, g, w, s, i].
// One warp per (candidate, problem): lane j takes the times s = j, j +
// 32, ..., and a shuffle tree adds the lanes, so the order is fixed and
// the result repeats bit for bit. No atomics.
__global__ void __launch_bounds__(32)
mean_error_kernel(const float* __restrict__ partial,  // (L, G, W, k, R)
                  const float* __restrict__ snaps,    // (L, R, k)
                  int R, int G, int W, int k, int nd,
                  float* __restrict__ err_sq) {       // (L, G)
  const int g = blockIdx.x;
  const int l = blockIdx.y;
  const float* p = partial + static_cast<size_t>(l * G + g) * W * k * R;
  const float* sn = snaps + static_cast<size_t>(l) * R * k;
  float e = 0.f;
  for (int s = threadIdx.x; s < k; s += 32) {
    float es = 0.f;
    for (int i = 0; i < R; ++i) {
      float sum = 0.f;
      for (int w = 0; w < W; ++w) sum += p[(static_cast<size_t>(w) * k + s) * R + i];
      const float diff = sum / static_cast<float>(nd) - sn[static_cast<size_t>(i) * k + s];
      es += diff * diff;
    }
    e += es;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(kFullMask, e, off);
  if (threadIdx.x == 0) err_sq[l * G + g] = e;
}

}  // namespace
