// Device helpers shared by the ensemble-screen kernels
// (quadratic_screen.cu, cahbn_screen.cu). Each kernel source includes
// this header once; everything here has internal linkage.
//
// Three layouts. The templated instances of both kernels (r a template
// parameter, the operator row in registers) are row-parallel: a draw of an
// r-state ROM takes a group of kLanes = (the power of two >= r) lanes of a
// warp, lane i of the group owning row i of the draw's operator. A warp
// holds 32 / kLanes draws; a candidate's nd draws take W = ceil(nd / (32 /
// kLanes)) warps, one block of one warp each, so the warps of a launch
// spread over the SMs. Block (g W + w, l) is warp w of candidate g of
// problem (trajectory) l. Lanes at or above r in a group, and groups past
// the candidate's nd draws, take part in every shuffle and write nothing.
// The runtime-dimension and the capacity-templated kernels take one warp
// per draw (below).

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

// ---------------------------------------------------------------------------
// The capacity layout (the capacity-templated kernels of both sources,
// between the templated instances and the runtime-dimension kernels): one
// draw per warp, as in the runtime layout, with the true r (and nu) launch
// arguments at most a compile-time capacity RCAP (and NUCAP). Lane i < r
// owns row i. Every loop is unrolled to the capacity and guarded by the
// true dimension, so the state, the stage vectors and (in B) the Newton
// row are statically indexed registers; the state is replicated in the
// warp by all-gathers of shuffles. The operator is staged in shared
// memory transposed with the compile-time row stride RCAP (column c of
// row i at T[c RCAP + i]), each column at its capacity position and zeros
// between: a coefficient load is the lane's base address plus a constant,
// and the warp's loads of one column hit consecutive words.

// out[j] = the v of lane j, for every j < RCAP. The entries j >= r hold
// what lanes r..RCAP-1 computed, which no reader uses: the shuffles are
// not guarded by r, since a guarded shuffle is a convergence region of its
// own (BSSY/BSYNC in the SASS) that the chain waits on.
template <int RCAP>
__device__ __forceinline__ void gather_lanes(float v, float (&out)[RCAP]) {
#pragma unroll
  for (int j = 0; j < RCAP; ++j) out[j] = __shfl_sync(kFullMask, v, j);
}

// Draw n's (r, d) operator into T (cols capacity columns of RCAP floats):
// column z of the draw at capacity column cap(z), zeros elsewhere. The
// copy reads the draw's r d floats in order (coalesced); the caller
// synchronizes the warp before the first read.
template <int RCAP, class ColumnMap>
__device__ __forceinline__ void stage_capacity(const float* __restrict__ Ohat, size_t n, int r,
                                               int d, int cols, ColumnMap cap, float* T) {
  for (int e = threadIdx.x; e < cols * RCAP; e += 32) T[e] = 0.f;
  __syncwarp();
  const float* src = Ohat + n * r * d;
#pragma unroll 4
  for (int e = threadIdx.x; e < r * d; e += 32) {
    const int i = e / d;
    T[cap(e - i * d) * RCAP + i] = __ldg(src + e);
  }
}

// ---------------------------------------------------------------------------
// The wide layout (the wide kernels of both sources, above the capacity
// kernels, any dimension): one draw per block of several warps. The
// draw's feature vector f = [1, x, ckron(x)] (and, in B, [u, u ⊗ x]) is
// formed once a stage in shared memory, each thread forming every nt-th
// feature; each operator row is then one dot product with f, split over
// the lanes of a warp by columns (lane j takes columns j, j + 32, ...,
// "chunks" of 32) and summed by warp_sum's fixed shuffle tree, so a
// row's chain is about d / 32 multiply-adds deep instead of d. No atomics:
// the same bits every run.

// The sums of v[0..K) over the warp, each by a butterfly of xor shuffles,
// level by level over the K values so that their shuffles overlap; every
// lane gets the same bits (each level adds the same two values in either
// order).
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int m = 0; m < K; ++m) v[m] += __shfl_xor_sync(kFullMask, v[m], off);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  float one[1] = {v};
  warp_sums<1>(one);
  return one[0];
}

// Where feature c sits in a wide block's feature buffer: lane j's columns
// j + 32 t of four consecutive chunks t = 4 q .. 4 q + 3 are adjacent, so
// a lane reads them as one float4 (((const float4*)fs)[32 q + j]).
__device__ __forceinline__ int feature_slot(int c) {
  return ((c >> 7) << 7) + ((c & 31) << 2) + ((c >> 5) & 3);
}

// A wide block's shared memory, in order: the features (32 fq floats at
// feature_slot(c), fq a multiple of 4 at least the chunks of a row; zeros
// from d on), each feature's pair of factors (column c = xe[a] xe[b],
// packed a | b << 16), the extended state xe = [x (r), 1, u (nu)],
// `vectors` r-vectors, then the caller's tail. Every feature is a product
// of two entries of xe: 1 = 1 1, x_a = x_a 1, x_a x_b (b <= a, the
// reference's order of columns), u_e = u_e 1, u_e x_a; so forming them
// takes no branch.
struct WideSmem {
  float* fs;
  int* pairs;
  float* xe;
  float* vecs;
  float* tail;
  int r;

  __host__ __device__ static int chunks(int d) { return ((d + 127) / 128) * 4; }

  __device__ __forceinline__ WideSmem(float* smem, int r_, int d, int fq, int nu, int vectors)
      : fs(smem),
        pairs(reinterpret_cast<int*>(smem + 32 * fq)),
        xe(smem + 32 * fq + d),
        vecs(xe + r_ + 1 + nu),
        tail(vecs + vectors * r_),
        r(r_) {}

  __host__ static size_t bytes(int r, int d, int fq, int nu, int vectors) {
    return (static_cast<size_t>(32) * fq + d + r + 1 + nu + static_cast<size_t>(vectors) * r) *
           sizeof(float);
  }

  __device__ __forceinline__ float* vec(int j) const { return vecs + j * r; }
  __device__ __forceinline__ float f(int c) const { return fs[feature_slot(c)]; }

  // Zero the features, set xe[r] = 1 and fill the pair table for d columns
  // (nu inputs); the caller synchronizes the block before the first read.
  __device__ __forceinline__ void init(int tid, int nt, int d, int fq, int nu) const {
    for (int c = tid; c < 32 * fq; c += nt) fs[c] = 0.f;
    if (tid == 0) xe[r] = 1.f;
    const int kH = 1 + r, kB = kH + r * (r + 1) / 2, kN = kB + nu;
    for (int c = tid; c < d; c += nt) {
      int a = r, b = r;  // c = 0: 1 x 1
      if (c >= 1 && c < kH) {
        a = c - 1;
      } else if (c >= kH && c < kB) {
        const int z = c - kH;
        a = static_cast<int>((sqrtf(8.f * z + 1.f) - 1.f) * 0.5f);
        while (a * (a + 1) / 2 > z) --a;
        while ((a + 1) * (a + 2) / 2 <= z) ++a;
        b = z - a * (a + 1) / 2;
      } else if (c >= kB && c < kN) {
        a = r + 1 + (c - kB);
      } else if (c >= kN) {
        const int e = (c - kN) / r;
        a = r + 1 + e;
        b = c - kN - e * r;
      }
      pairs[c] = a | (b << 16);
    }
  }
};

// A thread's features, columns c = tid + nt u: the pair codes of the first
// KF in registers (read from the table once, after init), the rest from
// the table. form() writes f[0 .. d) from xe: two independent loads and a
// product each.
template <int KF>
struct FeatureCache {
  int code[KF];

  __device__ __forceinline__ void load(const WideSmem& S, int tid, int nt, int d) {
#pragma unroll
    for (int u = 0; u < KF; ++u) {
      const int c = tid + nt * u;
      code[u] = c < d ? S.pairs[c] : -1;
    }
  }

  __device__ __forceinline__ void form(const WideSmem& S, int tid, int nt, int d) const {
#pragma unroll
    for (int u = 0; u < KF; ++u) {
      const int p = code[u];
      if (p >= 0) S.fs[feature_slot(tid + nt * u)] = S.xe[p & 0xffff] * S.xe[p >> 16];
    }
    for (int c = tid + nt * KF; c < d; c += nt) {
      const int p = S.pairs[c];
      S.fs[feature_slot(c)] = S.xe[p & 0xffff] * S.xe[p >> 16];
    }
  }
};

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
