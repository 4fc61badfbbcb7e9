// RK4 ensemble screen of quadratic "cAH" ROM posterior draws, for Hopper
// (sm_90a). Built by gp_bayesopinf_torch/ops/build.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes.
//
// Replaces: the Pallas TPU kernel
//   gp_bayesopinf_tpu/ops/ensemble_pallas.py::quadratic_ensemble_screen
//   (pl.pallas_call of _screen_kernel).
//
// What it computes: for L problems (trajectories) sharing N = G * nd
// operator draws of
//   dq/dt = c + A q + H ckron(q),   d = 1 + r + r(r+1)/2 columns,
// classical RK4 with `substeps` steps per output interval over t_eval
// from each problem's initial state, the state clipped to +-1e6 after
// every stage. Outputs, per problem: a per-draw stability flag (max over
// t, t0 included, of |q - shift| <= limits, and finite) and, per
// candidate, the squared Frobenius error of the nd-draw mean against
// `snaps` summed over all output times, t0 included.
//
// What bounds it on this card: the latency of the dependent chain. At the
// Euler ex1a screen shapes (G = 16, nd = 20, r = 6, k = 400, substeps =
// 8) a launch is 12,768 dependent right-hand sides; the float32 work (1.5
// GFLOP) and the bytes are far below the card's rates, and the warps are
// too few to hide latency. A right-hand side's chain is its d = 28-term
// sum (in the reference's order), then an all-gather of the new slope and
// the stage update.
//
// What the design does about it (the layout of screen_common.cuh): a draw
// takes 8 lanes at r = 6, lane i owning row i, and loads its row's d
// coefficients into registers before the time loop (28 floats at r = 6,
// 91 at r = 12, still without spills); nothing of the operators is read
// inside the loop. Lane i computes row i of each right-hand side; r
// shuffles all-gather the slope, and the state, the stage slopes and the
// RK4 sum acc = k1 + 2 k2 + 2 k3 + k4 (in that order) are replicated in
// the group. All L problems
// go in one launch (blockIdx.y), and a candidate's draws spread over W
// one-warp blocks. The draw mean is a fixed-order shuffle tree within a
// warp plus mean_error_kernel across warps: no atomics, the same bits
// every run. Everything is float32, as the screening contract says;
// nvcc's multiply-add contraction makes err_sq differ from the CPU in the
// last bits.
//
// Three kernel families, chosen by r in the wrapper (ops/ensemble_screen.py
// ::screen_family) and passed to the C entry, which can be forced to any
// family that takes r:
//
// * templated, r 1..12: quadratic_screen_kernel<R> above;
// * capacity-templated, r <= 32: quadratic_screen_cap_kernel<RCAP>, RCAP
//   16 (r 13..16) and 32 (r 17..32);
// * runtime-r, any r: quadratic_screen_any_r_kernel, the path above r =
//   32 and the yardstick the capacity kernel is held against bit for bit
//   (family "runtime" forces it at any r).
//
// Above r = 12 a row (d = 105 at r = 13, 153 at r = 16) no longer fits in
// a lane's registers, so both other families give a draw a warp (the
// capacity and runtime layouts of screen_common.cuh): lane i owns row i,
// and the draw sums go to mean_error_kernel with W = nd warps per
// candidate. What bounds them is the same dependent chain (at r 13-24 on
// the H100 the capacity kernel takes 18-44x, the runtime-r kernel 93-218x
// the time of its float32 work at the card's rate; chip_smoke.py phase
// 3b): a right-hand side is
// a d-term multiply-add chain that has to keep the templated kernel's
// order. The runtime-r kernel pays a shared-memory round trip on every
// term of it: its coefficients come through a runtime-strided view, its
// state from shared memory, its loops have run-time trip counts, and four
// __syncwarp() separate the RK4 stages. The capacity kernel takes r at
// run time but unrolls every loop to RCAP, so the state is a statically
// indexed register array replicated in the warp by one all-gather of
// RCAP shuffles a stage (no __syncwarp()); the operator is staged in
// shared memory transposed with the compile-time row stride RCAP, so a
// coefficient load is the lane's base plus a constant and the warp reads
// consecutive words; the linear coefficients are loaded up front and each
// quadratic block (a fixed) while the previous block is summed. Every
// branch on r is a convergence region that the chain waits on (the SASS
// brackets each in BSSY/BSYNC), so the shuffles are not guarded (lanes
// r..RCAP-1 hold zero rows), the linear terms are predicated, and the
// quadratic blocks nest so that one branch skips all blocks from r on. The
// arithmetic of each row, the per-draw partial sums and hence err_sq are
// those of the runtime-r kernel to the bit.

#include "screen_common.cuh"

namespace {

template <int R>
struct Cols {
  static constexpr int kD = 1 + R + R * (R + 1) / 2;
};

// This lane's row of dq = Ohat @ [1, q, ckron(q)].
template <int R>
__device__ __forceinline__ float rhs_row(const float (&c)[Cols<R>::kD], const float (&q)[R]) {
  float acc = c[0];
#pragma unroll
  for (int a = 0; a < R; ++a) acc += c[1 + a] * q[a];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) acc += c[1 + R + a * (a + 1) / 2 + b] * (q[a] * q[b]);
  }
  return acc;
}

template <int R>
__global__ void __launch_bounds__(32)
quadratic_screen_kernel(const float* __restrict__ Ohat,    // (N, R, D)
                        const float* __restrict__ q0,      // (L, R)
                        const float* __restrict__ t_eval,  // (k,)
                        const float* __restrict__ shift,   // (L, R)
                        const float* __restrict__ limits,  // (L, R)
                        int N, int nd, int W, int k, int substeps,
                        bool* __restrict__ stable,         // (L, N)
                        float* __restrict__ partial) {     // (L, G, W, k, R) or null
  constexpr int D = Cols<R>::kD;
  const Slot<R> at(nd, W);
  const int G = N / nd;
  const int row = at.row;

  // This lane's operator row, on chip for the whole time loop.
  float c[D];
  const float* op = Ohat + (static_cast<size_t>(at.n) * R + (row < R ? row : 0)) * D;
#pragma unroll
  for (int j = 0; j < D; ++j) c[j] = row < R ? __ldg(op + j) : 0.f;

  float* part = partial == nullptr
                    ? nullptr
                    : partial + (static_cast<size_t>(at.problem) * G * W + at.warp) * k * R;
  float q[R], sh[R], maxdev[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    q[i] = q0[at.problem * R + i];
    sh[i] = shift[at.problem * R + i];
    maxdev[i] = fabsf(q[i] - sh[i]);
  }
  if (part != nullptr) warp_draw_sum<R>(q, at.active, part);

  // One stage slope at a time; `acc` sums k1 + 2 k2 + 2 k3 + k4 in that
  // order, as the reference does.
  float kk[R], acc[R], tmp[R];
  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hh = 0.5f * h;
    const float h6 = h / 6.0f;
    for (int sub = 0; sub < substeps; ++sub) {
      all_gather<R>(rhs_row<R>(c, q), kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = kk[i];
        tmp[i] = clip_keep_nan(q[i] + hh * kk[i]);
      }
      all_gather<R>(rhs_row<R>(c, tmp), kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = acc[i] + 2.f * kk[i];
        tmp[i] = clip_keep_nan(q[i] + hh * kk[i]);
      }
      all_gather<R>(rhs_row<R>(c, tmp), kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = acc[i] + 2.f * kk[i];
        tmp[i] = clip_keep_nan(q[i] + h * kk[i]);
      }
      all_gather<R>(rhs_row<R>(c, tmp), kk);
#pragma unroll
      for (int i = 0; i < R; ++i) q[i] = clip_keep_nan(q[i] + h6 * (acc[i] + kk[i]));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) maxdev[i] = max_keep_nan(maxdev[i], fabsf(q[i] - sh[i]));
    if (part != nullptr) warp_draw_sum<R>(q, at.active, part + static_cast<size_t>(s) * R);
  }

  if (at.active && row == 0) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < R; ++i)
      ok = ok && (maxdev[i] <= limits[at.problem * R + i]) && isfinite(maxdev[i]);
    stable[static_cast<size_t>(at.problem) * N + at.n] = ok;
  }
}

template <int R>
cudaError_t launch(const float* Ohat, const float* q0, const float* t_eval, const float* shift,
                   const float* limits, int L, int N, int nd, int W, int k, int substeps,
                   bool* stable, float* partial, cudaStream_t stream) {
  const dim3 grid(N / nd * W, L);
  quadratic_screen_kernel<R><<<grid, 32, 0, stream>>>(Ohat, q0, t_eval, shift, limits, N, nd, W,
                                                      k, substeps, stable, partial);
  return cudaGetLastError();
}

// Row i of dq = op @ [1, x, ckron(x)] at run-time r, in the order of
// rhs_row.
__device__ __forceinline__ float rhs_any(const OpView& op, int i, const float* x, int r) {
  float acc = op(i, 0);
  for (int a = 0; a < r; ++a) acc += op(i, 1 + a) * x[a];
  int z = 1 + r;
  for (int a = 0; a < r; ++a) {
    const float xa = x[a];
    for (int b = 0; b <= a; ++b, ++z) acc += op(i, z) * (xa * x[b]);
  }
  return acc;
}

// The runtime-r kernel: block (n, l) integrates draw n of problem l.
__global__ void __launch_bounds__(32)
quadratic_screen_any_r_kernel(const float* __restrict__ Ohat,    // (N, r, d)
                              const float* __restrict__ q0,      // (L, r)
                              const float* __restrict__ t_eval,  // (k,)
                              const float* __restrict__ shift,   // (L, r)
                              const float* __restrict__ limits,  // (L, r)
                              int r, int d, int N, int k, int substeps, bool staged,
                              bool* __restrict__ stable,         // (L, N)
                              float* __restrict__ partial) {     // (L, N, k, r) or null
  extern __shared__ float smem[];
  float* q = smem;          // the state
  float* xa = q + r;        // stage states, two buffers
  float* xb = xa + r;
  float* acc = xb + r;      // k1 + 2 k2 + 2 k3, row by row
  float* maxdev = acc + r;  // max over t of |q - shift|
  float* sh = maxdev + r;
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const OpView op = stage_operator(Ohat, n, r, d, staged, sh + r);
  float* part = partial == nullptr ? nullptr
                                   : partial + (static_cast<size_t>(l) * N + n) * k * r;
  for (int i = lane; i < r; i += 32) {
    q[i] = q0[l * r + i];
    sh[i] = shift[l * r + i];
    maxdev[i] = fabsf(q[i] - sh[i]);
    if (part != nullptr) part[i] = q[i];
  }
  __syncwarp();

  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hh = 0.5f * h;
    const float h6 = h / 6.0f;
    for (int sub = 0; sub < substeps; ++sub) {
      for (int i = lane; i < r; i += 32) {
        const float kk = rhs_any(op, i, q, r);
        acc[i] = kk;
        xa[i] = clip_keep_nan(q[i] + hh * kk);
      }
      __syncwarp();
      for (int i = lane; i < r; i += 32) {
        const float kk = rhs_any(op, i, xa, r);
        acc[i] = acc[i] + 2.f * kk;
        xb[i] = clip_keep_nan(q[i] + hh * kk);
      }
      __syncwarp();
      for (int i = lane; i < r; i += 32) {
        const float kk = rhs_any(op, i, xb, r);
        acc[i] = acc[i] + 2.f * kk;
        xa[i] = clip_keep_nan(q[i] + h * kk);
      }
      __syncwarp();
      for (int i = lane; i < r; i += 32) {
        const float kk = rhs_any(op, i, xa, r);
        q[i] = clip_keep_nan(q[i] + h6 * (acc[i] + kk));
      }
      __syncwarp();
    }
    for (int i = lane; i < r; i += 32) {
      maxdev[i] = max_keep_nan(maxdev[i], fabsf(q[i] - sh[i]));
      if (part != nullptr) part[static_cast<size_t>(s) * r + i] = q[i];
    }
  }

  bool ok = true;
  for (int i = lane; i < r; i += 32)
    ok = ok && (maxdev[i] <= limits[l * r + i]) && isfinite(maxdev[i]);
  ok = __all_sync(kFullMask, ok);
  if (lane == 0) stable[static_cast<size_t>(l) * N + n] = ok;
}

cudaError_t launch_any_r(const float* Ohat, const float* q0, const float* t_eval,
                         const float* shift, const float* limits, int L, int N, int r, int k,
                         int substeps, bool* stable, float* partial, cudaStream_t stream) {
  const int d = 1 + r + r * (r + 1) / 2;
  bool staged;
  const size_t bytes = any_r_shared_bytes(r, d, 6, 0, &staged);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        quadratic_screen_any_r_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return rc;
  }
  quadratic_screen_any_r_kernel<<<dim3(N, L), 32, bytes, stream>>>(
      Ohat, q0, t_eval, shift, limits, r, d, N, k, substeps, staged, stable, partial);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The capacity-templated kernel (the capacity layout of screen_common.cuh):
// r <= RCAP at run time, RCAP 16 and 32.

template <int RCAP>
struct CapCols {
  static constexpr int kH = 1 + RCAP;                    // first quadratic column
  static constexpr int kD = kH + RCAP * (RCAP + 1) / 2;  // columns
};

// The quadratic terms of blocks A, A + 1, ... (block a: the terms a, b for
// b <= a) of this lane's row, added to acc in order while a < r; `cur`
// holds block A's coefficients. Block A + 1's coefficients are loaded
// before block A is summed, so the chain of multiply-adds does not wait on
// shared memory; the blocks nest, so one branch skips all blocks from r
// on.
template <int RCAP, int A>
__device__ __forceinline__ void quad_blocks(const float* __restrict__ t, const float (&x)[RCAP],
                                            int r, const float (&cur)[A + 1], float& acc) {
  constexpr int H = CapCols<RCAP>::kH;
  const float xa = x[A];
  if constexpr (A + 1 < RCAP) {
    float nxt[A + 2];
#pragma unroll
    for (int b = 0; b <= A + 1; ++b) nxt[b] = t[(H + (A + 1) * (A + 2) / 2 + b) * RCAP];
#pragma unroll
    for (int b = 0; b <= A; ++b) acc += cur[b] * (xa * x[b]);
    if (A + 1 < r) quad_blocks<RCAP, A + 1>(t, x, r, nxt, acc);
  } else {
#pragma unroll
    for (int b = 0; b <= A; ++b) acc += cur[b] * (xa * x[b]);
  }
}

// This lane's row of dq = op @ [1, x, ckron(x)] at run-time r <= RCAP, in
// the order of rhs_any; column c of the row at t[c RCAP]. The linear terms
// are predicated on a < r, the quadratic blocks nested (quad_blocks).
template <int RCAP>
__device__ __forceinline__ float rhs_cap(const float* __restrict__ t, const float (&x)[RCAP],
                                         int r) {
  float lin[RCAP], cur[1];
#pragma unroll
  for (int a = 0; a < RCAP; ++a) lin[a] = t[(1 + a) * RCAP];
  cur[0] = t[CapCols<RCAP>::kH * RCAP];
  float acc = t[0];
#pragma unroll
  for (int a = 0; a < RCAP; ++a)
    if (a < r) acc += lin[a] * x[a];
  quad_blocks<RCAP, 0>(t, x, r, cur, acc);
  return acc;
}

// Block (n, l) integrates draw n of problem l; lane i < r owns row i.
template <int RCAP>
__global__ void __launch_bounds__(32)
quadratic_screen_cap_kernel(const float* __restrict__ Ohat,    // (N, r, d)
                            const float* __restrict__ q0,      // (L, r)
                            const float* __restrict__ t_eval,  // (k,)
                            const float* __restrict__ shift,   // (L, r)
                            const float* __restrict__ limits,  // (L, r)
                            int r, int d, int N, int k, int substeps,
                            bool* __restrict__ stable,         // (L, N)
                            float* __restrict__ partial) {     // (L, N, k, r) or null
  extern __shared__ float T[];  // (CapCols<RCAP>::kD, RCAP)
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const bool mine = lane < r;
  stage_capacity<RCAP>(Ohat, n, r, d, CapCols<RCAP>::kD,
                       [r](int z) { return z <= r ? z : z - (1 + r) + CapCols<RCAP>::kH; }, T);
  __syncwarp();
  const float* t = T + lane % RCAP;
  float* part = partial == nullptr ? nullptr
                                   : partial + (static_cast<size_t>(l) * N + n) * k * r;
  float q = 0.f, sh = 0.f, maxdev = 0.f;
  if (mine) {
    q = q0[l * r + lane];
    sh = shift[l * r + lane];
    maxdev = fabsf(q - sh);
    if (part != nullptr) part[lane] = q;
  }

  // x: the state the next right-hand side reads, replicated (x[j] for j >=
  // r is 0: lanes r..RCAP-1 hold zero rows); acc: this row's k1 + 2 k2 +
  // 2 k3. One stage a trip, so the right-hand side's code appears once.
  float x[RCAP];
  gather_lanes<RCAP>(q, x);
  float acc = 0.f;
  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hh = 0.5f * h;
    const float h6 = h / 6.0f;
    for (int sub = 0; sub < substeps; ++sub) {
#pragma unroll 1
      for (int stage = 0; stage < 4; ++stage) {
        const float kk = rhs_cap<RCAP>(t, x, r);
        float next;
        if (stage == 0) {
          acc = kk;
          next = clip_keep_nan(q + hh * kk);
        } else if (stage == 1) {
          acc = acc + 2.f * kk;
          next = clip_keep_nan(q + hh * kk);
        } else if (stage == 2) {
          acc = acc + 2.f * kk;
          next = clip_keep_nan(q + h * kk);
        } else {
          q = clip_keep_nan(q + h6 * (acc + kk));
          next = q;
        }
        gather_lanes<RCAP>(next, x);
      }
    }
    if (mine) {
      maxdev = max_keep_nan(maxdev, fabsf(q - sh));
      if (part != nullptr) part[static_cast<size_t>(s) * r + lane] = q;
    }
  }

  const bool ok = !mine || ((maxdev <= limits[l * r + lane]) && isfinite(maxdev));
  const bool all = __all_sync(kFullMask, ok);
  if (lane == 0) stable[static_cast<size_t>(l) * N + n] = all;
}

template <int RCAP>
cudaError_t launch_cap(const float* Ohat, const float* q0, const float* t_eval,
                       const float* shift, const float* limits, int L, int N, int r, int k,
                       int substeps, bool* stable, float* partial, cudaStream_t stream) {
  const int d = 1 + r + r * (r + 1) / 2;
  const size_t bytes = static_cast<size_t>(CapCols<RCAP>::kD) * RCAP * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        quadratic_screen_cap_kernel<RCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return rc;
  }
  quadratic_screen_cap_kernel<RCAP><<<dim3(N, L), 32, bytes, stream>>>(
      Ohat, q0, t_eval, shift, limits, r, d, N, k, substeps, stable, partial);
  return cudaGetLastError();
}

// The three families, as the wrapper names them (ops/ensemble_screen.py).
constexpr int kTemplated = 0;  // r <= kTemplatedMaxR: quadratic_screen_kernel<R>
constexpr int kCapacity = 1;   // r <= kCapacityMaxR: quadratic_screen_cap_kernel<16 or 32>
constexpr int kRuntime = 2;    // any r: quadratic_screen_any_r_kernel
constexpr int kTemplatedMaxR = 12;
constexpr int kCapacityMaxR = 32;

int screen(int family, const float* Ohat, const float* q0, const float* t_eval,
           const float* shift, const float* limits, const float* snaps, int L, int N, int r,
           int nd, int W, int k, int substeps, bool* stable, float* partial, float* err_sq,
           cudaStream_t s) {
  if (r < 1) return -1;
  if ((family != kTemplated && family != kCapacity && family != kRuntime) ||
      (family == kTemplated && r > kTemplatedMaxR) || (family == kCapacity && r > kCapacityMaxR))
    return -2;
  if (L < 1 || L > 65535 || N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 ||
      substeps < 1 || W != (family == kTemplated ? warps_per_candidate(r, nd) : nd) ||
      (snaps != nullptr && (partial == nullptr || err_sq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = snaps != nullptr ? partial : nullptr;
  cudaError_t rc = cudaSuccess;
  if (family == kRuntime) {
    rc = launch_any_r(Ohat, q0, t_eval, shift, limits, L, N, r, k, substeps, stable, part, s);
  } else if (family == kCapacity) {
    rc = r <= 16 ? launch_cap<16>(Ohat, q0, t_eval, shift, limits, L, N, r, k, substeps, stable,
                                  part, s)
                 : launch_cap<32>(Ohat, q0, t_eval, shift, limits, L, N, r, k, substeps, stable,
                                  part, s);
  } else {
    switch (r) {
#define GPBOI_SCREEN_CASE(R)                                                                \
  case R:                                                                                   \
    rc = launch<R>(Ohat, q0, t_eval, shift, limits, L, N, nd, W, k, substeps, stable, part, \
                   s);                                                                      \
    break;
      GPBOI_SCREEN_CASE(1)
      GPBOI_SCREEN_CASE(2)
      GPBOI_SCREEN_CASE(3)
      GPBOI_SCREEN_CASE(4)
      GPBOI_SCREEN_CASE(5)
      GPBOI_SCREEN_CASE(6)
      GPBOI_SCREEN_CASE(7)
      GPBOI_SCREEN_CASE(8)
      GPBOI_SCREEN_CASE(9)
      GPBOI_SCREEN_CASE(10)
      GPBOI_SCREEN_CASE(11)
      GPBOI_SCREEN_CASE(12)
#undef GPBOI_SCREEN_CASE
    }
  }
  if (rc != cudaSuccess || snaps == nullptr) return static_cast<int>(rc);
  mean_error_kernel<<<dim3(N / nd, L), 32, 0, s>>>(partial, snaps, r, N / nd, W, k, nd, err_sq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Screens L problems in one launch with the kernel of `family` (0: the
// templated instances, r <= 12; 1: the capacity-templated kernel, r <= 32,
// its capacity 16 or 32 chosen by r; 2: the runtime-r kernel, any r). The
// wrapper chooses the family by r and can force one. `partial`, `snaps`
// and `err_sq` as in cahbn_screen.cu's gpboi_cahbn_screen, W =
// warps_per_candidate(r, nd) for the templated instances and W = nd for
// the others. Returns 0 on success, a cudaError_t code if a launch
// failed, -1 for r < 1 and -2 for a family that does not take r.
extern "C" int gpboi_quadratic_screen(const float* Ohat, const float* q0, const float* t_eval,
                                      const float* shift, const float* limits,
                                      const float* snaps, int L, int N, int r, int nd, int W,
                                      int k, int substeps, int family, bool* stable,
                                      float* partial, float* err_sq, void* stream) {
  return screen(family, Ohat, q0, t_eval, shift, limits, snaps, L, N, r, nd, W, k, substeps,
                stable, partial, err_sq, static_cast<cudaStream_t>(stream));
}
