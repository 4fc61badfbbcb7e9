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
// Four kernel families, passed to the C entry by code; the wrapper
// (ops/ensemble_screen.py::screen_family) chooses the templated, capacity
// or wide family by r and can force any family that takes r:
//
// * templated (0), r 1..12: quadratic_screen_kernel<R> above;
// * capacity-templated (1), r <= 32: quadratic_screen_cap_kernel<RCAP>,
//   RCAP 16 (r 13..16) and 32 (r 17..32);
// * runtime-r (2), any r: quadratic_screen_any_r_kernel, the yardstick
//   the capacity kernel is held against bit for bit and the wide kernel
//   is timed against; only forcing (family "runtime") takes it;
// * wide (3), any r: quadratic_screen_wide_kernel, the path above r = 32.
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
//
// Above r = 32 a warp no longer holds a draw's operator (r d = 34,440
// words at r 40, 137,280 at r 64), and a lane-per-row chain of d = 595 to
// 2145 terms is what held the runtime-r kernel at 287x its bound at r 40 (one
// warp an SM, its 138.7 KB operator in shared memory, lanes 0..7 running a
// second row while the others wait; above r ~47 the operator read from
// device memory d words apart a lane). What bounds the wide kernel is
// still the chain of a stage, now cut short, and on-chip room for the
// operator. Its design (the wide layout of screen_common.cuh): a draw
// takes a block of nw = min(8, ceil(r / 5)) warps; the features [1, x,
// ckron(x)] are formed once a stage in shared memory (each thread forms
// every nt-th column, its first kWideFeatures pair codes in registers),
// laid out so that a lane reads four chunks' features as one float4; warp
// w owns rows w + nw m, and lane j the columns j + 32 t of each, so a
// right-hand side's chain is ceil(d / 32) multiply-adds (27 at r 40) and a
// 5-level shuffle tree, the five register rows' trees interleaved level
// by level. Each lane keeps its columns of its first kWideRegRows rows,
// up to kWideRegChunks chunks, in registers for the whole time loop (all
// of r 40's operator; 140 registers of coefficients a lane); the rows past
// those go to shared memory while it holds them (r 64's last 24 rows, 209
// KB), and what is left, the chunks of the register rows past
// kWideRegChunks, is read from device memory (L2) each stage, coalesced:
// the warp reads 32 consecutive words of a row, never d words apart a
// lane. Lane m keeps row slot m's state, stage sum and maximum deviation
// in registers and runs its RK4 update (k1 + 2 k2 + 2 k3 + k4 in that
// order); two barriers a stage (after the updates, after the features).
// No atomics: the same bits every run; the split of a row changes its
// order of summation from the other families' (the reference's XLA twin
// sums by einsum in the backend's order), so err_sq agrees with them
// within float32 roundoff. The waves: the operator takes most of the
// register file, so one block an SM, and G nd =
// 320 draws run in ceil(320 / 132) = 3 waves (the third of 56 draws); the
// design leaves them, since a second draw on an SM would have to read its
// operator from shared memory or L2 every stage.

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

// ---------------------------------------------------------------------------
// The wide kernel (the wide layout of screen_common.cuh): any r, the path
// above the capacity kernel's 32.

constexpr int kWideWarps = 8;     // the most warps a draw's block takes
constexpr int kWideRegRows = 5;   // row slots a warp keeps in registers
constexpr int kWideRegChunks = 28;  // 32-column chunks of such a row in registers (4 k)
constexpr int kWideFeatures = 4;    // features a thread forms from pair codes in registers

// The rows past the register slots (i >= kWideRegRows nw): warp w takes
// rows i0 + w, i0 + w + nw, ..., each read whole from `rows` (shared
// memory, row stride ps, for the rows below i_staged_end) or from the
// draw's operator in device memory, coalesced, and summed by chunks in
// ascending order; lane 0 applies update(i, kk) with the warp's sum kk.
template <class Update>
__device__ __forceinline__ void wide_rows_streamed(const float* __restrict__ op,
                                                   const float* rows, int ps, int i_staged_end,
                                                   const float* fs, int r, int d, int nw, int Q,
                                                   Update update) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int i0 = kWideRegRows * nw;
  for (int i = i0 + w; i < r; i += nw) {
    const bool staged = i < i_staged_end;
    const float* row = staged ? rows + static_cast<size_t>(i - i0) * ps
                              : op + static_cast<size_t>(i) * d;
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < Q; ++t) {
      const int c = 32 * t + lane;
      const float coef = staged ? row[c] : (c < d ? __ldg(row + c) : 0.f);
      acc += coef * fs[feature_slot(c)];
    }
    const float kk = warp_sum(acc);
    if (lane == 0) update(i, kk);
  }
}

// One RK4 stage's update of a row's state from its new slope kk: acc sums
// k1 + 2 k2 + 2 k3 + k4 in that order, as the reference does; returns the
// state the next right-hand side reads.
__device__ __forceinline__ float rk4_update(int stage, float kk, float hh, float h, float h6,
                                            float& q, float& acc) {
  if (stage == 0) {
    acc = kk;
    return clip_keep_nan(q + hh * kk);
  }
  if (stage == 1) {
    acc = acc + 2.f * kk;
    return clip_keep_nan(q + hh * kk);
  }
  if (stage == 2) {
    acc = acc + 2.f * kk;
    return clip_keep_nan(q + h * kk);
  }
  q = clip_keep_nan(q + h6 * (acc + kk));
  return q;
}

// Block (n, l) integrates draw n of problem l with nw warps: warp w owns rows
// i = w + nw m, lane j columns j + 32 t of each (the wide layout). The
// state of row slot m < kWideRegRows lives in lane m's registers.
__global__ void __launch_bounds__(kWideWarps * 32, 1)
quadratic_screen_wide_kernel(const float* __restrict__ Ohat,    // (N, r, d)
                             const float* __restrict__ q0,      // (L, r)
                             const float* __restrict__ t_eval,  // (k,)
                             const float* __restrict__ shift,   // (L, r)
                             const float* __restrict__ limits,  // (L, r)
                             int r, int d, int N, int k, int substeps, int staged_rows,
                             bool* __restrict__ stable,         // (L, N)
                             float* __restrict__ partial) {     // (L, N, k, r) or null
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const int Q = (d + 31) / 32;
  const int fq = WideSmem::chunks(d) > kWideRegChunks ? WideSmem::chunks(d) : kWideRegChunks;
  const WideSmem S(smem, r, d, fq, 0, 3);
  float* const xs = S.xe;        // the state the next right-hand side reads (then 1)
  float* const qs = S.vec(0);    // the state of the rows past the register slots,
  float* const accs = S.vec(1);  // their k1 + 2 k2 + 2 k3
  float* const mds = S.vec(2);   // and their max over t of |q - shift|
  const float* op = Ohat + static_cast<size_t>(n) * r * d;
  const int i0 = kWideRegRows * nw;
  float* const rows = S.tail;  // rows i0 .. i0 + staged_rows - 1, stride 32 Q
  const int ps = 32 * Q;
  S.init(tid, nt, d, fq, 0);
  for (int e = tid; e < staged_rows * ps; e += nt) {
    const int i = i0 + e / ps, c = e % ps;
    rows[e] = c < d ? __ldg(op + static_cast<size_t>(i) * d + c) : 0.f;
  }
  float* part = partial == nullptr ? nullptr
                                   : partial + (static_cast<size_t>(l) * N + n) * k * r;
  for (int i = tid; i < r; i += nt) {
    xs[i] = q0[l * r + i];
    if (part != nullptr) part[i] = xs[i];
    if (i >= i0) {
      qs[i] = xs[i];
      mds[i] = fabsf(xs[i] - shift[l * r + i]);
    }
  }
  // Lane m's row slot m: its row, state, stage sum and max deviation.
  const int my_i = w + nw * lane;
  const bool mine = lane < kWideRegRows && my_i < r;
  float q = 0.f, acc_q = 0.f, md = 0.f, sh = 0.f;
  if (mine) {
    q = q0[l * r + my_i];
    sh = shift[l * r + my_i];
    md = fabsf(q - sh);
  }

  __syncthreads();
  FeatureCache<kWideFeatures> fc;
  fc.load(S, tid, nt, d);

  // This lane's columns of the rows of its warp's first kWideRegRows slots,
  // on chip for the whole time loop (zeros past r and d).
  float reg[kWideRegRows][kWideRegChunks];
#pragma unroll
  for (int m = 0; m < kWideRegRows; ++m) {
    const int i = w + nw * m;
#pragma unroll
    for (int t = 0; t < kWideRegChunks; ++t) {
      const int c = 32 * t + lane;
      reg[m][t] = i < r && c < d ? __ldg(op + static_cast<size_t>(i) * d + c) : 0.f;
    }
  }

  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hh = 0.5f * h;
    const float h6 = h / 6.0f;
    for (int sub = 0; sub < substeps; ++sub) {
      const bool output = sub == substeps - 1;
#pragma unroll 1
      for (int stage = 0; stage < 4; ++stage) {
        __syncthreads();
        fc.form(S, tid, nt, d);
        __syncthreads();
        // The register slots: chunk t of all kWideRegRows rows at once, in
        // ascending t, every chunk (the features and coefficients past d
        // are zeros), four chunks' features a load; then the chunks past
        // the registers from device memory (L1 or L2), still ascending.
        float acc[kWideRegRows];
#pragma unroll
        for (int m = 0; m < kWideRegRows; ++m) acc[m] = 0.f;
#pragma unroll
        for (int t4 = 0; t4 < kWideRegChunks / 4; ++t4) {
          const float4 f4 = reinterpret_cast<const float4*>(S.fs)[32 * t4 + lane];
          const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int m = 0; m < kWideRegRows; ++m) acc[m] += reg[m][4 * t4 + u] * f[u];
          }
        }
        for (int t = kWideRegChunks; t < Q; ++t) {
          const int c = 32 * t + lane;
          const float f = S.f(c);
#pragma unroll
          for (int m = 0; m < kWideRegRows; ++m) {
            const int i = w + nw * m;
            acc[m] += (i < r && c < d ? __ldg(op + static_cast<size_t>(i) * d + c) : 0.f) * f;
          }
        }
        // Every lane gets every slot's sum; lane m keeps slot m's.
        warp_sums<kWideRegRows>(acc);
        float kk = 0.f;
#pragma unroll
        for (int m = 0; m < kWideRegRows; ++m) kk = lane == m ? acc[m] : kk;
        if (mine) {
          const float next = rk4_update(stage, kk, hh, h, h6, q, acc_q);
          xs[my_i] = next;
          if (stage == 3 && output) {
            md = max_keep_nan(md, fabsf(next - sh));
            if (part != nullptr) part[static_cast<size_t>(s) * r + my_i] = next;
          }
        }
        wide_rows_streamed(op, rows, ps, i0 + staged_rows, S.fs, r, d, nw, Q,
                           [&](int i, float kk_i) {
                             const float next = rk4_update(stage, kk_i, hh, h, h6, qs[i], accs[i]);
                             xs[i] = next;
                             if (stage == 3 && output) {
                               mds[i] = max_keep_nan(mds[i], fabsf(next - shift[l * r + i]));
                               if (part != nullptr) part[static_cast<size_t>(s) * r + i] = next;
                             }
                           });
      }
    }
  }

  __syncthreads();
  bool ok = !mine || ((md <= limits[l * r + my_i]) && isfinite(md));
  for (int i = i0 + tid; i < r; i += nt)
    ok = ok && (mds[i] <= limits[l * r + i]) && isfinite(mds[i]);
  ok = __syncthreads_and(ok);
  if (tid == 0) stable[static_cast<size_t>(l) * N + n] = ok;
}

cudaError_t launch_wide(const float* Ohat, const float* q0, const float* t_eval,
                        const float* shift, const float* limits, int L, int N, int r, int k,
                        int substeps, bool* stable, float* partial, cudaStream_t stream) {
  const int d = 1 + r + r * (r + 1) / 2;
  const int Q = (d + 31) / 32;
  int nw = (r + kWideRegRows - 1) / kWideRegRows;
  nw = nw < kWideWarps ? nw : kWideWarps;
  // Rows past the register slots go to shared memory while it holds them.
  const int fq = WideSmem::chunks(d) > kWideRegChunks ? WideSmem::chunks(d) : kWideRegChunks;
  const size_t base = WideSmem::bytes(r, d, fq, 0, 3);
  const int beyond = r > kWideRegRows * nw ? r - kWideRegRows * nw : 0;
  const size_t row_bytes = static_cast<size_t>(32) * Q * sizeof(float);
  int staged = base + row_bytes * beyond <= kMaxDynamicShared
                   ? beyond
                   : static_cast<int>((kMaxDynamicShared - base) / row_bytes);
  staged = staged < 0 ? 0 : staged;
  const size_t bytes = base + row_bytes * staged;
  cudaError_t rc = cudaFuncSetAttribute(quadratic_screen_wide_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
  if (rc != cudaSuccess) return rc;
  quadratic_screen_wide_kernel<<<dim3(N, L), 32 * nw, bytes, stream>>>(
      Ohat, q0, t_eval, shift, limits, r, d, N, k, substeps, staged, stable, partial);
  return cudaGetLastError();
}

// The four families, as the wrapper names them (ops/ensemble_screen.py).
constexpr int kTemplated = 0;  // r <= kTemplatedMaxR: quadratic_screen_kernel<R>
constexpr int kCapacity = 1;   // r <= kCapacityMaxR: quadratic_screen_cap_kernel<16 or 32>
constexpr int kRuntime = 2;    // any r: quadratic_screen_any_r_kernel
constexpr int kWide = 3;       // any r: quadratic_screen_wide_kernel
constexpr int kTemplatedMaxR = 12;
constexpr int kCapacityMaxR = 32;

int screen(int family, const float* Ohat, const float* q0, const float* t_eval,
           const float* shift, const float* limits, const float* snaps, int L, int N, int r,
           int nd, int W, int k, int substeps, bool* stable, float* partial, float* err_sq,
           cudaStream_t s) {
  if (r < 1) return -1;
  if (family < kTemplated || family > kWide || (family == kTemplated && r > kTemplatedMaxR) ||
      (family == kCapacity && r > kCapacityMaxR))
    return -2;
  if (L < 1 || L > 65535 || N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 ||
      substeps < 1 || W != (family == kTemplated ? warps_per_candidate(r, nd) : nd) ||
      (snaps != nullptr && (partial == nullptr || err_sq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = snaps != nullptr ? partial : nullptr;
  cudaError_t rc = cudaSuccess;
  if (family == kWide) {
    rc = launch_wide(Ohat, q0, t_eval, shift, limits, L, N, r, k, substeps, stable, part, s);
  } else if (family == kRuntime) {
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
// its capacity 16 or 32 chosen by r; 2: the runtime-r kernel, any r; 3:
// the wide kernel, any r). The wrapper chooses the family by r and can
// force one. `partial`, `snaps`
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
