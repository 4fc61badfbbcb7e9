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

}  // namespace

// Screens L problems in one launch; `partial`, `snaps` and `err_sq` as in
// cahbn_screen.cu's gpboi_cahbn_screen. Returns 0 on success, a
// cudaError_t code if a launch failed, and -1 for a state dimension r
// that has no compiled instance (1..12).
extern "C" int gpboi_quadratic_screen(const float* Ohat, const float* q0, const float* t_eval,
                                      const float* shift, const float* limits,
                                      const float* snaps, int L, int N, int r, int nd, int W,
                                      int k, int substeps, bool* stable, float* partial,
                                      float* err_sq, void* stream) {
  if (r < 1 || r > 12) return -1;
  if (L < 1 || L > 65535 || N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 ||
      substeps < 1 || W != warps_per_candidate(r, nd) ||
      (snaps != nullptr && (partial == nullptr || err_sq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = snaps != nullptr ? partial : nullptr;
  cudaError_t rc = cudaSuccess;
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
  if (rc != cudaSuccess || snaps == nullptr) return static_cast<int>(rc);
  mean_error_kernel<<<dim3(N / nd, L), 32, 0, s>>>(partial, snaps, r, N / nd, W, k, nd, err_sq);
  return static_cast<int>(cudaGetLastError());
}
