// Implicit SDIRK2 ensemble screen of "cAHBN" ROM posterior draws with
// time-dependent inputs, for Hopper (sm_90a). Built by
// gp_bayesopinf_torch/ops/build.py with nvcc into a shared library with a
// plain C interface, loaded through ctypes.
//
// Replaces: the Pallas TPU kernel
//   gp_bayesopinf_tpu/ops/ensemble_pallas.py::cahbn_ensemble_screen
//   (pl.pallas_call of _cahbn_kernel).
//
// What it computes: for N = G * nd operator draws of
//   dq/dt = c + A q + H ckron(q) + B u + N (u ⊗ q),
//   d = 1 + r + r(r+1)/2 + nu + nu r columns,
// the 2-stage L-stable SDIRK (gamma = 1 - sqrt(2)/2) with `substeps`
// steps per output interval over t_eval. Each stage takes `newton_iters`
// full Newton steps; each step assembles I - h gamma J from the analytic
// Jacobian and solves it by unpivoted Gaussian elimination. The inputs
// come from `u_stages`, u at every substep start and both stage abscissae
// (ops/cahbn_screen.py::input_stage_times), row ((i-1) substeps + s) * 3
// + {0, 1, 2} for interval i and substep s. The state is clipped to +-1e6
// after every substep. Outputs, as in quadratic_screen.cu: a per-draw
// stability flag (max over t, t0 included, of |q - shift| <= limits, and
// finite) and, per candidate, the squared Frobenius error of the nd-draw
// mean against `snaps` summed over all output times, t0 included.
//
// What bounds it on this card: latency. At the heat ex3 screen shapes
// (G = 16, nd = 20, r = 5, nu = 2, substeps = 4, newton_iters = 6) one
// launch at k = 500 is 1,996 dependent substeps of 12 Newton steps each;
// a Newton step is ~935 flops per draw (right-hand side ~345, Jacobian
// ~400, elimination ~170), 7.4 GFLOP a launch over only 320 threads, and
// the operators are 211 KB. The arithmetic is far below the card's rate
// and the bytes are negligible; the dependent chain and the idle SMs set
// the time.
//
// What the design does about it: it keeps the whole chain on chip and off
// the host, as quadratic_screen.cu does. One warp per candidate (one block,
// so the candidates spread over SMs) and one lane per draw; lanes at or
// above nd shadow draw 0, take part in the shuffles and write nothing. The
// state, stage slopes, Newton iterate and the r x r Newton matrix live in
// registers, unrolled at compile time for each (r, nu); the Jacobian is
// assembled by columns straight into the Newton matrix. The operators stay
// in global memory (L1-resident, 165 floats a draw at r = 5) in a
// draw-minor (r, d, N) layout, so the lanes of a warp read consecutive
// addresses; t_eval and u_stages are read at one address by every lane
// (a broadcast). The draw mean is a __shfl_down_sync reduction and lane 0
// accumulates err_sq: no atomics. Everything is float32, the screening
// contract. The elimination's reciprocal and the back substitution's
// divisions are IEEE (no fast math); nvcc's multiply-add contraction makes
// the results differ from the CPU in the last bits.

#include "screen_common.cuh"

namespace {

constexpr double kGammaD = 1.0 - 0.5 * 1.4142135623730951;  // 1 - sqrt(2)/2
constexpr float kGamma = static_cast<float>(kGammaD);
constexpr float kOneMinusGamma = static_cast<float>(1.0 - kGammaD);

// Column offsets of the "cAHBN" operator blocks.
template <int R, int NU>
struct Layout {
  static constexpr int kP = R * (R + 1) / 2;  // quadratic features
  static constexpr int kH = 1 + R;
  static constexpr int kB = kH + kP;
  static constexpr int kN = kB + NU;
  static constexpr int kD = kN + NU * R;  // columns
};

// Coefficient (i, j) of the draw whose (0, 0) coefficient `op` points at.
template <int R, int NU>
__device__ __forceinline__ float coef(const float* __restrict__ op, int N, int i, int j) {
  return __ldg(op + static_cast<size_t>(i * Layout<R, NU>::kD + j) * N);
}

// dq = rhs(q, u), summed in the order of the reference's XLA twin.
template <int R, int NU>
__device__ __forceinline__ void rom_rhs(const float* __restrict__ op, int N,
                                        const float (&q)[R], const float (&u)[NU],
                                        float (&dq)[R]) {
  using L = Layout<R, NU>;
  float quad[L::kP];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) quad[a * (a + 1) / 2 + b] = q[a] * q[b];
  }
  float uq[NU * R];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
#pragma unroll
    for (int a = 0; a < R; ++a) uq[c * R + a] = u[c] * q[a];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float acc = coef<R, NU>(op, N, i, 0);
#pragma unroll
    for (int a = 0; a < R; ++a) acc += coef<R, NU>(op, N, i, 1 + a) * q[a];
#pragma unroll
    for (int z = 0; z < L::kP; ++z) acc += coef<R, NU>(op, N, i, L::kH + z) * quad[z];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      acc += coef<R, NU>(op, N, i, L::kB + c) * u[c];
#pragma unroll
      for (int a = 0; a < R; ++a) acc += coef<R, NU>(op, N, i, L::kN + c * R + a) * uq[c * R + a];
    }
    dq[i] = acc;
  }
}

// M = I - hg J(x, u), the Jacobian assembled column by column as the
// reference does: J[:, j] = A[:, j] + sum over the quadratic features
// that hold x_j + sum_c N[:, c r + j] u_c.
template <int R, int NU>
__device__ __forceinline__ void newton_matrix(const float* __restrict__ op, int N,
                                              const float (&x)[R], const float (&u)[NU],
                                              float hg, float (&M)[R][R]) {
  using L = Layout<R, NU>;
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float col = coef<R, NU>(op, N, i, 1 + j);
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          const int z = a * (a + 1) / 2 + b;
          if (a == j) col += coef<R, NU>(op, N, i, L::kH + z) * x[b];
          if (b == j) col += coef<R, NU>(op, N, i, L::kH + z) * x[a];
        }
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) col += coef<R, NU>(op, N, i, L::kN + c * R + j) * u[c];
      M[i][j] = (i == j ? 1.f : 0.f) - hg * col;
    }
  }
}

// Solve M dk = F in place by Gaussian elimination without pivoting
// (solve/ivp.py::solve_small of the reference): forward elimination, then
// back substitution. M and F are overwritten.
template <int R>
__device__ __forceinline__ void eliminate(float (&M)[R][R], float (&F)[R], float (&dk)[R]) {
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const float inv = 1.f / M[p][p];
#pragma unroll
    for (int i = p + 1; i < R; ++i) {
      const float f = M[i][p] * inv;
#pragma unroll
      for (int j = p + 1; j < R; ++j) M[i][j] = M[i][j] - f * M[p][j];
      F[i] = F[i] - f * F[p];
    }
  }
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
    float acc = F[i];
#pragma unroll
    for (int j = i + 1; j < R; ++j) acc = acc - M[i][j] * dk[j];
    dk[i] = acc / M[i][i];
  }
}

// Newton-solve kk = rhs(q_base + hg kk, u) from the initial guess in kk.
template <int R, int NU>
__device__ __forceinline__ void solve_stage(const float* __restrict__ op, int N,
                                            const float (&u)[NU], const float (&q_base)[R],
                                            float hg, int newton_iters, float (&kk)[R]) {
#pragma unroll 1
  for (int it = 0; it < newton_iters; ++it) {
    float x[R], F[R], dk[R], M[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = q_base[i] + hg * kk[i];
    rom_rhs<R, NU>(op, N, x, u, F);
#pragma unroll
    for (int i = 0; i < R; ++i) F[i] = kk[i] - F[i];
    newton_matrix<R, NU>(op, N, x, u, hg, M);
    eliminate<R>(M, F, dk);
#pragma unroll
    for (int i = 0; i < R; ++i) kk[i] = kk[i] - dk[i];
  }
}

template <int NU>
__device__ __forceinline__ void load_inputs(const float* __restrict__ u_stages, int row,
                                            float (&u)[NU]) {
#pragma unroll
  for (int c = 0; c < NU; ++c) u[c] = __ldg(u_stages + static_cast<size_t>(row) * NU + c);
}

template <int R, int NU>
__global__ void __launch_bounds__(32)
cahbn_screen_kernel(const float* __restrict__ OT,        // (R, D, N)
                    const float* __restrict__ q0,        // (R,)
                    const float* __restrict__ t_eval,    // (k,)
                    const float* __restrict__ u_stages,  // ((k-1) substeps 3, NU)
                    const float* __restrict__ shift,     // (R,)
                    const float* __restrict__ limits,    // (R,)
                    const float* __restrict__ snaps,     // (R, k) or null
                    int N, int nd, int k, int substeps, int newton_iters,
                    bool* __restrict__ stable,           // (N,)
                    float* __restrict__ err_sq) {        // (G,)
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const bool active = lane < nd;
  const int n = g * nd + (active ? lane : 0);
  const float* op = OT + n;
  const bool track = snaps != nullptr;

  float q[R], sh[R], maxdev[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    q[i] = q0[i];
    sh[i] = shift[i];
    maxdev[i] = fabsf(q[i] - sh[i]);
  }
  float err = track ? mean_sq_error<R>(q, active, nd, snaps, k, 0) : 0.f;

  float u[NU], k1[R], k2[R], base2[R];
  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hg = h * kGamma;
    const float h1 = h * kOneMinusGamma;
    for (int sub = 0; sub < substeps; ++sub) {
      const int row = ((s - 1) * substeps + sub) * 3;
      load_inputs<NU>(u_stages, row, u);
      rom_rhs<R, NU>(op, N, q, u, k1);
      load_inputs<NU>(u_stages, row + 1, u);
      solve_stage<R, NU>(op, N, u, q, hg, newton_iters, k1);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        base2[i] = q[i] + h1 * k1[i];
        k2[i] = k1[i];
      }
      load_inputs<NU>(u_stages, row + 2, u);
      solve_stage<R, NU>(op, N, u, base2, hg, newton_iters, k2);
#pragma unroll
      for (int i = 0; i < R; ++i)
        q[i] = clip_keep_nan(q[i] + h * (kOneMinusGamma * k1[i] + kGamma * k2[i]));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) maxdev[i] = max_keep_nan(maxdev[i], fabsf(q[i] - sh[i]));
    if (track) err += mean_sq_error<R>(q, active, nd, snaps, k, s);
  }

  if (active) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < R; ++i) ok = ok && (maxdev[i] <= limits[i]) && isfinite(maxdev[i]);
    stable[n] = ok;
  }
  if (lane == 0) err_sq[g] = err;
}

template <int R, int NU>
cudaError_t launch(const float* OT, const float* q0, const float* t_eval, const float* u_stages,
                   const float* shift, const float* limits, const float* snaps, int N, int nd,
                   int k, int substeps, int newton_iters, bool* stable, float* err_sq,
                   cudaStream_t stream) {
  cahbn_screen_kernel<R, NU><<<N / nd, 32, 0, stream>>>(OT, q0, t_eval, u_stages, shift, limits,
                                                         snaps, N, nd, k, substeps, newton_iters,
                                                         stable, err_sq);
  return cudaGetLastError();
}

template <int NU>
int launch_r(int r, const float* OT, const float* q0, const float* t_eval, const float* u_stages,
             const float* shift, const float* limits, const float* snaps, int N, int nd, int k,
             int substeps, int newton_iters, bool* stable, float* err_sq, cudaStream_t stream) {
  switch (r) {
#define GPBOI_CAHBN_CASE(R)                                                                   \
  case R:                                                                                     \
    return static_cast<int>(launch<R, NU>(OT, q0, t_eval, u_stages, shift, limits, snaps, N, \
                                          nd, k, substeps, newton_iters, stable, err_sq,     \
                                          stream));
    GPBOI_CAHBN_CASE(1)
    GPBOI_CAHBN_CASE(2)
    GPBOI_CAHBN_CASE(3)
    GPBOI_CAHBN_CASE(4)
    GPBOI_CAHBN_CASE(5)
    GPBOI_CAHBN_CASE(6)
    GPBOI_CAHBN_CASE(7)
    GPBOI_CAHBN_CASE(8)
#undef GPBOI_CAHBN_CASE
    default:
      return -1;
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// for a state dimension r (1..8) or input dimension nu (1..2) that has no
// compiled instance.
extern "C" int gpboi_cahbn_screen(const float* OT, const float* q0, const float* t_eval,
                                  const float* u_stages, const float* shift,
                                  const float* limits, const float* snaps, int N, int r, int nu,
                                  int nd, int k, int substeps, int newton_iters, bool* stable,
                                  float* err_sq, void* stream) {
  if (N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 || substeps < 1 || newton_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nu) {
    case 1:
      return launch_r<1>(r, OT, q0, t_eval, u_stages, shift, limits, snaps, N, nd, k, substeps,
                         newton_iters, stable, err_sq, s);
    case 2:
      return launch_r<2>(r, OT, q0, t_eval, u_stages, shift, limits, snaps, N, nd, k, substeps,
                         newton_iters, stable, err_sq, s);
    default:
      return -1;
  }
}
