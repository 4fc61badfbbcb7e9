// Implicit SDIRK2 ensemble screen of "cAHBN" ROM posterior draws with
// time-dependent inputs, for Hopper (sm_90a). Built by
// gp_bayesopinf_torch/ops/build.py with nvcc into a shared library with a
// plain C interface, loaded through ctypes.
//
// Replaces: the Pallas TPU kernel
//   gp_bayesopinf_tpu/ops/ensemble_pallas.py::cahbn_ensemble_screen
//   (pl.pallas_call of _cahbn_kernel).
//
// What it computes: for L problems (trajectories) sharing N = G * nd
// operator draws of
//   dq/dt = c + A q + H ckron(q) + B u + N (u ⊗ q),
//   d = 1 + r + r(r+1)/2 + nu + nu r columns,
// the 2-stage L-stable SDIRK (gamma = 1 - sqrt(2)/2) with `substeps`
// steps per output interval over t_eval, from each problem's own initial
// state and inputs. Each stage takes `newton_iters` full Newton steps;
// each step assembles I - h gamma J from the analytic Jacobian and solves
// it by unpivoted Gaussian elimination. The inputs come from `u_stages`,
// u at every substep start and both stage abscissae
// (ops/cahbn_screen.py::input_stage_times), row ((i-1) substeps + s) * 3
// + {0, 1, 2} for interval i and substep s. The state is clipped to +-1e6
// after every substep. Outputs, per problem: a per-draw stability flag
// (max over t, t0 included, of |q - shift| <= limits, and finite) and,
// per candidate, the squared Frobenius error of the nd-draw mean against
// `snaps` summed over all output times, t0 included.
//
// What bounds it on this card: the latency of the dependent chain. At the
// heat ex3 screen shapes (G = 16, nd = 20, r = 5, nu = 2, substeps = 4,
// newton_iters = 6) a launch at k = 500 is 1,996 dependent substeps of 12
// Newton steps each; the float32 work (7.4 GFLOP a problem) and the bytes
// are far below the card's rates, and the warps are too few to hide
// latency. A Newton step's chain is the right-hand side's d-term sum (kept
// in the reference's order), an all-gather of the Newton matrix, r pivots
// (an IEEE reciprocal, a multiply, a multiply-add) and r back
// substitutions (multiply-adds and an IEEE division).
//
// What the design does about it (the layout of screen_common.cuh): a draw
// takes 8 lanes at r = 5, lane i owning row i. Before the time loop each
// lane loads its row's d coefficients into registers (33 floats at r = 5,
// nu = 2); nothing of the operators is read inside the loop. Lane i
// computes row i of the right-hand side and of the Newton matrix, each in
// the summation order of the one-draw-per-thread kernel it replaced, so
// the right-hand side keeps its bits. The state vectors are replicated in
// the group. The Newton matrix's rows are all-gathered by shuffles and
// every lane of the group runs the elimination in the operation order of
// solve/ivp.py::solve_small (inv = 1 / M[p][p], f = M[i][p] inv, IEEE
// divisions in the back substitution; no fast math), which keeps shuffles
// and divergent branches out of its chain. Two slow paths of the IEEE
// division are kept off the chain: a zero numerator, common once Newton
// has converged, is answered without it (div_rn), and a draw whose state
// turns NaN, which stays NaN, is retired to a zero operator and reports
// NaN from then on. All L problems of a time grid go in one launch
// (blockIdx.y), and a candidate's draws spread over W one-warp blocks, so
// ex3's 5 x 16 candidates keep 400 warps on the SMs. The draw mean is a
// fixed-order shuffle tree within a warp plus mean_error_kernel across
// warps: no atomics, the same bits every run. Everything is float32, the
// screening contract; nvcc's multiply-add contraction makes the results
// differ from the CPU in the last bits.
//
// Above r = 8 or nu = 2 the row and the all-gathered Newton matrix no
// longer fit in registers, and r and nu are launch arguments of a second
// kernel, cahbn_screen_any_kernel (the runtime-dimension layout of
// screen_common.cuh): one draw per warp, lane i owning rows i, i + 32,
// ...; the state, the stage slopes, the Newton iterate, its residual and
// step and the r x r Newton matrix (1 KB at r = 16) live in shared
// memory, and the operator is staged there transposed where it fits.
// Each lane assembles its rows of I - h gamma J column by column, in the
// order of newton_row; the forward elimination updates the rows below a
// pivot in parallel, each entry in the order of eliminate, and lane 0
// runs the back substitution (IEEE divisions, div_rn). A draw whose state
// turns NaN reports NaN to the end without integrating further, as the
// templated kernel's retired draws do.

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

// This lane's row of dq = rhs(q, u), summed in the order of the reference's XLA twin.
template <int R, int NU>
__device__ __forceinline__ float rhs_row(const float (&c)[Layout<R, NU>::kD],
                                         const float (&q)[R], const float (&u)[NU]) {
  using L = Layout<R, NU>;
  float acc = c[0];
#pragma unroll
  for (int a = 0; a < R; ++a) acc += c[1 + a] * q[a];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) acc += c[L::kH + a * (a + 1) / 2 + b] * (q[a] * q[b]);
  }
#pragma unroll
  for (int e = 0; e < NU; ++e) {
    acc += c[L::kB + e] * u[e];
#pragma unroll
    for (int a = 0; a < R; ++a) acc += c[L::kN + e * R + a] * (u[e] * q[a]);
  }
  return acc;
}

// Row `row` of M = I - hg J(x, u), the Jacobian row assembled column by
// column as the reference does: J[row, j] = A[row, j] + the quadratic
// features that hold x_j + sum_e N[row, e r + j] u_e.
template <int R, int NU>
__device__ __forceinline__ void newton_row(const float (&c)[Layout<R, NU>::kD],
                                           const float (&x)[R], const float (&u)[NU],
                                           float hg, int row, float (&m)[R]) {
  using L = Layout<R, NU>;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float col = c[1 + j];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int z = a * (a + 1) / 2 + b;
        if (a == j) col += c[L::kH + z] * x[b];
        if (b == j) col += c[L::kH + z] * x[a];
      }
    }
#pragma unroll
    for (int e = 0; e < NU; ++e) col += c[L::kN + e * R + j] * u[e];
    m[j] = (row == j ? 1.f : 0.f) - hg * col;
  }
}

// a / b, rounded as the IEEE division '/' is. On this card '/' sends a zero
// numerator through its slow path, several times slower than its fast
// one, and most back substitutions of a converged Newton step divide
// zeros; a zero by a finite nonzero b is the zero of sign sign(a) xor
// sign(b), so that case is answered here. The empty asm hides the
// substituted numerator from the compiler, which would otherwise divide
// the original one (the quotient is unused when it is zero).
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.f && b != 0.f && isfinite(b);
  float num = zero ? 1.f : a;
#ifdef __CUDA_ARCH__
  asm("" : "+f"(num));
#endif
  const float q = num / b;
  return zero ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000) : q;
}

// Solve M dk = F by Gaussian elimination without pivoting
// (solve/ivp.py::solve_small of the reference): the lane of row i holds
// m_row = M[i, :] and f_row = F[i]; the rows are all-gathered, and every
// lane of the group runs the whole elimination and back substitution, so
// no shuffle or divergent branch sits inside their chain of reciprocals
// and divisions.
template <int R>
__device__ __forceinline__ void eliminate(const float (&m_row)[R], float f_row,
                                          float (&dk)[R]) {
  float M[R][R], F[R], col[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    all_gather<R>(m_row[j], col);
#pragma unroll
    for (int i = 0; i < R; ++i) M[i][j] = col[i];
  }
  all_gather<R>(f_row, F);
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
    dk[i] = div_rn(acc, M[i][i]);
  }
}

// Newton-solve kk = rhs(q_base + hg kk, u) from the initial guess in kk
// (replicated in the group).
template <int R, int NU>
__device__ __forceinline__ void solve_stage(const float (&c)[Layout<R, NU>::kD], int row,
                                            const float (&u)[NU], const float (&q_base)[R],
                                            float hg, int newton_iters, float (&kk)[R]) {
#pragma unroll 1
  for (int it = 0; it < newton_iters; ++it) {
    float x[R], dk[R], m[R];
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = q_base[i] + hg * kk[i];
    const float F = own<R>(kk, row) - rhs_row<R, NU>(c, x, u);
    newton_row<R, NU>(c, x, u, hg, row, m);
    eliminate<R>(m, F, dk);
#pragma unroll
    for (int i = 0; i < R; ++i) kk[i] = kk[i] - dk[i];
  }
}

template <int NU>
__device__ __forceinline__ void load_inputs(const float* __restrict__ u_stages, int row,
                                            float (&u)[NU]) {
#pragma unroll
  for (int e = 0; e < NU; ++e) u[e] = __ldg(u_stages + static_cast<size_t>(row) * NU + e);
}

template <int R, int NU>
__global__ void __launch_bounds__(32)
cahbn_screen_kernel(const float* __restrict__ Ohat,      // (N, R, D)
                    const float* __restrict__ q0,        // (L, R)
                    const float* __restrict__ t_eval,    // (k,)
                    const float* __restrict__ u_stages,  // (L, (k-1) substeps 3, NU)
                    const float* __restrict__ shift,     // (L, R)
                    const float* __restrict__ limits,    // (L, R)
                    int N, int nd, int W, int k, int substeps, int newton_iters,
                    bool* __restrict__ stable,           // (L, N)
                    float* __restrict__ partial) {       // (L, G, W, k, R) or null
  constexpr int D = Layout<R, NU>::kD;
  const Slot<R> at(nd, W);
  const int G = N / nd;
  const int row = at.row;

  // This lane's operator row, on chip for the whole time loop.
  float c[D];
  const float* op = Ohat + (static_cast<size_t>(at.n) * R + (row < R ? row : 0)) * D;
#pragma unroll
  for (int j = 0; j < D; ++j) c[j] = row < R ? __ldg(op + j) : 0.f;

  const float* u_p = u_stages + static_cast<size_t>(at.problem) * (k - 1) * substeps * 3 * NU;
  float* part = partial == nullptr
                    ? nullptr
                    : partial + (static_cast<size_t>(at.problem) * G * W + at.warp) * k * R;
  float q[R], sh[R], maxdev[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    q[i] = q0[at.problem * R + i];
    sh[i] = shift[at.problem * R + i];
    maxdev[i] = -1.f;
  }

  // A state that holds a NaN keeps it to the end (every row of the
  // right-hand side reads every state), so the draw's flag and its
  // candidate's error are decided once it does. From then on the draw is
  // "dead": it reports NaN, and its lanes integrate q = 0 with a zero
  // operator, which keeps the warp's other draws off the slow path that NaN
  // operands send every reciprocal and division through.
  bool dead = false;
  auto report = [&](int s) {
    float rep[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      rep[i] = dead ? __int_as_float(0x7fc00000) : q[i];
      maxdev[i] = max_keep_nan(maxdev[i], fabsf(rep[i] - sh[i]));
    }
    if (part != nullptr) warp_draw_sum<R>(rep, at.active, part + static_cast<size_t>(s) * R);
    bool nan_now = false;
#pragma unroll
    for (int i = 0; i < R; ++i) nan_now = nan_now || isnan(q[i]);
    if (nan_now) {
      dead = true;
#pragma unroll
      for (int j = 0; j < D; ++j) c[j] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) q[i] = 0.f;
    }
  };
  report(0);

  float u[NU], k1[R], k2[R], base2[R];
  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hg = h * kGamma;
    const float h1 = h * kOneMinusGamma;
    for (int sub = 0; sub < substeps; ++sub) {
      const int urow = ((s - 1) * substeps + sub) * 3;
      load_inputs<NU>(u_p, urow, u);
      all_gather<R>(rhs_row<R, NU>(c, q, u), k1);
      load_inputs<NU>(u_p, urow + 1, u);
      solve_stage<R, NU>(c, row, u, q, hg, newton_iters, k1);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        base2[i] = q[i] + h1 * k1[i];
        k2[i] = k1[i];
      }
      load_inputs<NU>(u_p, urow + 2, u);
      solve_stage<R, NU>(c, row, u, base2, hg, newton_iters, k2);
#pragma unroll
      for (int i = 0; i < R; ++i)
        q[i] = clip_keep_nan(q[i] + h * (kOneMinusGamma * k1[i] + kGamma * k2[i]));
    }
    report(s);
  }

  if (at.active && row == 0) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < R; ++i)
      ok = ok && (maxdev[i] <= limits[at.problem * R + i]) && isfinite(maxdev[i]);
    stable[static_cast<size_t>(at.problem) * N + at.n] = ok;
  }
}

template <int R, int NU>
cudaError_t launch(const float* Ohat, const float* q0, const float* t_eval, const float* u_stages,
                   const float* shift, const float* limits, int L, int N, int nd, int W, int k,
                   int substeps, int newton_iters, bool* stable, float* partial,
                   cudaStream_t stream) {
  const dim3 grid(N / nd * W, L);
  cahbn_screen_kernel<R, NU><<<grid, 32, 0, stream>>>(Ohat, q0, t_eval, u_stages, shift, limits,
                                                      N, nd, W, k, substeps, newton_iters,
                                                      stable, partial);
  return cudaGetLastError();
}

template <int NU>
int launch_r(int r, const float* Ohat, const float* q0, const float* t_eval,
             const float* u_stages, const float* shift, const float* limits, int L, int N,
             int nd, int W, int k, int substeps, int newton_iters, bool* stable, float* partial,
             cudaStream_t stream) {
  switch (r) {
#define GPBOI_CAHBN_CASE(R)                                                                  \
  case R:                                                                                    \
    return static_cast<int>(launch<R, NU>(Ohat, q0, t_eval, u_stages, shift, limits, L, N,   \
                                          nd, W, k, substeps, newton_iters, stable, partial, \
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

// Row i of rhs(x, u) at run-time (r, nu), in the order of rhs_row.
__device__ __forceinline__ float rhs_any(const OpView& op, int i, const float* x,
                                         const float* __restrict__ u, int r, int nu) {
  const int kB = 1 + r + r * (r + 1) / 2;
  const int kN = kB + nu;
  float acc = op(i, 0);
  for (int a = 0; a < r; ++a) acc += op(i, 1 + a) * x[a];
  int z = 1 + r;
  for (int a = 0; a < r; ++a) {
    const float xa = x[a];
    for (int b = 0; b <= a; ++b, ++z) acc += op(i, z) * (xa * x[b]);
  }
  for (int e = 0; e < nu; ++e) {
    const float ue = __ldg(u + e);
    acc += op(i, kB + e) * ue;
    for (int a = 0; a < r; ++a) acc += op(i, kN + e * r + a) * (ue * x[a]);
  }
  return acc;
}

// Row i of M = I - hg J(x, u) into m[0..r), each column summed in the
// order of newton_row: A[i, j], then the quadratic features that hold x_j
// (the pairs (j, b) for b <= j, the pair (j, j) twice, then (a, j) for a >
// j), then the input columns.
__device__ __forceinline__ void newton_row_any(const OpView& op, int i, const float* x,
                                               const float* __restrict__ u, float hg, int r,
                                               int nu, float* m) {
  const int kH = 1 + r;
  const int kN = kH + r * (r + 1) / 2 + nu;
  for (int j = 0; j < r; ++j) {
    float col = op(i, 1 + j);
    const int zj = kH + j * (j + 1) / 2;
    for (int b = 0; b <= j; ++b) col += op(i, zj + b) * x[b];
    col += op(i, zj + j) * x[j];
    for (int a = j + 1; a < r; ++a) col += op(i, kH + a * (a + 1) / 2 + j) * x[a];
    for (int e = 0; e < nu; ++e) col += op(i, kN + e * r + j) * __ldg(u + e);
    m[j] = (i == j ? 1.f : 0.f) - hg * col;
  }
}

// Solve M dk = F (M rows of stride ms, F and dk in shared memory) in the
// operation order of eliminate; M and F are overwritten.
__device__ __forceinline__ void eliminate_any(float* M, int ms, float* F, float* dk, int r) {
  const int lane = threadIdx.x;
  for (int p = 0; p < r; ++p) {
    const float inv = 1.f / M[p * ms + p];
    for (int i = lane; i < r; i += 32) {
      if (i <= p) continue;
      const float f = M[i * ms + p] * inv;
      for (int j = p + 1; j < r; ++j) M[i * ms + j] = M[i * ms + j] - f * M[p * ms + j];
      F[i] = F[i] - f * F[p];
    }
    __syncwarp();
  }
  if (lane == 0) {
    for (int i = r - 1; i >= 0; --i) {
      float acc = F[i];
      for (int j = i + 1; j < r; ++j) acc = acc - M[i * ms + j] * dk[j];
      dk[i] = div_rn(acc, M[i * ms + i]);
    }
  }
  __syncwarp();
}

// Shared scratch of the runtime kernel: nine r-vectors, then the Newton
// matrix (rows of odd stride ms, so that the lanes' rows fall in distinct
// banks), then the staged operator.
struct AnyScratch {
  float *q, *k1, *k2, *base, *x, *F, *dk, *maxdev, *sh, *M, *op;
  int ms;
  __device__ AnyScratch(float* smem, int r)
      : q(smem), k1(q + r), k2(k1 + r), base(k2 + r), x(base + r), F(x + r), dk(F + r),
        maxdev(dk + r), sh(maxdev + r), M(sh + r), op(M + r * (r | 1)), ms(r | 1) {}
};

// Newton-solve kk = rhs(q_base + hg kk, u) from the initial guess in kk.
__device__ __forceinline__ void solve_stage_any(const OpView& op, const AnyScratch& w,
                                                const float* __restrict__ u, const float* q_base,
                                                float hg, int newton_iters, float* kk, int r,
                                                int nu) {
  const int lane = threadIdx.x;
  for (int it = 0; it < newton_iters; ++it) {
    for (int i = lane; i < r; i += 32) w.x[i] = q_base[i] + hg * kk[i];
    __syncwarp();
    for (int i = lane; i < r; i += 32) {
      w.F[i] = kk[i] - rhs_any(op, i, w.x, u, r, nu);
      newton_row_any(op, i, w.x, u, hg, r, nu, w.M + i * w.ms);
    }
    __syncwarp();
    eliminate_any(w.M, w.ms, w.F, w.dk, r);
    for (int i = lane; i < r; i += 32) kk[i] = kk[i] - w.dk[i];
    __syncwarp();
  }
}

// The runtime-(r, nu) kernel: block (n, l) integrates draw n of problem l.
__global__ void __launch_bounds__(32)
cahbn_screen_any_kernel(const float* __restrict__ Ohat,      // (N, r, d)
                        const float* __restrict__ q0,        // (L, r)
                        const float* __restrict__ t_eval,    // (k,)
                        const float* __restrict__ u_stages,  // (L, (k-1) substeps 3, nu)
                        const float* __restrict__ shift,     // (L, r)
                        const float* __restrict__ limits,    // (L, r)
                        int r, int nu, int d, int N, int k, int substeps, int newton_iters,
                        bool staged,
                        bool* __restrict__ stable,           // (L, N)
                        float* __restrict__ partial) {       // (L, N, k, r) or null
  extern __shared__ float smem[];
  const AnyScratch w(smem, r);
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const OpView op = stage_operator(Ohat, n, r, d, staged, w.op);
  const float* u_p = u_stages + static_cast<size_t>(l) * (k - 1) * substeps * 3 * nu;
  float* part = partial == nullptr ? nullptr
                                   : partial + (static_cast<size_t>(l) * N + n) * k * r;
  for (int i = lane; i < r; i += 32) {
    w.q[i] = q0[l * r + i];
    w.sh[i] = shift[l * r + i];
    w.maxdev[i] = fabsf(w.q[i] - w.sh[i]);
    if (part != nullptr) part[i] = w.q[i];
  }
  __syncwarp();

  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hg = h * kGamma;
    const float h1 = h * kOneMinusGamma;
    for (int sub = 0; sub < substeps; ++sub) {
      const float* u0 = u_p + static_cast<size_t>((s - 1) * substeps + sub) * 3 * nu;
      for (int i = lane; i < r; i += 32) w.k1[i] = rhs_any(op, i, w.q, u0, r, nu);
      __syncwarp();
      solve_stage_any(op, w, u0 + nu, w.q, hg, newton_iters, w.k1, r, nu);
      for (int i = lane; i < r; i += 32) {
        w.base[i] = w.q[i] + h1 * w.k1[i];
        w.k2[i] = w.k1[i];
      }
      __syncwarp();
      solve_stage_any(op, w, u0 + 2 * nu, w.base, hg, newton_iters, w.k2, r, nu);
      for (int i = lane; i < r; i += 32)
        w.q[i] = clip_keep_nan(w.q[i] + h * (kOneMinusGamma * w.k1[i] + kGamma * w.k2[i]));
      __syncwarp();
    }
    bool nan_now = false;
    for (int i = lane; i < r; i += 32) {
      w.maxdev[i] = max_keep_nan(w.maxdev[i], fabsf(w.q[i] - w.sh[i]));
      if (part != nullptr) part[static_cast<size_t>(s) * r + i] = w.q[i];
      nan_now = nan_now || isnan(w.q[i]);
    }
    // A NaN reaches every row of the next right-hand side and stays: the
    // draw reports NaN from here on.
    if (__any_sync(kFullMask, nan_now)) {
      const float nan = __int_as_float(0x7fc00000);
      for (int i = lane; i < r; i += 32) {
        w.maxdev[i] = nan;
        if (part != nullptr)
          for (int t = s + 1; t < k; ++t) part[static_cast<size_t>(t) * r + i] = nan;
      }
      break;
    }
  }

  bool ok = true;
  for (int i = lane; i < r; i += 32)
    ok = ok && (w.maxdev[i] <= limits[l * r + i]) && isfinite(w.maxdev[i]);
  ok = __all_sync(kFullMask, ok);
  if (lane == 0) stable[static_cast<size_t>(l) * N + n] = ok;
}

cudaError_t launch_any(const float* Ohat, const float* q0, const float* t_eval,
                       const float* u_stages, const float* shift, const float* limits, int L,
                       int N, int r, int nu, int k, int substeps, int newton_iters,
                       bool* stable, float* partial, cudaStream_t stream) {
  const int d = 1 + r + r * (r + 1) / 2 + nu + nu * r;
  bool staged;
  const size_t bytes = any_r_shared_bytes(r, d, 9, r * (r | 1), &staged);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        cahbn_screen_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return rc;
  }
  cahbn_screen_any_kernel<<<dim3(N, L), 32, bytes, stream>>>(
      Ohat, q0, t_eval, u_stages, shift, limits, r, nu, d, N, k, substeps, newton_iters, staged,
      stable, partial);
  return cudaGetLastError();
}

// Instances r 1..8 with nu 1..2; anything above goes to the runtime kernel.
constexpr int kTemplatedMaxR = 8;  // the reference's SMALL_SOLVE_MAX
constexpr int kTemplatedMaxNu = 2;

}  // namespace

// Screens L problems in one launch. `partial` is scratch of L * G * W * k
// * r floats, W = warps_per_candidate(r, nd) for the templated instances
// (r <= 8 and nu <= 2) and W = nd for the runtime kernel (the wrapper
// passes W, and it is checked); with `snaps` (L, r, k) non-null the draw
// means' squared errors go to err_sq (L, G), else partial and err_sq are
// not touched. Returns 0 on success, a cudaError_t code if a launch
// failed, and -1 for r < 1 or nu < 1.
extern "C" int gpboi_cahbn_screen(const float* Ohat, const float* q0, const float* t_eval,
                                  const float* u_stages, const float* shift,
                                  const float* limits, const float* snaps, int L, int N, int r,
                                  int nu, int nd, int W, int k, int substeps, int newton_iters,
                                  bool* stable, float* partial, float* err_sq, void* stream) {
  if (r < 1 || nu < 1) return -1;
  const bool any = r > kTemplatedMaxR || nu > kTemplatedMaxNu;
  if (L < 1 || L > 65535 || N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 ||
      substeps < 1 || newton_iters < 0 || W != (any ? nd : warps_per_candidate(r, nd)) ||
      (snaps != nullptr && (partial == nullptr || err_sq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = snaps != nullptr ? partial : nullptr;
  int rc;
  if (any)
    rc = static_cast<int>(launch_any(Ohat, q0, t_eval, u_stages, shift, limits, L, N, r, nu, k,
                                     substeps, newton_iters, stable, part, s));
  else
    rc = nu == 1 ? launch_r<1>(r, Ohat, q0, t_eval, u_stages, shift, limits, L, N, nd, W, k,
                               substeps, newton_iters, stable, part, s)
                 : launch_r<2>(r, Ohat, q0, t_eval, u_stages, shift, limits, L, N, nd, W, k,
                               substeps, newton_iters, stable, part, s);
  if (rc != 0 || snaps == nullptr) return rc;
  mean_error_kernel<<<dim3(N / nd, L), 32, 0, s>>>(partial, snaps, r, N / nd, W, k, nd, err_sq);
  return static_cast<int>(cudaGetLastError());
}
