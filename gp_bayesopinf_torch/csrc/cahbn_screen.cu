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
// Four kernel families, passed to the C entry by code; the wrapper
// (ops/cahbn_screen.py::screen_family) chooses the templated, capacity or
// wide family by (r, nu) and can force any family that takes (r, nu):
//
// * templated (0), r 1..8 with nu 1..2: cahbn_screen_kernel<R, NU> above;
// * capacity-templated (1), r <= 16 with nu <= 4:
//   cahbn_screen_cap_kernel<RCAP, 4>, RCAP 12 (r <= 12) and 16 (r 13..16);
// * runtime-(r, nu) (2), any r and nu: cahbn_screen_any_kernel, the
//   yardstick the capacity kernel is held against bit for bit and the
//   wide kernel is timed against; only forcing (family "runtime") takes
//   it;
// * wide (3), any r and nu: cahbn_screen_wide_kernel, the path beyond r =
//   16 or nu = 4.
//
// Beyond r = 8 or nu = 2 the row and the all-gathered Newton matrix no
// longer fit in registers, so both other families give a draw a warp (the
// capacity and runtime layouts of screen_common.cuh), lane i owning row
// i, and W = nd warps per candidate. What bounds them is the dependent
// chain of a Newton step (at (9, 2), (12, 2) and (6, 3) on the H100 the
// capacity kernel takes 65-248x, the runtime kernel 360-940x the time of
// its float32 work at the card's rate; chip_smoke.py phase 4b): the
// right-hand side's d-term sum, the
// Newton row, r pivots and r back substitutions, each in the reference's
// order. The runtime kernel keeps the state, the stage slopes, the Newton
// iterate and the r x r matrix in shared memory: every term of the chain
// pays a shared-memory round trip through a runtime-strided view, every
// pivot a __syncwarp(), and lane 0 alone runs the back substitution. The
// capacity kernel takes (r, nu) at run time but unrolls every loop to
// (RCAP, NUCAP): the state, the stage slopes and the iterate are
// statically indexed registers replicated in the warp, and the operator
// is staged in shared memory transposed with the compile-time row stride
// RCAP (a coefficient load is the lane's base plus a constant; each
// quadratic block is loaded while the previous one is summed). Every
// branch on the dimensions or the lane is a convergence region (BSSY/BSYNC
// in the SASS) that the chain waits on, so the design keeps them off the
// chain (scripts/torch_screen_cycles.py splits a Newton step's cycles
// between its parts): the right-hand
// side predicates its linear and input terms and nests its quadratic
// blocks; the Newton row forms all RCAP columns (the chains interleave;
// columns j >= r are never read); the elimination keeps lane i's Newton
// row and F[i] in registers, broadcasts row p and F[p] by unguarded
// shuffles, lets every lane form inv = 1 / M[p][p], and has the lanes
// below p update their own rows entry by entry, the others selecting their
// old values; the back substitution keeps dk replicated, every lane sums
// its own row in ascending j, lane i's sum goes through the IEEE division
// (div_rn; the others divide 0 by 1) and a shuffle hands dk[i] to every
// lane. The NaN retirement, the clip and max_keep_nan are the runtime
// kernel's, and so are each row's arithmetic, the per-draw partial sums
// and hence err_sq, to the bit.
//
// Beyond r = 16 or nu = 4 one warp's registers no longer hold the capacity
// layout (capacity 16 already takes 168 registers and spills 20 B), and
// the runtime kernel, which keeps everything in shared memory, lets lane 0
// alone run each back substitution and takes a row's d-term sum and
// Newton row serially in one lane, ran 172x (20, 2) and 888x (6, 5) its
// bound. A Newton step is bound by its chain: the right-hand side's d
// terms, the r x r Newton matrix (r + 2 + nu terms an entry), r pivots
// and r back substitutions. The wide kernel's design (the wide layout of
// screen_common.cuh): a draw takes a block of nw = min(8, ceil(r / 4))
// warps; the features [1, x, ckron(x), u, u ⊗ x] are formed once a Newton
// step in shared memory, so the input terms B u and N (u ⊗ q) are columns
// like any other, with nu read at run time and no branch on it in the
// chain; the right-hand side's rows spread over the warps, four at a time,
// and each row's columns over the lanes (split by chunks of 32, the four
// shuffle trees interleaved); the Newton matrix's columns spread over the
// warps, four at a time, and its rows over the lanes, each entry summed in
// a fixed order (A[i, j], the quadratic terms in ascending b with 2 x_j at
// b = j, the input terms). The operator is staged transposed in shared
// memory with odd row stride r | 1, so that both access patterns are free
// of bank conflicts; where it does not fit (r 46 and up at nu 2), each
// block copies it into device scratch in the same layout and the
// right-hand side reads Ohat's rows (a second instance of the kernel, so
// that the staged one reads shared memory by its own instructions). For r
// <= 32 warp 0 alone solves the Newton system, lane i holding row i and
// F[i] in registers (wide_solve_warp, 8, 16 or 32 columns): each pivot's
// row shuffled from its lane as it is used, solve_small's operations, and
// the back substitution by columns: lane i divides its remainder by M[i][i]
// (div_rn), a shuffle hands dk[i] to the warp, and every lane subtracts
// M[k][i] dk[i] from its own, so no lane runs the substitution alone.
// Above r = 32 the block eliminates in shared memory (warps over the rows
// below the pivot, lanes over its columns, one barrier a pivot) and warp 0
// back-substitutes by columns. A draw whose state turns NaN stops and
// reports NaN, as in the runtime kernel. The order of summation differs
// from the other families' (the back substitution subtracts in descending
// column order), so flags and err_sq agree with them within float32
// roundoff, not to the bit.

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

// ---------------------------------------------------------------------------
// The capacity-templated kernel (the capacity layout of screen_common.cuh):
// r <= RCAP and nu <= NUCAP at run time, RCAP 12 and 16, NUCAP 4.

// Capacity column offsets of the "cAHBN" operator blocks.
template <int RCAP, int NUCAP>
struct CapLayout {
  static constexpr int kH = 1 + RCAP;
  static constexpr int kB = kH + RCAP * (RCAP + 1) / 2;
  static constexpr int kN = kB + NUCAP;
  static constexpr int kD = kN + NUCAP * RCAP;  // columns
};

// The quadratic terms of blocks A, A + 1, ... (block a: the terms a, b for
// b <= a) of this lane's row, added to acc in order while a < r; `cur`
// holds block A's coefficients. Block A + 1's coefficients are loaded
// before block A is summed, so the chain of multiply-adds does not wait on
// shared memory; the blocks nest, so one branch skips all blocks from r
// on.
template <int RCAP, int NUCAP, int A>
__device__ __forceinline__ void quad_blocks(const float* __restrict__ t, const float (&x)[RCAP],
                                            int r, const float (&cur)[A + 1], float& acc) {
  constexpr int H = CapLayout<RCAP, NUCAP>::kH;
  const float xa = x[A];
  if constexpr (A + 1 < RCAP) {
    float nxt[A + 2];
#pragma unroll
    for (int b = 0; b <= A + 1; ++b) nxt[b] = t[(H + (A + 1) * (A + 2) / 2 + b) * RCAP];
#pragma unroll
    for (int b = 0; b <= A; ++b) acc += cur[b] * (xa * x[b]);
    if (A + 1 < r) quad_blocks<RCAP, NUCAP, A + 1>(t, x, r, nxt, acc);
  } else {
#pragma unroll
    for (int b = 0; b <= A; ++b) acc += cur[b] * (xa * x[b]);
  }
}

// This lane's row of rhs(x, u) at run-time (r, nu), in the order of
// rhs_any; column c of the row at t[c RCAP]. The linear and input terms
// are predicated on the true dimensions, the quadratic blocks nested
// (quad_blocks).
template <int RCAP, int NUCAP>
__device__ __forceinline__ float rhs_cap(const float* __restrict__ t, const float (&x)[RCAP],
                                         const float (&u)[NUCAP], int r, int nu) {
  using C = CapLayout<RCAP, NUCAP>;
  float lin[RCAP], cur[1];
#pragma unroll
  for (int a = 0; a < RCAP; ++a) lin[a] = t[(1 + a) * RCAP];
  cur[0] = t[C::kH * RCAP];
  float acc = t[0];
#pragma unroll
  for (int a = 0; a < RCAP; ++a)
    if (a < r) acc += lin[a] * x[a];
  quad_blocks<RCAP, NUCAP, 0>(t, x, r, cur, acc);
#pragma unroll
  for (int e = 0; e < NUCAP; ++e) {
    if (e < nu) {
      float cn[RCAP];
#pragma unroll
      for (int a = 0; a < RCAP; ++a) cn[a] = t[(C::kN + e * RCAP + a) * RCAP];
      const float ue = u[e];
      acc += t[(C::kB + e) * RCAP] * ue;
#pragma unroll
      for (int a = 0; a < RCAP; ++a)
        if (a < r) acc += cn[a] * (ue * x[a]);
    }
  }
  return acc;
}

// This lane's row `row` of M = I - hg J(x, u), each column j < r in the
// order of newton_row_any. Every capacity column is formed, so the RCAP
// independent chains interleave with no branch between them; a column j >=
// r sums zero coefficients (NaN where an x is infinite) and is never read:
// eliminate_cap's back substitution reads m[j] only for j < r.
template <int RCAP, int NUCAP>
__device__ __forceinline__ void newton_row_cap(const float* __restrict__ t,
                                               const float (&x)[RCAP], const float (&u)[NUCAP],
                                               float hg, int r, int nu, int row,
                                               float (&m)[RCAP]) {
  using C = CapLayout<RCAP, NUCAP>;
#pragma unroll
  for (int j = 0; j < RCAP; ++j) {
    constexpr int H = C::kH;
    const int zj = H + j * (j + 1) / 2;
    float col = t[(1 + j) * RCAP];
#pragma unroll
    for (int b = 0; b <= j; ++b) col += t[(zj + b) * RCAP] * x[b];
    col += t[(zj + j) * RCAP] * x[j];
#pragma unroll
    for (int a = j + 1; a < RCAP; ++a)
      if (a < r) col += t[(H + a * (a + 1) / 2 + j) * RCAP] * x[a];
#pragma unroll
    for (int e = 0; e < NUCAP; ++e)
      if (e < nu) col += t[(C::kN + e * RCAP + j) * RCAP] * u[e];
    m[j] = (row == j ? 1.f : 0.f) - hg * col;
  }
}

// Solve M dk = F in the operation order of eliminate_any, without shared
// memory or branches that split the warp: lane i < r holds its row m =
// M[i, :] and f = F[i] in registers. For each pivot p, row p and F[p] are
// broadcast by shuffles, every lane forms inv = 1 / M[p][p] itself, and
// each lane i > p keeps its update of its own row, entry by entry (the
// other lanes compute it and select their old values). The back
// substitution keeps dk replicated: every lane sums its own row in
// ascending j, lane i's sum is divided (the others divide 0 by 1, off the
// IEEE division's slow path), and a shuffle hands dk[i] to every lane.
// Entries j >= r of the rows are updated but never read.
template <int RCAP>
__device__ __forceinline__ void eliminate_cap(float (&m)[RCAP], float f, int r,
                                              float (&dk)[RCAP]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int p = 0; p < RCAP; ++p) {
    if (p >= r) break;
    float mp[RCAP];
#pragma unroll
    for (int j = p; j < RCAP; ++j) mp[j] = __shfl_sync(kFullMask, m[j], p);
    const float fp = __shfl_sync(kFullMask, f, p);
    const float inv = 1.f / mp[p];
    const bool below = lane > p && lane < r;
    const float fac = m[p] * inv;
#pragma unroll
    for (int j = p + 1; j < RCAP; ++j) {
      const float v = m[j] - fac * mp[j];
      m[j] = below ? v : m[j];
    }
    const float fv = f - fac * fp;
    f = below ? fv : f;
  }
#pragma unroll
  for (int i = RCAP - 1; i >= 0; --i) {
    dk[i] = 0.f;
    if (i < r) {
      float acc = f;
#pragma unroll
      for (int j = i + 1; j < RCAP; ++j)
        if (j < r) acc = acc - m[j] * dk[j];
      const bool me = lane == i;
      const float v = div_rn(me ? acc : 0.f, me ? m[i] : 1.f);
      dk[i] = __shfl_sync(kFullMask, v, i);
    }
  }
}

template <int NUCAP>
__device__ __forceinline__ void load_inputs_cap(const float* __restrict__ u_row, int nu,
                                                float (&u)[NUCAP]) {
#pragma unroll
  for (int e = 0; e < NUCAP; ++e) u[e] = e < nu ? __ldg(u_row + e) : 0.f;
}

// Block (n, l) integrates draw n of problem l; lane i < r owns row i, and
// the state, the stage slopes and the Newton iterate are replicated.
template <int RCAP, int NUCAP>
__global__ void __launch_bounds__(32)
cahbn_screen_cap_kernel(const float* __restrict__ Ohat,      // (N, r, d)
                        const float* __restrict__ q0,        // (L, r)
                        const float* __restrict__ t_eval,    // (k,)
                        const float* __restrict__ u_stages,  // (L, (k-1) substeps 3, nu)
                        const float* __restrict__ shift,     // (L, r)
                        const float* __restrict__ limits,    // (L, r)
                        int r, int nu, int d, int N, int k, int substeps, int newton_iters,
                        bool* __restrict__ stable,           // (L, N)
                        float* __restrict__ partial) {       // (L, N, k, r) or null
  using C = CapLayout<RCAP, NUCAP>;
  extern __shared__ float T[];  // (C::kD, RCAP)
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const int row = lane % RCAP;
  const bool mine = lane < r;
  const int hr = 1 + r, br = hr + r * (r + 1) / 2, nr = br + nu;
  stage_capacity<RCAP>(Ohat, n, r, d, C::kD,
                       [=](int z) {
                         if (z < hr) return z;
                         if (z < br) return z - hr + C::kH;
                         if (z < nr) return z - br + C::kB;
                         const int e = (z - nr) / r;
                         return C::kN + e * RCAP + (z - nr - e * r);
                       },
                       T);
  __syncwarp();
  const float* t = T + row;
  const float* u_p = u_stages + static_cast<size_t>(l) * (k - 1) * substeps * 3 * nu;
  float* part = partial == nullptr ? nullptr
                                   : partial + (static_cast<size_t>(l) * N + n) * k * r;
  float q[RCAP];
#pragma unroll
  for (int j = 0; j < RCAP; ++j) q[j] = j < r ? q0[l * r + j] : 0.f;
  float sh = 0.f, maxdev = 0.f;
  if (mine) {
    sh = shift[l * r + lane];
    maxdev = fabsf(own<RCAP>(q, lane) - sh);
    if (part != nullptr) part[lane] = own<RCAP>(q, lane);
  }

  float u[NUCAP], kk[RCAP], k1[RCAP], base[RCAP];
  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hg = h * kGamma;
    const float h1 = h * kOneMinusGamma;
    for (int sub = 0; sub < substeps; ++sub) {
      const float* u0 = u_p + static_cast<size_t>((s - 1) * substeps + sub) * 3 * nu;
      load_inputs_cap<NUCAP>(u0, nu, u);
      gather_lanes<RCAP>(rhs_cap<RCAP, NUCAP>(t, q, u, r, nu), kk);
#pragma unroll
      for (int j = 0; j < RCAP; ++j) base[j] = q[j];
      // Stage 1 Newton-solves k1 from the guess rhs(q), stage 2 k2 from k1.
#pragma unroll 1
      for (int stage = 0; stage < 2; ++stage) {
        load_inputs_cap<NUCAP>(u0 + (1 + stage) * nu, nu, u);
#pragma unroll 1
        for (int it = 0; it < newton_iters; ++it) {
          float x[RCAP], m[RCAP], dk[RCAP];
#pragma unroll
          for (int j = 0; j < RCAP; ++j) x[j] = base[j] + hg * kk[j];
          const float F = own<RCAP>(kk, row) - rhs_cap<RCAP, NUCAP>(t, x, u, r, nu);
          newton_row_cap<RCAP, NUCAP>(t, x, u, hg, r, nu, row, m);
          eliminate_cap<RCAP>(m, F, r, dk);
#pragma unroll
          for (int j = 0; j < RCAP; ++j) kk[j] = kk[j] - dk[j];
        }
        if (stage == 0) {
#pragma unroll
          for (int j = 0; j < RCAP; ++j) {
            k1[j] = kk[j];
            base[j] = q[j] + h1 * k1[j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RCAP; ++j)
        q[j] = clip_keep_nan(q[j] + h * (kOneMinusGamma * k1[j] + kGamma * kk[j]));
    }
    bool nan_now = false;
    if (mine) {
      const float qi = own<RCAP>(q, lane);
      maxdev = max_keep_nan(maxdev, fabsf(qi - sh));
      if (part != nullptr) part[static_cast<size_t>(s) * r + lane] = qi;
      nan_now = isnan(qi);
    }
    // A NaN reaches every row of the next right-hand side and stays: the
    // draw reports NaN from here on.
    if (__any_sync(kFullMask, nan_now)) {
      const float nan = __int_as_float(0x7fc00000);
      if (mine) {
        maxdev = nan;
        if (part != nullptr)
          for (int t2 = s + 1; t2 < k; ++t2) part[static_cast<size_t>(t2) * r + lane] = nan;
      }
      break;
    }
  }

  const bool ok = !mine || ((maxdev <= limits[l * r + lane]) && isfinite(maxdev));
  const bool all = __all_sync(kFullMask, ok);
  if (lane == 0) stable[static_cast<size_t>(l) * N + n] = all;
}

template <int RCAP, int NUCAP>
cudaError_t launch_cap(const float* Ohat, const float* q0, const float* t_eval,
                       const float* u_stages, const float* shift, const float* limits, int L,
                       int N, int r, int nu, int k, int substeps, int newton_iters, bool* stable,
                       float* partial, cudaStream_t stream) {
  const int d = 1 + r + r * (r + 1) / 2 + nu + nu * r;
  const size_t bytes = static_cast<size_t>(CapLayout<RCAP, NUCAP>::kD) * RCAP * sizeof(float);
  cahbn_screen_cap_kernel<RCAP, NUCAP><<<dim3(N, L), 32, bytes, stream>>>(
      Ohat, q0, t_eval, u_stages, shift, limits, r, nu, d, N, k, substeps, newton_iters, stable,
      partial);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide kernel (the wide layout of screen_common.cuh): any (r, nu), the
// path beyond the capacity kernel's r 16 and nu 4.

constexpr int kWideWarps = 8;     // the most warps a draw's block takes
constexpr int kWideFeatures = 8;  // features a thread forms from pair codes in registers

// The right-hand side of the features, row by row: warp w takes rows w,
// w + nw, ..., four at a time, lane j the columns j + 32 t (ascending t) of
// each, read at rv[i si + c sc]; the four sums by warp_sums, then out(i,
// sum) in lane 0. All four rows' loads come before any store.
template <class Out>
__device__ __forceinline__ void wide_rhs(const float* __restrict__ rv, int si, int sc,
                                         const WideSmem& S, int r, int d, Out out) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int Q = (d + 31) / 32;
  for (int i = threadIdx.x >> 5; i < r; i += 4 * nw) {
    int row[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) row[u] = i + u * nw < r ? i + u * nw : i;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int t = 0; t < Q; ++t) {
      const int c = 32 * t + lane;
      const float f = S.f(c);
      const size_t o = static_cast<size_t>(c) * sc;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += (c < d ? rv[static_cast<size_t>(row[u]) * si + o] : 0.f) * f;
    }
    warp_sums<4>(acc);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u == 0 || row[u] != i) out(row[u], acc[u]);
    }
  }
}

// Columns j of the Newton matrix M = I - hg J(x, u) (rows of stride ms),
// warp w taking columns w, w + nw, ... four at a time, lane i row i + 32 a.
// Column c of row i is read at T[c rs + i]. J[i, j] = A[i, j], then the
// quadratic terms H[i, (max(j, b), min(j, b))] x_b in ascending b (2 x_j
// at b = j: both factors of x_j^2), then N[i, e r + j] u_e in ascending e.
__device__ __forceinline__ void wide_newton_matrix(const float* __restrict__ T, int rs,
                                                   const float* __restrict__ x,
                                                   const float* __restrict__ u, float hg, int r,
                                                   int nu, float* __restrict__ M, int ms) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int kH = 1 + r;
  const int kN = kH + r * (r + 1) / 2 + nu;
  for (int j0 = threadIdx.x >> 5; j0 < r; j0 += 4 * nw) {
    int j[4], z[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      j[v] = j0 + v * nw < r ? j0 + v * nw : j0;  // a column past r repeats j0
      z[v] = kH + j[v] * (j[v] + 1) / 2;
    }
    for (int i = lane; i < r; i += 32) {
      const float* ti = T + i;
      float col[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) col[v] = ti[(1 + j[v]) * rs];
      int tri = kH;  // kH + b (b + 1) / 2
#pragma unroll 2
      for (int b = 0; b < r; ++b) {
        const float xb = x[b];
        float c[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) c[v] = ti[(b <= j[v] ? z[v] + b : tri + j[v]) * rs];
#pragma unroll
        for (int v = 0; v < 4; ++v) col[v] += c[v] * (b == j[v] ? 2.f * xb : xb);
        tri += b + 1;
      }
      for (int e = 0; e < nu; ++e) {
        const float ue = u[e];
#pragma unroll
        for (int v = 0; v < 4; ++v) col[v] += ti[(kN + e * r + j[v]) * rs] * ue;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) M[i * ms + j[v]] = (i == j[v] ? 1.f : 0.f) - hg * col[v];
    }
  }
}

// Solve M dk = F (F stored as column r of M) for r <= C (8, 16 or 32) in
// warp 0 alone, lane i holding row i and F[i] in registers: the
// elimination without pivoting in solve_small's operations (for each pivot
// p, the entries of row p and F[p] shuffled from lane p as they are used;
// every lane forms inv = 1 / M[p][p] and the lanes below p update their
// own rows, f = M[i][p] inv, M[i][j] - f M[p][j], the others keeping
// theirs); then the back substitution by columns: lane i divides its
// remainder by M[i][i] (IEEE, div_rn; the others divide 0 by 1), a
// shuffle hands dk[i] to the warp, and every lane k < i subtracts M[k][i]
// dk[i] from its own. dk goes to dks.
template <int C>
__device__ __forceinline__ void wide_solve_warp(const float* __restrict__ M, int ms, int r,
                                                float* __restrict__ dks) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < r;
  float m[C];
#pragma unroll
  for (int j = 0; j < C; ++j) m[j] = mine && j < r ? M[lane * ms + j] : 0.f;
  float f = mine ? M[lane * ms + r] : 0.f;
#pragma unroll
  for (int p = 0; p < C; ++p) {
    if (p >= r) break;
    const float inv = 1.f / __shfl_sync(kFullMask, m[p], p);
    const float fp = __shfl_sync(kFullMask, f, p);
    const bool below = lane > p && mine;
    const float fac = m[p] * inv;
#pragma unroll
    for (int j = p + 1; j < C; ++j) {
      const float v = m[j] - fac * __shfl_sync(kFullMask, m[j], p);
      m[j] = below ? v : m[j];
    }
    const float fv = f - fac * fp;
    f = below ? fv : f;
  }
  float diag = m[0];
#pragma unroll
  for (int j = 1; j < C; ++j) diag = lane == j ? m[j] : diag;
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    if (i < r) {
      const bool me = lane == i;
      const float di = __shfl_sync(kFullMask, div_rn(me ? f : 0.f, me ? diag : 1.f), i);
      if (me) dks[i] = di;
      const float v = f - m[i] * di;
      f = lane < i ? v : f;
    }
  }
}

// The same for any r, by the whole block: the rows below the pivot over
// the warps, four at a time (their loads before their stores), and the
// columns over the lanes, one barrier a pivot; then the back substitution
// by columns in warp 0, lane i % 32 dividing row i's remainder (rows below
// 32 in a register, the others in M's column r).
__device__ __forceinline__ void wide_solve_block(float* __restrict__ M, int ms, int r,
                                                 float* __restrict__ dks) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int p = 0; p < r; ++p) {
    const float inv = 1.f / M[p * ms + p];
    const float* prow = M + p * ms;
    for (int i = p + 1 + w; i < r; i += 4 * nw) {
      int row[4];
      float f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        row[u] = i + u * nw < r ? i + u * nw : -1;
        f[u] = row[u] >= 0 ? M[row[u] * ms + p] * inv : 0.f;
      }
      for (int j = p + 1 + lane; j <= r; j += 32) {
        const float pj = prow[j];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = row[u] >= 0 ? M[row[u] * ms + j] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (row[u] >= 0) M[row[u] * ms + j] = v[u] - f[u] * pj;
      }
    }
    __syncthreads();
  }
  if (w == 0) {
    float f0 = lane < r ? M[lane * ms + r] : 0.f;
    for (int i = r - 1; i >= 0; --i) {
      const int owner = i & 31;
      const bool me = lane == owner;
      const float num = i < 32 ? f0 : M[i * ms + r];
      const float di =
          __shfl_sync(kFullMask, div_rn(me ? num : 0.f, me ? M[i * ms + i] : 1.f), owner);
      if (me) dks[i] = di;
      if (lane < i) f0 = f0 - M[lane * ms + i] * di;
      for (int k2 = 32 + lane; k2 < i; k2 += 32)
        M[k2 * ms + r] = M[k2 * ms + r] - M[k2 * ms + i] * di;
    }
  }
}

// Block (n, l) integrates draw n of problem l with nw warps. kStaged: the
// operator is staged transposed in shared memory (column c of row i at
// T[c rs + i], rs = r | 1, so that both the lanes' columns of a row and
// the lanes' rows of a column fall in distinct banks); else it is copied
// in that layout into `scratch`, the block's (d, rs) slice of device
// memory, and the right-hand side reads the rows of Ohat itself.
template <bool kStaged>
__global__ void __launch_bounds__(kWideWarps * 32)
cahbn_screen_wide_kernel(const float* __restrict__ Ohat,      // (N, r, d)
                         const float* __restrict__ q0,        // (L, r)
                         const float* __restrict__ t_eval,    // (k,)
                         const float* __restrict__ u_stages,  // (L, (k-1) substeps 3, nu)
                         const float* __restrict__ shift,     // (L, r)
                         const float* __restrict__ limits,    // (L, r)
                         int r, int nu, int d, int N, int k, int substeps, int newton_iters,
                         float* __restrict__ scratch,         // (L, N, d, rs), unless kStaged
                         bool* __restrict__ stable,           // (L, N)
                         float* __restrict__ partial) {       // (L, N, k, r) or null
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n = blockIdx.x;
  const int l = blockIdx.y;
  const int rs = r | 1;
  const int ms = (r + 1) | 1;
  const WideSmem S(smem, r, d, WideSmem::chunks(d), nu, 7);
  float* const xs = S.xe;  // the state the features are formed of, then 1, then u
  float* const us = S.xe + r + 1;
  float* const q = S.vec(0);
  float* const k1 = S.vec(1);
  float* const kk = S.vec(2);
  float* const base = S.vec(3);
  float* const dks = S.vec(4);
  float* const mds = S.vec(5);
  float* const shs = S.vec(6);
  float* const M = S.tail;  // (r, ms): the Newton matrix, F as column r
  float* const T = kStaged ? M + r * ms : scratch + (static_cast<size_t>(l) * N + n) * d * rs;
  const float* op = Ohat + static_cast<size_t>(n) * r * d;
  S.init(tid, nt, d, WideSmem::chunks(d), nu);
  for (int e = tid; e < r * d; e += nt) {
    const int i = e / d;
    T[static_cast<size_t>(e - i * d) * rs + i] = __ldg(op + e);
  }
  // The right-hand side's view of row i, column c: rv[i si + c sc].
  const float* rv = kStaged ? T : op;
  const int si = kStaged ? 1 : d, sc = kStaged ? rs : 1;
  const float* u_p = u_stages + static_cast<size_t>(l) * (k - 1) * substeps * 3 * nu;
  float* part = partial == nullptr ? nullptr
                                   : partial + (static_cast<size_t>(l) * N + n) * k * r;
  for (int i = tid; i < r; i += nt) {
    q[i] = q0[l * r + i];
    shs[i] = shift[l * r + i];
    mds[i] = fabsf(q[i] - shs[i]);
    if (part != nullptr) part[i] = q[i];
  }
  __syncthreads();
  FeatureCache<kWideFeatures> fc;
  fc.load(S, tid, nt, d);

  // Newton-solve kv = rhs(bv + hg kv, u) from the guess in kv; thread tid
  // owns entries tid, tid + nt, ... of the r-vectors, as everywhere below.
  auto newton = [&](const float* bv, float* kv, const float* u_row, float hg) {
    for (int e = tid; e < nu; e += nt) us[e] = __ldg(u_row + e);
    for (int it = 0; it < newton_iters; ++it) {
      for (int i = tid; i < r; i += nt) xs[i] = bv[i] + hg * kv[i];
      __syncthreads();
      fc.form(S, tid, nt, d);
      __syncthreads();
      wide_rhs(rv, si, sc, S, r, d, [&](int i, float v) { M[i * ms + r] = kv[i] - v; });
      wide_newton_matrix(T, rs, xs, us, hg, r, nu, M, ms);
      __syncthreads();
      if (r <= 32) {
        if (tid < 32) {
          if (r <= 8)
            wide_solve_warp<8>(M, ms, r, dks);
          else if (r <= 16)
            wide_solve_warp<16>(M, ms, r, dks);
          else
            wide_solve_warp<32>(M, ms, r, dks);
        }
      } else {
        wide_solve_block(M, ms, r, dks);
      }
      __syncthreads();
      for (int i = tid; i < r; i += nt) kv[i] = kv[i] - dks[i];
    }
  };

  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hg = h * kGamma;
    const float h1 = h * kOneMinusGamma;
    for (int sub = 0; sub < substeps; ++sub) {
      const float* u0 = u_p + static_cast<size_t>((s - 1) * substeps + sub) * 3 * nu;
      // k1's guess rhs(q, u0); stage 1 Newton-solves k1, stage 2 k2 from k1.
      for (int e = tid; e < nu; e += nt) us[e] = __ldg(u0 + e);
      for (int i = tid; i < r; i += nt) xs[i] = q[i];
      __syncthreads();
      fc.form(S, tid, nt, d);
      __syncthreads();
      wide_rhs(rv, si, sc, S, r, d, [&](int i, float v) { k1[i] = v; });
      __syncthreads();
      newton(q, k1, u0 + nu, hg);
      for (int i = tid; i < r; i += nt) {
        base[i] = q[i] + h1 * k1[i];
        kk[i] = k1[i];
      }
      newton(base, kk, u0 + 2 * nu, hg);
      for (int i = tid; i < r; i += nt)
        q[i] = clip_keep_nan(q[i] + h * (kOneMinusGamma * k1[i] + kGamma * kk[i]));
    }
    bool nan_now = false;
    for (int i = tid; i < r; i += nt) {
      mds[i] = max_keep_nan(mds[i], fabsf(q[i] - shs[i]));
      if (part != nullptr) part[static_cast<size_t>(s) * r + i] = q[i];
      nan_now = nan_now || isnan(q[i]);
    }
    // A NaN reaches every row of the next right-hand side and stays: the
    // draw reports NaN from here on.
    if (__syncthreads_or(nan_now)) {
      const float nan = __int_as_float(0x7fc00000);
      for (int i = tid; i < r; i += nt) {
        mds[i] = nan;
        if (part != nullptr)
          for (int t = s + 1; t < k; ++t) part[static_cast<size_t>(t) * r + i] = nan;
      }
      break;
    }
  }

  bool ok = true;
  for (int i = tid; i < r; i += nt)
    ok = ok && (mds[i] <= limits[l * r + i]) && isfinite(mds[i]);
  ok = __syncthreads_and(ok);
  if (tid == 0) stable[static_cast<size_t>(l) * N + n] = ok;
}

// The wide kernel's shared memory without the operator, and the floats
// of device scratch a block needs when the operator does not fit beside
// it (0 when it does).
size_t wide_base_bytes(int r, int nu, int d) {
  return WideSmem::bytes(r, d, WideSmem::chunks(d), nu, 7) + sizeof(float) * r * ((r + 1) | 1);
}

size_t wide_scratch_floats(int r, int nu) {
  const int d = 1 + r + r * (r + 1) / 2 + nu + nu * r;
  const size_t op = sizeof(float) * d * (r | 1);
  return wide_base_bytes(r, nu, d) + op <= static_cast<size_t>(kMaxDynamicShared)
             ? 0
             : static_cast<size_t>(d) * (r | 1);
}

cudaError_t launch_wide(const float* Ohat, const float* q0, const float* t_eval,
                        const float* u_stages, const float* shift, const float* limits, int L,
                        int N, int r, int nu, int k, int substeps, int newton_iters,
                        float* scratch, bool* stable, float* partial, cudaStream_t stream) {
  const int d = 1 + r + r * (r + 1) / 2 + nu + nu * r;
  const bool staged = wide_scratch_floats(r, nu) == 0;
  if (!staged && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t bytes =
      wide_base_bytes(r, nu, d) + (staged ? sizeof(float) * d * (r | 1) : 0);
  int nw = (r + 3) / 4;
  nw = nw < kWideWarps ? nw : kWideWarps;
  auto kernel = staged ? cahbn_screen_wide_kernel<true> : cahbn_screen_wide_kernel<false>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (rc != cudaSuccess) return rc;
  kernel<<<dim3(N, L), 32 * nw, bytes, stream>>>(Ohat, q0, t_eval, u_stages, shift, limits, r,
                                                 nu, d, N, k, substeps, newton_iters, scratch,
                                                 stable, partial);
  return cudaGetLastError();
}

// The four families, as the wrapper names them (ops/cahbn_screen.py).
constexpr int kTemplated = 0;  // r <= 8, nu <= 2: cahbn_screen_kernel<R, NU>
constexpr int kCapacity = 1;   // r <= 16, nu <= 4: cahbn_screen_cap_kernel<12 or 16, 4>
constexpr int kRuntime = 2;    // any r and nu: cahbn_screen_any_kernel
constexpr int kWide = 3;       // any r and nu: cahbn_screen_wide_kernel
constexpr int kTemplatedMaxR = 8;  // the reference's SMALL_SOLVE_MAX
constexpr int kTemplatedMaxNu = 2;
constexpr int kCapacityMaxR = 16;
constexpr int kCapacityMaxNu = 4;

}  // namespace

// Floats of device scratch that each (problem, draw) block of the wide
// kernel (family 3) needs at (r, nu): 0 where the draw's operator fits in
// its shared memory, else d (r | 1). The wrapper passes L N times that as
// `scratch` to gpboi_cahbn_screen.
extern "C" long long gpboi_cahbn_wide_scratch(int r, int nu) {
  return r < 1 || nu < 1 ? 0 : static_cast<long long>(wide_scratch_floats(r, nu));
}

// Screens L problems in one launch with the kernel of `family` (0: the
// templated instances, r <= 8 with nu <= 2; 1: the capacity-templated
// kernel, r <= 16 with nu <= 4, its capacity 12 or 16 chosen by r; 2: the
// runtime-(r, nu) kernel, any r and nu; 3: the wide kernel, any r and
// nu, with `scratch` as gpboi_cahbn_wide_scratch says, else null). The
// wrapper chooses the family by (r, nu) and can force one. `partial` is
// scratch of L * G * W * k * r floats, W = warps_per_candidate(r, nd) for
// the templated instances and W = nd for the others (the wrapper passes
// W, and it is checked); with `snaps` (L, r, k) non-null the draw means'
// squared errors go to err_sq (L, G), else partial and err_sq are not
// touched. Returns 0 on success, a cudaError_t code if a launch failed,
// -1 for r < 1 or nu < 1 and -2 for a family that does not take (r, nu).
extern "C" int gpboi_cahbn_screen(const float* Ohat, const float* q0, const float* t_eval,
                                  const float* u_stages, const float* shift,
                                  const float* limits, const float* snaps, int L, int N, int r,
                                  int nu, int nd, int W, int k, int substeps, int newton_iters,
                                  int family, bool* stable, float* partial, float* err_sq,
                                  float* scratch, void* stream) {
  if (r < 1 || nu < 1) return -1;
  if (family < kTemplated || family > kWide ||
      (family == kTemplated && (r > kTemplatedMaxR || nu > kTemplatedMaxNu)) ||
      (family == kCapacity && (r > kCapacityMaxR || nu > kCapacityMaxNu)))
    return -2;
  if (L < 1 || L > 65535 || N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 ||
      substeps < 1 || newton_iters < 0 ||
      W != (family == kTemplated ? warps_per_candidate(r, nd) : nd) ||
      (snaps != nullptr && (partial == nullptr || err_sq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = snaps != nullptr ? partial : nullptr;
  int rc;
  if (family == kWide)
    rc = static_cast<int>(launch_wide(Ohat, q0, t_eval, u_stages, shift, limits, L, N, r, nu, k,
                                      substeps, newton_iters, scratch, stable, part, s));
  else if (family == kRuntime)
    rc = static_cast<int>(launch_any(Ohat, q0, t_eval, u_stages, shift, limits, L, N, r, nu, k,
                                     substeps, newton_iters, stable, part, s));
  else if (family == kCapacity)
    rc = static_cast<int>(
        r <= 12 ? launch_cap<12, kCapacityMaxNu>(Ohat, q0, t_eval, u_stages, shift, limits, L, N,
                                                 r, nu, k, substeps, newton_iters, stable, part, s)
                : launch_cap<16, kCapacityMaxNu>(Ohat, q0, t_eval, u_stages, shift, limits, L, N,
                                                 r, nu, k, substeps, newton_iters, stable, part,
                                                 s));
  else
    rc = nu == 1 ? launch_r<1>(r, Ohat, q0, t_eval, u_stages, shift, limits, L, N, nd, W, k,
                               substeps, newton_iters, stable, part, s)
                 : launch_r<2>(r, Ohat, q0, t_eval, u_stages, shift, limits, L, N, nd, W, k,
                               substeps, newton_iters, stable, part, s);
  if (rc != 0 || snaps == nullptr) return rc;
  mean_error_kernel<<<dim3(N / nd, L), 32, 0, s>>>(partial, snaps, r, N / nd, W, k, nd, err_sq);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fused SDIRK2 integration of "cAHBN" ROM posterior draws, in float64
// (ops/cahbn_dirk2.py; rom/model.py::GalerkinROM.predict takes it on the
// card in place of solve/ivp.py::dirk2_solve's loop of small launches).
//
// What it computes: for B = P * D draws, each with its own (r, d) operator
// and initial state, draw b reading the inputs of problem b / D, exactly
// dirk2_solve's scheme: per substep of step h = hs[s - 1],
//   k1 = stage(j + 1, q, rhs(j, q)), k2 = stage(j + 2, q + h (1 - gamma) k1, k1),
//   q = clamp(q + h ((1 - gamma) k1 + gamma k2), +-clamp),
// each stage `newton_iters` full Newton steps k -= (I - h gamma J(x))^-1
// (k - rhs(x)) at x = base + h gamma k, with no early stop; the inputs come
// from u_stages, the table of ops/cahbn_screen.py::input_stage_times, row
// j = 3 (i substeps + s) + {0, 1, 2}. Every state at t_eval is written,
// column 0 the initial state; no flag or error (the stability masks stay in
// PyTorch). Each elementwise step rounds as dirk2_solve's tensor operations
// do (__dmul_rn, __dadd_rn: no contraction across them); the right-hand side
// forms each quadratic and bilinear feature as rom_rhs does and sums the row
// by multiply-adds in column order; the Jacobian row is A + the quadratic
// terms + the input terms, as rom_rhs_jacobian adds its blocks; the Newton
// system is solved in solve/ivp.py::solve_small's order, without pivoting
// (the matrices are near the identity), where dirk2_solve takes
// torch.linalg.solve_ex's pivoted LU: the two agree to float64 roundoff, not
// to the bit. Divisions and reciprocals are IEEE (no fast math).
//
// What bounds it: the dependent chain, as in kernel B. Heat ex3's ensemble
// (5 x 600 draws, r 5, nu 2, k 500, 4 substeps) is 1,996 substeps of 12
// Newton steps, ~70 GFLOP of float64 in all: ~2 ms of the card's float64
// rate, against a chain of 23,952 Newton steps. The design is kernel B's
// templated layout in float64: a draw takes a group of 8 lanes at r 5 (the
// power of two >= r), lane i owning row i's d coefficients in registers
// (33 doubles at r 5, nu 2), loaded once before the time loop (one thread a
// draw would need 5 x 33 doubles of coefficients alone); the state vectors
// are replicated in the group; the Newton matrix's rows are all-gathered by
// shuffles and every lane runs the elimination. A draw whose state turns
// NaN writes it, stays NaN and integrates zeros from then on (no slow paths
// of NaN operands); the shuffles never leave a draw's group, so the other
// draws keep their bits. All P problems go in one launch (blockIdx.y).

namespace {

constexpr double kOneMinusGammaD = 1.0 - kGammaD;

template <int R>
__device__ __forceinline__ void all_gather_d(double v, double (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = __shfl_sync(kFullMask, v, j, Rows<R>::kLanes);
}

template <int R>
__device__ __forceinline__ double own_d(const double (&x)[R], int row) {
  double v = x[0];
#pragma unroll
  for (int j = 1; j < R; ++j) v = row == j ? x[j] : v;
  return v;
}

// a / b, rounded as the IEEE division is. A zero numerator over a finite
// nonzero b, which every back substitution meets once Newton has converged
// to the bit (and a NaN draw's zeroed system always), returns the signed
// zero directly instead of taking the division's slow path.
__device__ __forceinline__ double ddiv_rn(double a, double b) {
  const bool zero = a == 0.0 && b != 0.0 && isfinite(b);
  double num = zero ? 1.0 : a;
#ifdef __CUDA_ARCH__
  asm("" : "+d"(num));
#endif
  const double q = num / b;
  return zero ? __longlong_as_double((__double_as_longlong(a) ^ __double_as_longlong(b)) &
                                     static_cast<long long>(0x8000000000000000ULL))
              : q;
}

// This lane's row of rom_rhs: the features [1, q, q_a q_b (b <= a), u,
// u_e q_a] each rounded, then the dot product in column order.
template <int R, int NU>
__device__ __forceinline__ double dirk2_rhs_row(const double (&c)[Layout<R, NU>::kD],
                                                const double (&q)[R], const double (&u)[NU]) {
  using L = Layout<R, NU>;
  double acc = c[0];
#pragma unroll
  for (int a = 0; a < R; ++a) acc = fma(c[1 + a], q[a], acc);
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) acc = fma(c[L::kH + a * (a + 1) / 2 + b], __dmul_rn(q[a], q[b]), acc);
  }
#pragma unroll
  for (int e = 0; e < NU; ++e) acc = fma(c[L::kB + e], u[e], acc);
#pragma unroll
  for (int e = 0; e < NU; ++e) {
#pragma unroll
    for (int a = 0; a < R; ++a) acc = fma(c[L::kN + e * R + a], __dmul_rn(u[e], q[a]), acc);
  }
  return acc;
}

// Row `row` of I - hg J(x, u): J[row, j] = (A[row, j] + sum_z H[row, z]
// d ckron(x)_z / dx_j) + sum_e N[row, e r + j] u_e, the derivative of x_a x_b
// being x_b at j = a, x_a at j = b and x_j + x_j at a = b = j.
template <int R, int NU>
__device__ __forceinline__ void dirk2_newton_row(const double (&c)[Layout<R, NU>::kD],
                                                 const double (&x)[R], const double (&u)[NU],
                                                 double hg, int row, double (&m)[R]) {
  using L = Layout<R, NU>;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    double quad = 0.0;
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const double h = c[L::kH + a * (a + 1) / 2 + b];
        if (a == j && b == j) quad = fma(h, __dadd_rn(x[j], x[j]), quad);
        else if (a == j) quad = fma(h, x[b], quad);
        else if (b == j) quad = fma(h, x[a], quad);
      }
    }
    double lin = 0.0;
#pragma unroll
    for (int e = 0; e < NU; ++e) lin = fma(c[L::kN + e * R + j], u[e], lin);
    const double col = __dadd_rn(__dadd_rn(c[1 + j], quad), lin);
    m[j] = __dsub_rn(row == j ? 1.0 : 0.0, __dmul_rn(hg, col));
  }
}

// Solve M dk = F without pivoting in solve_small's order: the lane of row i
// holds M[i, :] and F[i]; the rows are all-gathered and every lane of the
// group runs the elimination and the back substitution.
template <int R>
__device__ __forceinline__ void dirk2_eliminate(const double (&m_row)[R], double f_row,
                                                double (&dk)[R]) {
  double M[R][R], F[R], col[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    all_gather_d<R>(m_row[j], col);
#pragma unroll
    for (int i = 0; i < R; ++i) M[i][j] = col[i];
  }
  all_gather_d<R>(f_row, F);
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const double inv = 1.0 / M[p][p];
#pragma unroll
    for (int i = p + 1; i < R; ++i) {
      const double f = __dmul_rn(M[i][p], inv);
#pragma unroll
      for (int j = p + 1; j < R; ++j) M[i][j] = __dsub_rn(M[i][j], __dmul_rn(f, M[p][j]));
      F[i] = __dsub_rn(F[i], __dmul_rn(f, F[p]));
    }
  }
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
    double acc = F[i];
#pragma unroll
    for (int j = i + 1; j < R; ++j) acc = __dsub_rn(acc, __dmul_rn(M[i][j], dk[j]));
    dk[i] = ddiv_rn(acc, M[i][i]);
  }
}

// One stage: `newton_iters` Newton steps on kk = rhs(q_base + hg kk, u) from
// the guess in kk (replicated in the group).
template <int R, int NU>
__device__ __forceinline__ void dirk2_stage(const double (&c)[Layout<R, NU>::kD], int row,
                                            const double (&u)[NU], const double (&q_base)[R],
                                            double hg, int newton_iters, double (&kk)[R]) {
#pragma unroll 1
  for (int it = 0; it < newton_iters; ++it) {
    double x[R], dk[R], m[R];
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = __dadd_rn(q_base[i], __dmul_rn(hg, kk[i]));
    const double F = __dsub_rn(own_d<R>(kk, row), dirk2_rhs_row<R, NU>(c, x, u));
    dirk2_newton_row<R, NU>(c, x, u, hg, row, m);
    dirk2_eliminate<R>(m, F, dk);
#pragma unroll
    for (int i = 0; i < R; ++i) kk[i] = __dsub_rn(kk[i], dk[i]);
  }
}

// Clamp to +-clamp that keeps NaN, as torch.clamp does.
__device__ __forceinline__ double clamp_keep_nan(double x, double clamp) {
  return x < -clamp ? -clamp : (x > clamp ? clamp : x);
}

template <int NU>
__device__ __forceinline__ void dirk2_inputs(const double* __restrict__ u_p, int row,
                                             double (&u)[NU]) {
#pragma unroll
  for (int e = 0; e < NU; ++e) u[e] = __ldg(u_p + static_cast<size_t>(row) * NU + e);
}

template <int R, int NU>
__global__ void __launch_bounds__(32)
cahbn_dirk2_kernel(const double* __restrict__ Ohat,      // (P D, R, kD)
                   const double* __restrict__ q0,        // (P D, R)
                   const double* __restrict__ hs,        // (k - 1,)
                   const double* __restrict__ u_stages,  // (P, (k-1) substeps 3, NU)
                   int D, int k, int substeps, int newton_iters, double clamp,
                   double* __restrict__ out) {           // (P D, R, k)
  constexpr int kD = Layout<R, NU>::kD;
  constexpr int kLanes = Rows<R>::kLanes;
  const int row = threadIdx.x % kLanes;
  const int draw = blockIdx.x * Rows<R>::kDrawsPerWarp + threadIdx.x / kLanes;
  // A group past the problem's D draws shadows its draw 0 and writes nothing.
  const size_t n = static_cast<size_t>(blockIdx.y) * D + (draw < D ? draw : 0);
  const bool writes = draw < D && row < R;

  double c[kD];
  const double* op = Ohat + (n * R + (row < R ? row : 0)) * kD;
#pragma unroll
  for (int j = 0; j < kD; ++j) c[j] = row < R ? __ldg(op + j) : 0.0;
  const double* u_p =
      u_stages + static_cast<size_t>(blockIdx.y) * (k - 1) * substeps * 3 * NU;
  double* o = out + (n * R + (row < R ? row : 0)) * k;
  double q[R];
#pragma unroll
  for (int i = 0; i < R; ++i) q[i] = q0[n * R + i];

  // Once a state holds a NaN, every later state is NaN in every entry (each
  // row of the right-hand side reads every state); from then on the draw
  // writes NaN and integrates q = 0 with a zero operator.
  bool dead = false;
  auto report = [&](int s) {
    if (writes) o[s] = dead ? __longlong_as_double(0x7ff8000000000000LL) : own_d<R>(q, row);
    bool nan_now = false;
#pragma unroll
    for (int i = 0; i < R; ++i) nan_now = nan_now || isnan(q[i]);
    if (nan_now) {
      dead = true;
#pragma unroll
      for (int j = 0; j < kD; ++j) c[j] = 0.0;
#pragma unroll
      for (int i = 0; i < R; ++i) q[i] = 0.0;
    }
  };
  report(0);

  double u[NU], k1[R], k2[R], base2[R];
  for (int s = 1; s < k; ++s) {
    const double h = hs[s - 1];
    const double hg = __dmul_rn(h, kGammaD);
    const double h1 = __dmul_rn(h, kOneMinusGammaD);
    for (int sub = 0; sub < substeps; ++sub) {
      const int urow = ((s - 1) * substeps + sub) * 3;
      dirk2_inputs<NU>(u_p, urow, u);
      all_gather_d<R>(dirk2_rhs_row<R, NU>(c, q, u), k1);
      dirk2_inputs<NU>(u_p, urow + 1, u);
      dirk2_stage<R, NU>(c, row, u, q, hg, newton_iters, k1);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        base2[i] = __dadd_rn(q[i], __dmul_rn(h1, k1[i]));
        k2[i] = k1[i];
      }
      dirk2_inputs<NU>(u_p, urow + 2, u);
      dirk2_stage<R, NU>(c, row, u, base2, hg, newton_iters, k2);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const double step = __dadd_rn(__dmul_rn(kOneMinusGammaD, k1[i]), __dmul_rn(kGammaD, k2[i]));
        q[i] = clamp_keep_nan(__dadd_rn(q[i], __dmul_rn(h, step)), clamp);
      }
    }
    report(s);
  }
}

template <int R, int NU>
cudaError_t launch_dirk2(const double* Ohat, const double* q0, const double* hs,
                         const double* u_stages, int P, int D, int k, int substeps,
                         int newton_iters, double clamp, double* out, cudaStream_t stream) {
  const dim3 grid((D + Rows<R>::kDrawsPerWarp - 1) / Rows<R>::kDrawsPerWarp, P);
  cahbn_dirk2_kernel<R, NU><<<grid, 32, 0, stream>>>(Ohat, q0, hs, u_stages, D, k, substeps,
                                                     newton_iters, clamp, out);
  return cudaGetLastError();
}

template <int NU>
int launch_dirk2_r(int r, const double* Ohat, const double* q0, const double* hs,
                   const double* u_stages, int P, int D, int k, int substeps, int newton_iters,
                   double clamp, double* out, cudaStream_t stream) {
  switch (r) {
#define GPBOI_DIRK2_CASE(R)                                                                \
  case R:                                                                                  \
    return static_cast<int>(launch_dirk2<R, NU>(Ohat, q0, hs, u_stages, P, D, k, substeps, \
                                                newton_iters, clamp, out, stream));
    GPBOI_DIRK2_CASE(1)
    GPBOI_DIRK2_CASE(2)
    GPBOI_DIRK2_CASE(3)
    GPBOI_DIRK2_CASE(4)
    GPBOI_DIRK2_CASE(5)
    GPBOI_DIRK2_CASE(6)
    GPBOI_DIRK2_CASE(7)
    GPBOI_DIRK2_CASE(8)
#undef GPBOI_DIRK2_CASE
    default:
      return -2;
  }
}

constexpr int kDirk2MaxR = 8;
constexpr int kDirk2MaxNu = 2;

}  // namespace

// Integrates P D "cAHBN" ROM draws by SDIRK2 in one launch, in float64:
// Ohat (P D, r, d), q0 (P D, r), hs (k - 1,) the step of each output
// interval over `substeps` (as dirk2_solve computes it), u_stages (P,
// (k - 1) substeps 3, nu), draw b reading problem b / D; writes out (P D, r,
// k). Returns 0 on success, a cudaError_t code if the launch failed, -1 for
// r < 1 or nu < 1, -2 for r > 8 or nu > 2 (no instance) and
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int gpboi_cahbn_dirk2(const double* Ohat, const double* q0, const double* hs,
                                 const double* u_stages, int P, int D, int r, int nu, int k,
                                 int substeps, int newton_iters, double clamp, double* out,
                                 void* stream) {
  if (r < 1 || nu < 1) return -1;
  if (r > kDirk2MaxR || nu > kDirk2MaxNu) return -2;
  if (P < 1 || P > 65535 || D < 1 || k < 1 || substeps < 1 || newton_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nu == 1 ? launch_dirk2_r<1>(r, Ohat, q0, hs, u_stages, P, D, k, substeps, newton_iters,
                                     clamp, out, s)
                 : launch_dirk2_r<2>(r, Ohat, q0, hs, u_stages, P, D, k, substeps, newton_iters,
                                     clamp, out, s);
}
