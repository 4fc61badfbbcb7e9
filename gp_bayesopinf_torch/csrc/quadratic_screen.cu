// RK4 ensemble screen of quadratic "cAH" ROM posterior draws, for Hopper
// (sm_90a). Built by gp_bayesopinf_torch/ops/build.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes.
//
// Replaces: the Pallas TPU kernel
//   gp_bayesopinf_tpu/ops/ensemble_pallas.py::quadratic_ensemble_screen
//   (pl.pallas_call of _screen_kernel).
//
// What it computes: for N = G * nd operator draws of
//   dq/dt = c + A q + H ckron(q),   d = 1 + r + r(r+1)/2 columns,
// classical RK4 with `substeps` steps per output interval over t_eval,
// the state clipped to +-1e6 after every stage. Outputs are a per-draw
// stability flag (max over t, t0 included, of |q - shift| <= limits, and
// finite) and, per candidate, the squared Frobenius error of the nd-draw
// mean against `snaps` summed over all output times, t0 included.
//
// What bounds it on this card: latency. At the Euler ex1a screen shapes
// (G = 16, nd = 20, r = 6, k = 401, substeps = 8) one launch is 3,200
// sequential RK4 steps, 12,800 right-hand sides of 168 multiply-adds
// each, spread over only 320 threads: the arithmetic and the bytes are
// tiny, the dependent chain is long, and most of the card stays idle.
//
// What the design does about it: it keeps the whole chain on chip and
// off the host. One warp per candidate (one block, so the candidates
// spread over SMs) and one lane per draw; lanes at or above nd shadow
// draw 0, take part in the shuffles and write nothing. The state and
// the RK4 stages live in registers, unrolled at compile time for each r;
// the operators stay in global memory (L1-resident, 168 floats a draw at
// r = 6) in a draw-minor (r, d, N) layout, so the lanes of a warp read
// consecutive addresses. The draw mean at each output time is a
// __shfl_down_sync reduction and lane 0 accumulates err_sq: no atomics,
// and the result is deterministic. Everything is float32, as the
// screening contract says; nvcc's multiply-add contraction makes err_sq
// differ from the CPU in the last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kDivergeCap = 1e6f;  // DIVERGE_CAP of the TPU kernel
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

// dq = Ohat @ [1, q, ckron(q)] for one draw. `op` points at the draw's
// coefficient (0, 0); coefficient (i, j) lies at op[(i * D + j) * N].
template <int R>
__device__ __forceinline__ void rom_rhs(const float* __restrict__ op, int N,
                                        const float (&q)[R], float (&dq)[R]) {
  constexpr int P = R * (R + 1) / 2;
  constexpr int D = 1 + R + P;
  float quad[P];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) quad[a * (a + 1) / 2 + b] = q[a] * q[b];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* row = op + static_cast<size_t>(i) * D * N;
    float acc = __ldg(row);
#pragma unroll
    for (int a = 0; a < R; ++a) acc += __ldg(row + static_cast<size_t>(1 + a) * N) * q[a];
#pragma unroll
    for (int z = 0; z < P; ++z) acc += __ldg(row + static_cast<size_t>(1 + R + z) * N) * quad[z];
    dq[i] = acc;
  }
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

template <int R>
__global__ void __launch_bounds__(32)
quadratic_screen_kernel(const float* __restrict__ OT,      // (R, D, N)
                        const float* __restrict__ q0,      // (R,)
                        const float* __restrict__ t_eval,  // (k,)
                        const float* __restrict__ shift,   // (R,)
                        const float* __restrict__ limits,  // (R,)
                        const float* __restrict__ snaps,   // (R, k) or null
                        int N, int nd, int k, int substeps,
                        bool* __restrict__ stable,         // (N,)
                        float* __restrict__ err_sq) {      // (G,)
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

  // One stage slope at a time; `acc` sums k1 + 2 k2 + 2 k3 + k4 in that
  // order, as the reference does.
  float kk[R], acc[R], tmp[R];
  for (int s = 1; s < k; ++s) {
    const float h = (t_eval[s] - t_eval[s - 1]) / static_cast<float>(substeps);
    const float hh = 0.5f * h;
    const float h6 = h / 6.0f;
    for (int sub = 0; sub < substeps; ++sub) {
      rom_rhs<R>(op, N, q, kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = kk[i];
        tmp[i] = clip_keep_nan(q[i] + hh * kk[i]);
      }
      rom_rhs<R>(op, N, tmp, kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = acc[i] + 2.f * kk[i];
        tmp[i] = clip_keep_nan(q[i] + hh * kk[i]);
      }
      rom_rhs<R>(op, N, tmp, kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] = acc[i] + 2.f * kk[i];
        tmp[i] = clip_keep_nan(q[i] + h * kk[i]);
      }
      rom_rhs<R>(op, N, tmp, kk);
#pragma unroll
      for (int i = 0; i < R; ++i) q[i] = clip_keep_nan(q[i] + h6 * (acc[i] + kk[i]));
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

template <int R>
cudaError_t launch(const float* OT, const float* q0, const float* t_eval, const float* shift,
                   const float* limits, const float* snaps, int N, int nd, int k, int substeps,
                   bool* stable, float* err_sq, cudaStream_t stream) {
  quadratic_screen_kernel<R><<<N / nd, 32, 0, stream>>>(OT, q0, t_eval, shift, limits, snaps,
                                                         N, nd, k, substeps, stable, err_sq);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code if the launch failed, and -1
// for a state dimension r that has no compiled instance (1..12).
extern "C" int gpboi_quadratic_screen(const float* OT, const float* q0, const float* t_eval,
                                      const float* shift, const float* limits,
                                      const float* snaps, int N, int r, int nd, int k,
                                      int substeps, bool* stable, float* err_sq,
                                      void* stream) {
  if (N < 1 || nd < 1 || nd > 32 || N % nd != 0 || k < 1 || substeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
#define GPBOI_SCREEN_CASE(R)                                                              \
  case R:                                                                                 \
    return static_cast<int>(launch<R>(OT, q0, t_eval, shift, limits, snaps, N, nd, k,     \
                                      substeps, stable, err_sq, s));
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
    default:
      return -1;
  }
}
