// Fused float64 RK4 truth solve of the periodic 1-D Euler equations, for
// Hopper (sm_90a). Built by gp_bayesopinf_torch/ops/build.py with nvcc into
// a shared library with a plain C interface, loaded through ctypes
// (wrapper: gp_bayesopinf_torch/ops/euler_truth.py).
//
// Replaces: no TPU kernel. The JAX package integrates the same model with
// a lax.scan that XLA fuses (gp_bayesopinf_tpu/models/euler.py,
// solve/ivp.py::rk4_solve); the port's Python loop over rk4_solve issued
// every operation of a step alone, ~94 launches an RK4 step and ~23 k
// steps an ex1a experiment, so the host's launch rate set the truth
// solve's wall. This kernel is the whole loop in one launch.
//
// What it computes: models/euler.py::Euler.derivative (first-order upwind
// fluxes of (rho, rho v, rho e) on nx periodic cells) integrated by
// solve/ivp.py::rk4_solve with `substeps` steps per output interval, the
// state clamped at +-clamp after every step; out is (3 nx, k), column 0
// the initial state. The result equals the loop on the card to the bit,
// NaN and the clamp included, so every operation follows the loop's
// order and PyTorch's arithmetic on CUDA:
//   v = rho_v / rho;  p = (gamma - 1) * (rho_e - (0.5 rho_v) v);
//   fluxes rho_v, rho_v v + p, (rho_e + p) v;
//   slope -((w - w_left) * (1 / dx)): a CUDA tensor divided by a Python
//   scalar is multiplied by the scalar's reciprocal (ATen's
//   div_true_kernel_cuda), so the kernel multiplies too;
//   stages q + (0.5 h) k1, q + (0.5 h) k2, q + h k3;
//   q + (h / 6) (((k1 + 2 k2) + 2 k3) + k4), then the clamp, which lets
//   NaN through as torch.clamp does.
// Every operation is an explicitly rounded intrinsic (__dadd_rn, ...), so
// nvcc contracts none into a multiply-add. The steps h come in computed
// by PyTorch as rk4_solve computes them.
//
// What bounds it on this card: the latency of the dependent chain. A step
// is four right-hand sides of ~15 float64 operations a cell (one
// division) on 3 nx = 600 values at ex1a; the work is microseconds a step
// at any rate, and nothing of it can run ahead of the previous stage.
//
// What the design does about it: one block integrates the trajectory
// over all intervals and substeps. Thread t owns cells t, t + T, ...
// (T the block's threads). Up to MAX_NX cells (CPT of them a thread) each
// cell's state, stage slope and RK4 sum stay in registers for the whole
// solve. A stage forms each cell's three fluxes, stores them to a
// double-buffered shared array (2 x 3 x nx doubles: 9.6 KB at nx 200, 96
// KB at nx 2000, dynamic shared memory opted in), meets one
// __syncthreads(), and reads its left neighbour's fluxes (cell 0 reads
// cell nx - 1). The second buffer lets the next stage store before every
// thread has read: one barrier a stage. Each interval's end writes column
// i + 1 of out, element (row, i + 1) at row * k + i + 1.
//
// Wider than MAX_NX, which one SM's registers cannot hold, a second kernel
// runs the same arithmetic (the same device functions) with each cell's
// state, slope and sum and both flux buffers in a global scratch of 15 nx
// doubles (L2 resident below ~400 k cells); a barrier also orders a
// block's global stores before its loads, so the schedule is the same.
// There is no upper limit on nx.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
// Cells a thread may own in registers. A cell keeps 9 doubles there
// (state, stage slope, RK4 sum), 18 of a thread's 64 registers at 1024
// threads, so two cells a thread are the most one SM's register file
// holds: MAX_NX = 2048 cells, whose 2 x 3 x nx double buffer (96 KB) fits
// the 227 KB of shared memory a block may use. Wider grids take
// euler_rk4_wide_kernel.
constexpr int MAX_CPT = 2;
constexpr int MAX_NX = MAX_THREADS * MAX_CPT;
// Doubles of the wide kernel's scratch a cell: 9 of state, slope and sum,
// 6 of the two flux buffers.
constexpr int WIDE_SCRATCH = 15;
static_assert(WIDE_SCRATCH == 3 * 3 + 2 * 3, "q, slope, acc and two flux buffers");

__device__ __forceinline__ double clamp_keep_nan(double x, double c) {
  // torch.clamp(x, -c, c): a NaN fails both tests and passes through.
  return x < -c ? -c : (x > c ? c : x);
}

// The stage state of one variable: q, q + (0.5 h) k1, q + (0.5 h) k2,
// q + h k3 (a the stage's coefficient).
__device__ __forceinline__ double stage_value(double q, double slope, double a, int stage) {
  return stage == 0 ? q : __dadd_rn(q, __dmul_rn(a, slope));
}

// Cell c's three fluxes at stage state y, stored to f ([3][nx]).
__device__ __forceinline__ void store_fluxes(double* f, int nx, int c, const double (&y)[3],
                                             double gamma_minus_1) {
  const double vel = __ddiv_rn(y[1], y[0]);
  const double p =
      __dmul_rn(gamma_minus_1, __dsub_rn(y[2], __dmul_rn(__dmul_rn(0.5, y[1]), vel)));
  f[c] = y[1];
  f[nx + c] = __dadd_rn(__dmul_rn(y[1], vel), p);
  f[2 * nx + c] = __dmul_rn(__dadd_rn(y[2], p), vel);
}

// Cell c's slope of variable v from the fluxes f, the left neighbour
// periodic.
__device__ __forceinline__ double slope_of(const double* f, int nx, int c, int v, double inv_dx) {
  const int c_left = c == 0 ? nx - 1 : c - 1;
  return -__dmul_rn(__dsub_rn(f[v * nx + c], f[v * nx + c_left]), inv_dx);
}

// The RK4 sum after this stage's slope kv: ((k1 + 2 k2) + 2 k3) + k4, in
// that order.
__device__ __forceinline__ double rk4_sum(double acc, double kv, int stage) {
  if (stage == 0) return kv;
  return stage == 3 ? __dadd_rn(acc, kv) : __dadd_rn(acc, __dmul_rn(2.0, kv));
}

__device__ __forceinline__ double step_end(double q, double h_sixth, double acc, double clamp) {
  return clamp_keep_nan(__dadd_rn(q, __dmul_rn(h_sixth, acc)), clamp);
}

template <int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
euler_rk4_kernel(const double* __restrict__ q0, const double* __restrict__ hs,
                 double* __restrict__ out, int nx, int k, int substeps, double dx,
                 double gamma_minus_1, double clamp) {
  extern __shared__ double flux[];  // [2][3][nx]
  const int T = blockDim.x;
  const double inv_dx = __ddiv_rn(1.0, dx);

  // Cell j of this thread is threadIdx.x + j T; a cell at or past nx is
  // idle (a unit state that no store reads).
  double q[3][CPT], slope[3][CPT], acc[3][CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = threadIdx.x + j * T;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      q[v][j] = c < nx ? q0[v * nx + c] : 1.0;
      slope[v][j] = acc[v][j] = 0.0;
      if (c < nx) out[(size_t)(v * nx + c) * k] = q[v][j];
    }
  }

  int buf = 0;
  for (int i = 0; i + 1 < k; ++i) {
    const double h = hs[i];
    const double half_h = __dmul_rn(0.5, h);
    const double h_sixth = __ddiv_rn(h, 6.0);
    for (int s = 0; s < substeps; ++s) {
#pragma unroll
      for (int stage = 0; stage < 4; ++stage) {
        const double a = stage == 3 ? h : half_h;
        double* f = flux + buf * 3 * nx;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = threadIdx.x + j * T;
          if (c >= nx) continue;
          double y[3];
#pragma unroll
          for (int v = 0; v < 3; ++v) y[v] = stage_value(q[v][j], slope[v][j], a, stage);
          store_fluxes(f, nx, c, y, gamma_minus_1);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = threadIdx.x + j * T;
          if (c >= nx) continue;
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const double kv = slope_of(f, nx, c, v, inv_dx);
            slope[v][j] = kv;
            acc[v][j] = rk4_sum(acc[v][j], kv, stage);
          }
        }
        buf ^= 1;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int v = 0; v < 3; ++v) q[v][j] = step_end(q[v][j], h_sixth, acc[v][j], clamp);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * T;
      if (c < nx)
#pragma unroll
        for (int v = 0; v < 3; ++v) out[(size_t)(v * nx + c) * k + i + 1] = q[v][j];
    }
  }
}

// euler_rk4_kernel past MAX_NX: scratch holds q, slope and acc ([3][nx]
// each) and the two flux buffers ([2][3][nx]); cell c is thread c mod T's.
__global__ void __launch_bounds__(MAX_THREADS)
euler_rk4_wide_kernel(const double* __restrict__ q0, const double* __restrict__ hs,
                      double* __restrict__ out, double* __restrict__ scratch, int nx, int k,
                      int substeps, double dx, double gamma_minus_1, double clamp) {
  const int T = blockDim.x;
  const double inv_dx = __ddiv_rn(1.0, dx);
  double* q = scratch;
  double* slope = scratch + 3 * nx;
  double* acc = scratch + 6 * nx;
  double* flux = scratch + 9 * nx;  // [2][3][nx]

  for (int c = threadIdx.x; c < nx; c += T)
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      q[v * nx + c] = q0[v * nx + c];
      out[(size_t)(v * nx + c) * k] = q0[v * nx + c];
    }

  int buf = 0;
  for (int i = 0; i + 1 < k; ++i) {
    const double h = hs[i];
    const double half_h = __dmul_rn(0.5, h);
    const double h_sixth = __ddiv_rn(h, 6.0);
    for (int s = 0; s < substeps; ++s) {
#pragma unroll
      for (int stage = 0; stage < 4; ++stage) {
        const double a = stage == 3 ? h : half_h;
        double* f = flux + buf * 3 * nx;
        for (int c = threadIdx.x; c < nx; c += T) {
          double y[3];
#pragma unroll
          for (int v = 0; v < 3; ++v)
            y[v] = stage_value(q[v * nx + c], slope[v * nx + c], a, stage);
          store_fluxes(f, nx, c, y, gamma_minus_1);
        }
        __syncthreads();
        for (int c = threadIdx.x; c < nx; c += T)
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const double kv = slope_of(f, nx, c, v, inv_dx);
            slope[v * nx + c] = kv;
            acc[v * nx + c] = rk4_sum(acc[v * nx + c], kv, stage);
          }
        buf ^= 1;
      }
      for (int c = threadIdx.x; c < nx; c += T)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          q[v * nx + c] = step_end(q[v * nx + c], h_sixth, acc[v * nx + c], clamp);
    }
    for (int c = threadIdx.x; c < nx; c += T)
#pragma unroll
      for (int v = 0; v < 3; ++v) out[(size_t)(v * nx + c) * k + i + 1] = q[v * nx + c];
  }
}

template <int CPT>
cudaError_t launch(const double* q0, const double* hs, double* out, int nx, int k,
                   int substeps, double dx, double gamma_minus_1, double clamp,
                   cudaStream_t stream) {
  const int threads = ((nx + CPT - 1) / CPT + 31) / 32 * 32;
  const size_t smem = 2 * 3 * (size_t)nx * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      euler_rk4_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  euler_rk4_kernel<CPT><<<1, threads, smem, stream>>>(q0, hs, out, nx, k, substeps, dx,
                                                       gamma_minus_1, clamp);
  return cudaGetLastError();
}

}  // namespace

// q0 (3 nx) and out (3 nx, k) row-major float64, hs the k - 1 steps,
// scratch WIDE_SCRATCH nx doubles where nx > MAX_NX (else unused, may be
// null); all on the device of `stream`. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int gpboi_euler_rk4(const double* q0, const double* hs, double* out, double* scratch,
                               int nx, int k, int substeps, double dx, double gamma_minus_1,
                               double clamp, void* stream) {
  if (nx < 2 || k < 1 || substeps < 1 || (nx > MAX_NX && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nx <= MAX_THREADS)
    return launch<1>(q0, hs, out, nx, k, substeps, dx, gamma_minus_1, clamp, s);
  if (nx <= MAX_NX)
    return launch<MAX_CPT>(q0, hs, out, nx, k, substeps, dx, gamma_minus_1, clamp, s);
  euler_rk4_wide_kernel<<<1, MAX_THREADS, 0, s>>>(q0, hs, out, scratch, nx, k, substeps, dx,
                                                  gamma_minus_1, clamp);
  return cudaGetLastError();
}
