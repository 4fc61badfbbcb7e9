"""Where a Newton step of kernel B's capacity-templated or wide kernel
spends its cycles, on one CUDA card.

    python3 scripts/torch_screen_cycles.py [--r 9] [--nu 2] [--k 80]
    python3 scripts/torch_screen_cycles.py --family wide --r 20 --nu 2

Builds a copy of ``gp_bayesopinf_torch/csrc/cahbn_screen.cu`` into
``build/screen_cycles/`` with ``clock64()`` read around the three parts of
the kernel's Newton step. Capacity (``cahbn_screen_cap_kernel``): the
right-hand side and F, the Newton row, the elimination with its back
substitution, each read after an empty ``asm volatile`` on the part's
results so that the part is done when the clock is read; lane 0 of every
draw adds its sums to a device array. Wide (``cahbn_screen_wide_kernel``):
thread 0's right-hand side rows and F, the Newton matrix up to the
block's barrier, the solve (elimination and back substitution) up to the
next; thread 0 of every draw adds its sums. The copy is made by text
substitution at fixed lines of the source and the script stops if one is
missing. It then screens the
``chip_smoke.py`` phase 4b case (G = 16, nd = 20, the ex3 input family, 4
substeps, 6 Newton steps, error term) once through the copy and prints
one JSON line: the card, the SM clock, cycles per Newton step of each
part and of the whole launch. The instrumented copy is slower than the
kernel; the split, not the sum, is the measurement.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

NEWTON = """          const float F = own<RCAP>(kk, row) - rhs_cap<RCAP, NUCAP>(t, x, u, r, nu);
          newton_row_cap<RCAP, NUCAP>(t, x, u, hg, r, nu, row, m);
          eliminate_cap<RCAP>(m, F, r, dk);
"""
NEWTON_TIMED = """          long long c0 = clock64();
          const float F = own<RCAP>(kk, row) - rhs_cap<RCAP, NUCAP>(t, x, u, r, nu);
          asm volatile("" ::"f"(F));
          long long c1 = clock64();
          newton_row_cap<RCAP, NUCAP>(t, x, u, hg, r, nu, row, m);
#pragma unroll
          for (int j = 0; j < RCAP; ++j) asm volatile("" ::"f"(m[j]));
          long long c2 = clock64();
          eliminate_cap<RCAP>(m, F, r, dk);
#pragma unroll
          for (int j = 0; j < RCAP; ++j) asm volatile("" ::"f"(dk[j]));
          cyc[0] += c1 - c0;
          cyc[1] += c2 - c1;
          cyc[2] += clock64() - c2;
          cyc[3] += 1;
"""
LOOP = """  float u[NUCAP], kk[RCAP], k1[RCAP], base[RCAP];
  for (int s = 1; s < k; ++s) {
"""
LOOP_TIMED = """  float u[NUCAP], kk[RCAP], k1[RCAP], base[RCAP];
  long long cyc[4] = {0, 0, 0, 0};
  const long long c_start = clock64();
  for (int s = 1; s < k; ++s) {
"""
END = """  if (lane == 0) stable[static_cast<size_t>(l) * N + n] = all;
}

template <int RCAP, int NUCAP>
cudaError_t launch_cap("""
END_TIMED = """  if (lane == 0) stable[static_cast<size_t>(l) * N + n] = all;
  if (lane == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(&g_cycles[i], static_cast<unsigned long long>(cyc[i]));
    atomicAdd(&g_cycles[4], static_cast<unsigned long long>(clock64() - c_start));
  }
}

template <int RCAP, int NUCAP>
cudaError_t launch_cap("""
GLOBALS = "constexpr float kOneMinusGamma = static_cast<float>(1.0 - kGammaD);\n"
WIDE_LOOP = """  // Newton-solve kv = rhs(bv + hg kv, u) from the guess in kv; thread tid
"""
WIDE_LOOP_TIMED = """  long long cyc[4] = {0, 0, 0, 0};
  const long long c_start = clock64();
""" + WIDE_LOOP
WIDE_NEWTON = """      wide_rhs(rv, si, sc, S, r, d, [&](int i, float v) { M[i * ms + r] = kv[i] - v; });
      wide_newton_matrix(T, rs, xs, us, hg, r, nu, M, ms);
      __syncthreads();
"""
WIDE_NEWTON_TIMED = """      long long c0 = clock64();
      wide_rhs(rv, si, sc, S, r, d, [&](int i, float v) { M[i * ms + r] = kv[i] - v; });
      long long c1 = clock64();
      wide_newton_matrix(T, rs, xs, us, hg, r, nu, M, ms);
      __syncthreads();
      long long c2 = clock64();
"""
WIDE_SOLVED = """      __syncthreads();
      for (int i = tid; i < r; i += nt) kv[i] = kv[i] - dks[i];
"""
WIDE_SOLVED_TIMED = """      __syncthreads();
      cyc[0] += c1 - c0;
      cyc[1] += c2 - c1;
      cyc[2] += clock64() - c2;
      cyc[3] += 1;
      for (int i = tid; i < r; i += nt) kv[i] = kv[i] - dks[i];
"""
WIDE_END = """  if (tid == 0) stable[static_cast<size_t>(l) * N + n] = ok;
}
"""
WIDE_END_TIMED = """  if (tid == 0) stable[static_cast<size_t>(l) * N + n] = ok;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(&g_cycles[i], static_cast<unsigned long long>(cyc[i]));
    atomicAdd(&g_cycles[4], static_cast<unsigned long long>(clock64() - c_start));
  }
}
"""
READER = """
extern "C" int gpboi_screen_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[5] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_cycles, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_cycles, sizeof(unsigned long long) * 5));
}
"""


def instrumented_source(family: str) -> str:
    src = (REPO / "gp_bayesopinf_torch" / "csrc" / "cahbn_screen.cu").read_text()
    edits = ((NEWTON, NEWTON_TIMED), (LOOP, LOOP_TIMED), (END, END_TIMED)) if family == "capacity" \
        else ((WIDE_LOOP, WIDE_LOOP_TIMED), (WIDE_NEWTON, WIDE_NEWTON_TIMED),
              (WIDE_SOLVED, WIDE_SOLVED_TIMED), (WIDE_END, WIDE_END_TIMED))
    for old, new in edits + ((GLOBALS, GLOBALS + "__device__ unsigned long long g_cycles[5];\n"),):
        if src.count(old) != 1:
            raise SystemExit(f"cahbn_screen.cu changed: no single place for\n{old}")
        src = src.replace(old, new)
    return src + READER


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from gp_bayesopinf_torch.ops.build import NVCC_FLAGS, _nvcc

    parser = argparse.ArgumentParser()
    parser.add_argument("--r", type=int, default=9)
    parser.add_argument("--nu", type=int, default=2)
    parser.add_argument("--k", type=int, default=80)
    parser.add_argument("--family", choices=("capacity", "wide"), default="capacity")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = REPO / "build" / "screen_cycles"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "cahbn_screen_cycles.cu"
    src.write_text(instrumented_source(args.family))
    lib_path = out / "libcahbn_screen_cycles.so"
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{REPO / 'gp_bayesopinf_torch' / 'csrc'}", "-o",
           str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.gpboi_cahbn_screen.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                                       + [ctypes.c_void_p] * 5)
    lib.gpboi_screen_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gpboi_cahbn_wide_scratch.argtypes = [ctypes.c_int] * 2
    lib.gpboi_cahbn_wide_scratch.restype = ctypes.c_longlong

    G, nd, r, nu, k = 16, 20, args.r, args.nu, args.k
    a = chip_smoke.cahbn_case(G, nd, k, 1.0, np.random.default_rng(20261018), True, r=r, nu=nu)
    f = {n: v.to(torch.float32).contiguous() for n, v in a.items()}
    N = G * nd
    stable = torch.empty(N, dtype=torch.bool, device="cuda")
    err = torch.zeros(G, device="cuda")
    partial = torch.empty(N * k * r, device="cuda")
    family = ("templated", "capacity", "runtime", "wide").index(args.family)
    per_block = lib.gpboi_cahbn_wide_scratch(r, nu) if args.family == "wide" else 0
    scratch = torch.empty(N * per_block, device="cuda") if per_block else None
    cycles = (ctypes.c_ulonglong * 5)()
    if lib.gpboi_screen_cycles(cycles, 1):
        raise SystemExit("could not reset the cycle counters")
    rc = lib.gpboi_cahbn_screen(
        f["Ohat"].data_ptr(), f["q0"].data_ptr(), f["t_eval"].data_ptr(),
        f["u_stages"].data_ptr(), f["shift"].data_ptr(), f["limits"].data_ptr(),
        f["snapshots"].data_ptr(), 1, N, r, nu, nd, nd, k, 4, 6, family, stable.data_ptr(),
        partial.data_ptr(), err.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc or lib.gpboi_screen_cycles(cycles, 0):
        raise SystemExit(f"the instrumented launch failed: {rc}")
    rhs, row, elim, steps, total = list(cycles)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "card": chip_smoke.card_line(), "sm_clock": clock, "family": args.family, "r": r,
        "nu": nu, "k": k, "newton_steps": steps, "cycles_per_newton_step": {
            "rhs_and_F": rhs / steps,
            "newton_row" if args.family == "capacity" else "newton_matrix": row / steps,
            "elimination_and_back_substitution": elim / steps, "whole_kernel": total / steps},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
