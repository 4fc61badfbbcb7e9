"""Build and load the package's CUDA kernels (no JAX counterpart: the
JAX package's Pallas kernels are compiled by JAX itself).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/gp_bayesopinf_torch/`` at the repository root, named by a hash of
the source, the shared headers and the flags, and loaded with ``ctypes``.
Nothing is built when the package is imported, and nothing here runs on
a machine without CUDA unless a CUDA tensor reaches a kernel wrapper. A
library's first load is the span ``ops.load_library`` (``utils.timing``).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from ..utils.timing import span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gp_bayesopinf_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildInfo(NamedTuple):
    """What a build produced: the library, nvcc's and ptxas's report
    (register and spill counts), and the seconds it took (0 if cached)."""

    path: Path
    log: str
    seconds: float


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.cache
def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a library for the same source,
    shared headers (``csrc/*.cuh``) and flags exists. Raises RuntimeError
    with nvcc's output if it fails. Builds of different names may run in
    parallel threads."""
    src = CSRC / f"{name}.cu"
    parts = [src.read_bytes()] + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log, seconds = "", 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)
    return BuildInfo(out, log, seconds)


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with span("ops.load_library"):
        return ctypes.CDLL(str(build(name).path))
