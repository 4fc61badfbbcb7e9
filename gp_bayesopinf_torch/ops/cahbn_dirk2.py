"""The SDIRK2 integration of "cAHBN" ROM posterior draws in one launch:
the fused float64 kernel ``cahbn_dirk2_kernel`` of ``csrc/cahbn_screen.cu``
(no JAX counterpart: the JAX package's ensemble is ``dirk2_solve``'s
``lax.scan``, which XLA fuses).

``cahbn_dirk2_cuda`` integrates B = P D draws, each with its own operator
and initial state, draw b reading the inputs of problem b // D, as
``solve/ivp.py::dirk2_solve`` integrates ``rom_rhs`` with the analytic
Jacobian: the same steps, stages, Newton count and clamp, every elementwise
step rounded as the loop's tensor operations round; the Newton systems are
solved without pivoting (``solve_small``'s order) where the loop takes a
pivoted LU, so the two agree to float64 roundoff. ``GalerkinROM.predict``
sends a dirk2 "cAHBN" ROM on the card here (``rom.model.fused_dirk2``) and
everything else through ``dirk2_solve``, which stays the plain version and
the yardstick.
"""

import ctypes
import functools

import torch

from ..solve.ivp import CLAMP
from ..utils.timing import count

#: The largest state and input dimensions of the kernel's instances.
MAX_STATE = 8
MAX_INPUT = 2

#: Kernel launches made by ``cahbn_dirk2_cuda`` in this process. Callers
#: may reset it to 0 to count the launches of one run.
launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load_library

    lib = load_library("cahbn_screen")
    fn = lib.gpboi_cahbn_dirk2
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def cahbn_dirk2_cuda(
    Ohat: torch.Tensor, q0: torch.Tensor, t_eval: torch.Tensor, u_stages: torch.Tensor,
    substeps: int = 2, newton_iters: int = 6,
) -> torch.Tensor:
    """SDIRK2 of B "cAHBN" ROM draws in one launch on PyTorch's current
    stream (no synchronization).

    Parameters
    ----------
    Ohat : (B, r, d) contiguous float64 CUDA tensor, d = 1 + r + r(r+1)/2
        + nu + nu r, 1 <= r <= ``MAX_STATE``.
    q0 : (B, r) contiguous float64 initial states on Ohat's device.
    t_eval : (k,) output times, k >= 1, on any device; the steps are
        ``(t_eval[1:] - t_eval[:-1]) / substeps`` there, as ``dirk2_solve``
        takes them.
    u_stages : (P, (k-1) substeps 3, nu) contiguous float64 inputs on Ohat's
        device at ``ops.cahbn_screen.input_stage_times(t_eval, substeps)``,
        1 <= nu <= ``MAX_INPUT``, P dividing B: draw b reads problem b // (B
        / P).
    substeps : SDIRK2 steps per output interval, at least 1.
    newton_iters : full Newton steps per stage, at least 0.

    Returns
    -------
    (B, r, k) float64 states at ``t_eval``, column 0 ``q0``. Counts
    ``dirk2_steps`` as ``dirk2_solve`` does, and the same number of
    ``dirk2_fused_steps``. Raises ValueError, before any launch, on what
    the kernel does not take, and RuntimeError on a failed launch.
    """
    global launches
    dev = Ohat.device
    if dev.type != "cuda" or q0.device != dev or u_stages.device != dev:
        raise ValueError(f"the fused SDIRK2 needs Ohat, q0 and u_stages on one CUDA device, got "
                         f"{dev}, {q0.device} and {u_stages.device}")
    for name, x, ndim in (("Ohat", Ohat, 3), ("q0", q0, 2), ("u_stages", u_stages, 3)):
        if x.dtype != torch.float64:
            raise ValueError(f"{name} must be float64, got {x.dtype}")
        if x.ndim != ndim:
            raise ValueError(f"{name} must have {ndim} axes, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t_eval.ndim != 1 or not t_eval.is_floating_point():
        raise ValueError(f"t_eval must be a floating (k,) tensor, got {t_eval.dtype} "
                         f"{tuple(t_eval.shape)}")
    B, r, d = Ohat.shape
    P, n, nu = u_stages.shape
    k = t_eval.shape[0]
    if not (1 <= r <= MAX_STATE and 1 <= nu <= MAX_INPUT):
        raise ValueError(f"no instance for r={r}, nu={nu}: the kernel takes 1 <= r <= "
                         f"{MAX_STATE} and 1 <= nu <= {MAX_INPUT}")
    if d != 1 + r + r * (r + 1) // 2 + nu + nu * r:
        raise ValueError(f"Ohat has d={d} columns; a 'cAHBN' ROM with r={r}, nu={nu} has "
                         f"{1 + r + r * (r + 1) // 2 + nu + nu * r}")
    if k < 1 or substeps < 1 or newton_iters < 0:
        raise ValueError(f"need k >= 1, substeps >= 1 and newton_iters >= 0, got {k}, "
                         f"{substeps}, {newton_iters}")
    if q0.shape != (B, r) or B < 1 or not 1 <= P <= 65535 or B % P or n != (k - 1) * substeps * 3:
        raise ValueError(f"shapes do not fit: Ohat {tuple(Ohat.shape)}, q0 {tuple(q0.shape)}, "
                         f"u_stages {tuple(u_stages.shape)} at k={k}, substeps={substeps} (B >= 1, "
                         f"P <= 65535 dividing B, (k-1) substeps 3 input rows)")
    hs = ((t_eval[1:] - t_eval[:-1]) / substeps).to(device=dev, dtype=torch.float64)
    out = torch.empty((B, r, k), dtype=torch.float64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gpboi_cahbn_dirk2(
            Ohat.data_ptr(), q0.data_ptr(), hs.data_ptr(), u_stages.data_ptr(), P, B // P, r, nu,
            k, substeps, newton_iters, CLAMP, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cahbn_dirk2 launch failed: error {rc}")
    launches += 1
    count("dirk2_steps", (k - 1) * substeps)
    count("dirk2_fused_steps", (k - 1) * substeps)
    return out
