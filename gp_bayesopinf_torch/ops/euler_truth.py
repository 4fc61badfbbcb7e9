"""The Euler truth solve in one launch: the fused float64 RK4 kernel of
``csrc/euler_truth.cu`` (no JAX counterpart: the JAX package's truth solve
is a ``lax.scan`` that XLA fuses).

``euler_rk4_cuda`` integrates ``models/euler.py::Euler.derivative`` as
``solve/ivp.py::rk4_solve`` does, one block for the whole trajectory, and
gives the loop's result on the card to the bit, NaN and the clamp
included (see the source's header). ``Euler.solve`` sends a float64
initial condition on a CUDA device here and everything else through
``rk4_solve``, which stays the plain version and the yardstick.
"""

import ctypes
import functools

import torch

from ..solve.ivp import CLAMP

#: The most cells whose state, stage slope and RK4 sum stay in registers
#: (``MAX_NX`` of ``csrc/euler_truth.cu``: two a thread of 1024). Wider
#: grids keep them in a global scratch of ``WIDE_SCRATCH`` nx doubles.
MAX_NX = 2048
WIDE_SCRATCH = 15

#: Kernel launches made by ``euler_rk4_cuda`` in this process. Callers may
#: reset it to 0 to count the launches of one run.
launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load_library

    lib = load_library("euler_truth")
    fn = lib.gpboi_euler_rk4
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_double] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def euler_rk4_cuda(
    q0: torch.Tensor, t_eval: torch.Tensor, substeps: int, dx: float, gamma_minus_1: float
) -> torch.Tensor:
    """RK4 of the periodic upwind Euler model in conservative variables,
    in one launch on PyTorch's current stream (no synchronization).

    Parameters
    ----------
    q0 : (3 nx,) contiguous float64 CUDA tensor, [rho, rho v, rho e], with
        nx >= 2. Above ``MAX_NX`` (2048) cells the kernel also takes a
        scratch of ``WIDE_SCRATCH`` nx doubles, allocated here.
    t_eval : (k,) contiguous float64 tensor of output times on q0's device.
    substeps : RK4 steps per output interval, at least 1.
    dx, gamma_minus_1 : the model's ``dx`` and ``gamma - 1.0``.

    Returns
    -------
    (3 nx, k) float64 states at ``t_eval``, the first column ``q0``: what
    ``rk4_solve(Euler.derivative, q0, t_eval, substeps)`` gives on the card.
    Raises ValueError, before any launch, on what the kernel does not take,
    and RuntimeError on a failed launch.
    """
    global launches
    for name, x in (("q0", q0), ("t_eval", t_eval)):
        if x.dtype != torch.float64:
            raise ValueError(f"{name} must be float64, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.ndim != 1:
            raise ValueError(f"{name} must be one-dimensional, got {tuple(x.shape)}")
    n, k = q0.shape[0], t_eval.shape[0]
    if n % 3 or n // 3 < 2:
        raise ValueError(f"q0 must hold 3 nx values with nx >= 2, got {n}")
    if k < 1 or substeps < 1:
        raise ValueError(f"need k >= 1 and substeps >= 1, got {k}, {substeps}")
    dev = q0.device
    if dev.type != "cuda" or t_eval.device != dev:
        raise ValueError(f"the fused Euler solve needs q0 and t_eval on one CUDA device, "
                         f"got {dev} and {t_eval.device}")
    hs = (t_eval[1:] - t_eval[:-1]) / substeps  # as rk4_solve computes its steps
    out = torch.empty((n, k), dtype=torch.float64, device=dev)
    nx = n // 3
    # Freed on return: the caching allocator hands it out again only to
    # work queued after this launch on the same stream.
    scratch = (torch.empty(WIDE_SCRATCH * nx, dtype=torch.float64, device=dev)
               if nx > MAX_NX else None)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gpboi_euler_rk4(
            q0.data_ptr(), hs.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nx, k, substeps, dx,
            gamma_minus_1, CLAMP, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"euler_truth launch failed: error {rc}")
    launches += 1
    return out
