"""RK4 ensemble screen of quadratic "cAH" ROM posterior draws
(counterpart of ``gp_bayesopinf_tpu/ops/ensemble_pallas.py``,
``quadratic_ensemble_screen`` and its XLA twin).

The regularization search integrates G candidates x nd posterior draws
of a quadratic ROM over two time grids and needs only decision
quantities from them:

* per-draw stability flags (finite and inside the 5x-amplitude envelope
  at every output time, t0 included);
* per-candidate squared error of the nd-draw mean trajectory against the
  GP state estimates, summed over all output times, t0 included.

Each screen takes one problem (q0 of shape (r,)) or L problems at once,
one per trajectory (q0 of shape (L, r), and a leading L on every
per-problem argument); the L problems share the operator draws and the
time grid.

Two implementations with one contract, both float32 (the screening
contract; posteriors and final ensembles stay float64):

* ``quadratic_ensemble_screen_cuda``: the hand-written Hopper kernel
  ``csrc/quadratic_screen.cu`` (see its header for the design), all L
  problems in one launch: templated instances up to
  ``TEMPLATED_MAX_STATE`` modes, a kernel that takes r at run time above;
* ``quadratic_ensemble_screen_torch``: the plain PyTorch version, a
  batched (N, r) RK4 with a feature concat and an einsum, one problem
  after another.

``quadratic_ensemble_screen`` dispatches on the tensors' device: CPU
tensors take the plain version, CUDA tensors the kernel, which raises on
any failure. Nothing falls back from one to the other.
"""

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .quadratic import ckron_indices

DIVERGE_CAP = 1e6  # must dominate any stability envelope
MAX_DRAWS_PER_CANDIDATE = 32  # the kernels' limit, as the reference's
#: The largest r of kernel A's templated instances (the row in registers);
#: above it the runtime-r kernel screens.
TEMPLATED_MAX_STATE = 12

#: Kernel launches made by ``quadratic_ensemble_screen_cuda`` in this
#: process. Callers may reset it to 0 to count the launches of one run.
launches = 0


def warps_per_candidate(r: int, nd: int, templated: bool = True) -> int:
    """Warps that a candidate's nd draws take in the kernels' layouts
    (``csrc/screen_common.cuh``). The templated instances give each draw
    the power of two >= r lanes, one per operator row, several draws to a
    warp; the runtime-dimension kernels give each draw a warp of its own,
    so the count is nd."""
    if not templated:
        return nd
    lanes = 1 << (r - 1).bit_length()
    return -(-nd // max(32 // lanes, 1))


def problem_count(q0: torch.Tensor, per_problem: Dict[str, Tuple[Optional[torch.Tensor], int]]):
    """None for the single-problem form (q0 of shape (r,)); L for the
    batched form, q0 of shape (L, r). ``per_problem`` maps each other
    per-problem argument's name to (tensor or None, its rank in the
    single form); in the batched form each must carry one more axis, of
    length L. Raises ValueError otherwise."""
    if q0.ndim == 1:
        return None
    if q0.ndim != 2:
        raise ValueError(f"q0 must be (r,) or (L, r), got {tuple(q0.shape)}")
    L = q0.shape[0]
    for name, (x, rank) in per_problem.items():
        if x is not None and (x.ndim != rank + 1 or x.shape[0] != L):
            raise ValueError(
                f"q0 is (L, r) with L={L}, so {name} needs a leading axis of {L} "
                f"over {rank} more, got {tuple(x.shape)}"
            )
    return L


def check_tensors(tensors, dev) -> None:
    """Raise unless each (tensor, shape) of ``tensors`` is a contiguous
    float32 tensor of that shape on ``dev``."""
    for name, (x, shape) in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, Ohat on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {x.dtype}")


def _plain(Ohat, q0, t_eval, shift, limits, snapshots, nd, substeps, track_error):
    """The plain screen; returns (stable (N,), err_sq (G,), maxdev (N, r)),
    each with a leading L in the batched form (one problem at a time)."""
    if q0.ndim == 2:
        outs = [
            _plain(Ohat, q0[ell], t_eval, shift[ell], limits[ell],
                   None if snapshots is None else snapshots[ell], nd, substeps, track_error)
            for ell in range(q0.shape[0])
        ]
        return tuple(torch.stack(parts) for parts in zip(*outs))
    f32 = torch.float32
    N, r, d = Ohat.shape
    G = N // nd
    O = Ohat.to(f32)
    q = q0.to(f32).expand(N, r)
    shift = shift.to(f32)
    limits = limits.to(f32)
    do_err = track_error and snapshots is not None
    snaps = snapshots.to(f32) if do_err else None
    rows, cols = (torch.as_tensor(i, device=O.device) for i in ckron_indices(r))
    ones = torch.ones((N, 1), dtype=f32, device=O.device)

    def rhs(q):
        feats = torch.cat([ones, q, q[:, rows] * q[:, cols]], dim=1)
        return torch.einsum("nrd,nd->nr", O, feats)

    def clip(x):
        return torch.clamp(x, -DIVERGE_CAP, DIVERGE_CAP)  # keeps NaN

    def err_term(i, q):
        mean = torch.mean(q.reshape(G, nd, r), dim=1)  # (G, r)
        diff = mean - snaps[:, i][None, :]
        return torch.sum(diff * diff, dim=1)

    err = err_term(0, q) if do_err else torch.zeros(G, dtype=f32, device=O.device)
    maxdev = torch.abs(q - shift)
    t = t_eval.to(f32)
    # Step sizes in float32, as the kernel computes them; each is exact as
    # a Python float, and 0.5 h and h / 6 round as they do in float32.
    hs = ((t[1:] - t[:-1]) / substeps).tolist()
    for i, h in enumerate(hs, start=1):
        for _ in range(substeps):
            k1 = rhs(q)
            k2 = rhs(clip(q + 0.5 * h * k1))
            k3 = rhs(clip(q + 0.5 * h * k2))
            k4 = rhs(clip(q + h * k3))
            q = clip(q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))
        maxdev = torch.maximum(maxdev, torch.abs(q - shift))  # keeps NaN
        if do_err:
            err = err + err_term(i, q)
    stable = torch.all((maxdev <= limits) & torch.isfinite(maxdev), dim=1)
    return stable, err, maxdev


def quadratic_ensemble_screen_torch(
    Ohat, q0, t_eval, shift, limits, snapshots=None, nd: int = 20,
    substeps: int = 4, track_error: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch screen; same arguments and results as
    ``quadratic_ensemble_screen``."""
    problem_count(q0, {"shift": (shift, 1), "limits": (limits, 1),
                       "snapshots": (snapshots if track_error else None, 2)})
    stable, err, _ = _plain(
        Ohat, q0, t_eval, shift, limits, snapshots, nd, substeps, track_error
    )
    return stable, err


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load_library

    lib = load_library("quadratic_screen")
    for fn in (lib.gpboi_quadratic_screen, lib.gpboi_quadratic_screen_any_r):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def quadratic_ensemble_screen_cuda(
    Ohat, q0, t_eval, shift, limits, snapshots=None, nd: int = 20,
    substeps: int = 4, track_error: bool = True, any_r: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel; same arguments and results as
    ``quadratic_ensemble_screen``, but every tensor must be a contiguous
    float32 tensor on one CUDA device. One launch for all problems.
    Raises on anything the kernel does not take and on a failed launch.

    ``any_r`` takes the runtime-r kernel at every r, which otherwise
    screens only above ``TEMPLATED_MAX_STATE``: ``chip_smoke.py`` holds
    it against the templated instances with it."""
    global launches
    dev = Ohat.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA screen needs CUDA tensors, got {dev}")
    if Ohat.ndim != 3 or Ohat.shape[1] < 1:
        raise ValueError(f"Ohat must be (N, r, d) with r >= 1, got {tuple(Ohat.shape)}")
    N, r, d = Ohat.shape
    k = t_eval.shape[0]
    if d != 1 + r + r * (r + 1) // 2:
        raise ValueError(f"Ohat has d={d} columns; a 'cAH' ROM with r={r} has "
                         f"{1 + r + r * (r + 1) // 2}")
    if not 1 <= nd <= MAX_DRAWS_PER_CANDIDATE or N % nd:
        raise ValueError(f"need 1 <= nd <= {MAX_DRAWS_PER_CANDIDATE} and "
                         f"N % nd == 0, got N={N}, nd={nd}")
    if substeps < 1 or k < 1:
        raise ValueError(f"need substeps >= 1 and k >= 1, got {substeps}, {k}")
    track = track_error and snapshots is not None
    L = problem_count(q0, {"shift": (shift, 1), "limits": (limits, 1),
                           "snapshots": (snapshots if track else None, 2)})
    lead = () if L is None else (L,)
    tensors = {
        "Ohat": (Ohat, (N, r, d)), "q0": (q0, lead + (r,)), "t_eval": (t_eval, (k,)),
        "shift": (shift, lead + (r,)), "limits": (limits, lead + (r,)),
    }
    if track:
        tensors["snapshots"] = (snapshots, lead + (r, k))
    check_tensors(tensors, dev)

    any_r = any_r or r > TEMPLATED_MAX_STATE
    n_prob, G, W = L or 1, N // nd, warps_per_candidate(r, nd, templated=not any_r)
    stable = torch.empty((n_prob, N), dtype=torch.bool, device=dev)
    err_sq = torch.zeros((n_prob, G), dtype=torch.float32, device=dev)
    partial = torch.empty(n_prob * G * W * k * r if track else 0, dtype=torch.float32, device=dev)
    lib = _library()
    screen = lib.gpboi_quadratic_screen_any_r if any_r else lib.gpboi_quadratic_screen
    with torch.cuda.device(dev):
        rc = screen(
            Ohat.data_ptr(), q0.data_ptr(), t_eval.data_ptr(), shift.data_ptr(),
            limits.data_ptr(), snapshots.data_ptr() if track else None,
            n_prob, N, r, nd, W, k, substeps, stable.data_ptr(),
            partial.data_ptr() if track else None, err_sq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quadratic_screen launch failed: error {rc}")
    launches += 1
    return (stable[0], err_sq[0]) if L is None else (stable, err_sq)


def quadratic_ensemble_screen(
    Ohat: torch.Tensor,
    q0: torch.Tensor,
    t_eval: torch.Tensor,
    shift: torch.Tensor,
    limits: torch.Tensor,
    snapshots: Optional[torch.Tensor] = None,
    nd: int = 20,
    substeps: int = 4,
    track_error: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Screen all candidate/draw ROM integrations of one or L problems.

    Parameters
    ----------
    Ohat : (N, r, d) operators, N = G * nd, each candidate's draws
        contiguous, shared by all problems; cast to float32.
    q0, shift, limits : (r,) initial state and stability envelope, or
        (L, r) for L problems.
    t_eval : (k,) output times.
    snapshots : (r, k) error target, (L, r, k) for L problems, or None.
    nd : draws per candidate. substeps : RK4 steps per output interval.

    Returns
    -------
    stable : (N,) bool. err_sq : (G,) float32, zeros when
    ``track_error`` is False or ``snapshots`` is None. Both with a leading
    L for L problems.
    """
    if Ohat.device.type == "cuda":
        f32 = [
            None if x is None else x.to(torch.float32).contiguous()
            for x in (Ohat, q0, t_eval, shift, limits, snapshots)
        ]
        return quadratic_ensemble_screen_cuda(*f32, nd, substeps, track_error)
    if Ohat.device.type == "cpu":
        return quadratic_ensemble_screen_torch(
            Ohat, q0, t_eval, shift, limits, snapshots, nd, substeps, track_error
        )
    raise ValueError(f"no screen for device {Ohat.device}")
