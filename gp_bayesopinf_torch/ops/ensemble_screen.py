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
  problems in one launch, by one of four kernel families: the wrapper
  chooses (``screen_family``) the templated instances up to
  ``TEMPLATED_MAX_STATE`` modes, the capacity-templated kernel up to
  ``CAPACITY_MAX_STATE`` (instances ``CAPACITY_INSTANCES``) and the wide
  kernel above; ``family=`` forces one, and only forcing takes the
  runtime-r kernel (``"runtime"``, the yardstick the others are held
  against on the card);
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
#: The largest r of kernel A's templated instances (the row in registers).
TEMPLATED_MAX_STATE = 12
#: The capacities of the capacity-templated kernel (r <= capacity at run
#: time, the smallest instance that holds r); above the largest, the wide
#: kernel screens.
CAPACITY_INSTANCES = (16, 32)
CAPACITY_MAX_STATE = CAPACITY_INSTANCES[-1]
#: The kernel families of both screens, by the code their C entries take.
FAMILIES = ("templated", "capacity", "runtime", "wide")
#: The families the wrappers choose by themselves, in order of preference;
#: the runtime kernels run only when forced.
CHOSEN = ("templated", "capacity", "wide")

#: Kernel launches made by ``quadratic_ensemble_screen_cuda`` in this
#: process. Callers may reset it to 0 to count the launches of one run.
launches = 0
#: The same launches by kernel family (``FAMILIES``), reset with it.
family_launches = dict.fromkeys(FAMILIES, 0)


def warps_per_candidate(r: int, nd: int, templated: bool = True) -> int:
    """Per-draw sums of a candidate in the kernels' layouts
    (``csrc/screen_common.cuh``): warps for the templated instances, which
    give each draw the power of two >= r lanes, one per operator row,
    several draws to a warp; nd for the other families, which give each
    draw a warp (capacity and runtime) or a block (wide) of its own."""
    if not templated:
        return nd
    lanes = 1 << (r - 1).bit_length()
    return -(-nd // max(32 // lanes, 1))


def pick_family(dims: str, fits: Dict[str, bool], family: Optional[str]) -> str:
    """The first family of ``CHOSEN`` whose dimensions fit (``fits``
    maps each of ``FAMILIES`` to whether it takes ``dims``), or ``family``
    when given, which must fit. Raises ValueError otherwise."""
    if family is None:
        return next(f for f in CHOSEN if fits[f])
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    if not fits[family]:
        raise ValueError(f"the {family} kernel does not take {dims}")
    return family


def screen_family(r: int, family: Optional[str] = None) -> str:
    """The kernel family that screens state dimension r: ``"templated"``
    up to ``TEMPLATED_MAX_STATE``, ``"capacity"`` up to
    ``CAPACITY_MAX_STATE``, ``"wide"`` above; ``family`` forces one,
    which must take r (``"runtime"`` and ``"wide"`` take every r). Raises
    ValueError otherwise."""
    if r < 1:
        raise ValueError(f"need r >= 1, got {r}")
    fits = {"templated": r <= TEMPLATED_MAX_STATE, "capacity": r <= CAPACITY_MAX_STATE,
            "runtime": True, "wide": True}
    return pick_family(f"r={r}", fits, family)


def capacity_instance(r: int, instances: Tuple[int, ...] = CAPACITY_INSTANCES) -> int:
    """The capacity the C entry picks for r: the smallest instance >= r."""
    return next(c for c in instances if r <= c)


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
    fn = lib.gpboi_quadratic_screen
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


def quadratic_ensemble_screen_cuda(
    Ohat, q0, t_eval, shift, limits, snapshots=None, nd: int = 20,
    substeps: int = 4, track_error: bool = True, family: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel; same arguments and results as
    ``quadratic_ensemble_screen``, but every tensor must be a contiguous
    float32 tensor on one CUDA device. One launch for all problems.
    Raises on anything the kernel does not take and on a failed launch.

    ``family`` forces a kernel family (``screen_family``), which must take
    r: ``"runtime"`` takes the runtime-r kernel and ``"wide"`` the wide
    kernel at every r, and ``"capacity"`` the capacity-templated one at
    every r it holds, so that ``chip_smoke.py`` holds each against the
    others."""
    global launches
    dev = Ohat.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA screen needs CUDA tensors, got {dev}")
    if Ohat.ndim != 3 or Ohat.shape[1] < 1:
        raise ValueError(f"Ohat must be (N, r, d) with r >= 1, got {tuple(Ohat.shape)}")
    N, r, d = Ohat.shape
    family = screen_family(r, family)
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

    n_prob, G = L or 1, N // nd
    W = warps_per_candidate(r, nd, templated=family == "templated")
    stable = torch.empty((n_prob, N), dtype=torch.bool, device=dev)
    err_sq = torch.zeros((n_prob, G), dtype=torch.float32, device=dev)
    partial = torch.empty(n_prob * G * W * k * r if track else 0, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.gpboi_quadratic_screen(
            Ohat.data_ptr(), q0.data_ptr(), t_eval.data_ptr(), shift.data_ptr(),
            limits.data_ptr(), snapshots.data_ptr() if track else None,
            n_prob, N, r, nd, W, k, substeps, FAMILIES.index(family), stable.data_ptr(),
            partial.data_ptr() if track else None, err_sq.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quadratic_screen launch failed: error {rc}")
    launches += 1
    family_launches[family] += 1
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
