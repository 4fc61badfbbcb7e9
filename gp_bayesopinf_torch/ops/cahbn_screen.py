"""Implicit SDIRK2 ensemble screen of "cAHBN" ROM posterior draws with
time-dependent inputs (counterpart of
``gp_bayesopinf_tpu/ops/ensemble_pallas.py``, ``cahbn_ensemble_screen``,
its XLA twin and ``_input_stage_times``).

Same contract as ``ops.ensemble_screen``: the regularization search
needs per-draw stability flags and per-candidate squared errors of the
nd-draw mean, for G candidates x nd draws of

    dq/dt = c + A q + H ckron(q) + B u + N (u ⊗ q),

integrated with the 2-stage L-stable SDIRK (gamma = 1 - sqrt(2)/2),
``newton_iters`` full Newton steps per stage on the analytic Jacobian and
an unpivoted elimination per draw, the inputs read from a table of u at
every time the integrator touches (``input_stage_times``), the state
clipped to +-1e6 after every substep, NaN kept.

One problem (q0 of shape (r,)) or L problems at once, one per
trajectory (a leading L on q0, shift, limits, u_stages and snapshots),
as in ``ops.ensemble_screen``.

Two implementations with one contract, both float32:

* ``cahbn_ensemble_screen_cuda``: the hand-written Hopper kernel
  ``csrc/cahbn_screen.cu`` (see its header for the design), all L
  problems in one launch, by one of four kernel families: the wrapper
  chooses (``screen_family``) the templated instances up to
  ``TEMPLATED_MAX_STATE`` modes with ``TEMPLATED_MAX_INPUT`` inputs, the
  capacity-templated kernel up to ``CAPACITY_MAX_STATE`` modes (instances
  ``CAPACITY_INSTANCES``) with ``CAPACITY_MAX_INPUT`` inputs and the wide
  kernel beyond; ``family=`` forces one, and only forcing takes the
  runtime-(r, nu) kernel (``"runtime"``);
* ``cahbn_ensemble_screen_torch``: the plain PyTorch version, batched
  (N, r) states with the XLA twin's algorithm, one problem after another.

``cahbn_ensemble_screen`` dispatches on the tensors' device: CPU tensors
take the plain version, CUDA tensors the kernel, which raises on any
failure. Nothing falls back from one to the other.
"""

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .ensemble_screen import (
    DIVERGE_CAP,
    FAMILIES,
    MAX_DRAWS_PER_CANDIDATE,
    capacity_instance as _capacity_instance,
    check_tensors,
    pick_family,
    problem_count,
    warps_per_candidate,
)
from .quadratic import ckron_indices, ckron_jacobian_pattern
from ..solve.ivp import GAMMA, solve_small

#: The largest r and nu of kernel B's templated instances (the row and the
#: Newton matrix in registers; r up to the reference's SMALL_SOLVE_MAX).
TEMPLATED_MAX_STATE = 8
TEMPLATED_MAX_INPUT = 2
#: The capacities of the capacity-templated kernel (r and nu at most a
#: capacity at run time, the smallest state instance that holds r); beyond
#: either largest, the wide kernel screens.
CAPACITY_INSTANCES = (12, 16)
CAPACITY_MAX_STATE = CAPACITY_INSTANCES[-1]
CAPACITY_MAX_INPUT = 4

#: Kernel launches made by ``cahbn_ensemble_screen_cuda`` in this process.
#: Callers may reset it to 0 to count the launches of one run.
launches = 0
#: The same launches by kernel family (``FAMILIES``), reset with it.
family_launches = dict.fromkeys(FAMILIES, 0)


def screen_family(r: int, nu: int, family: Optional[str] = None) -> str:
    """The kernel family that screens state dimension r with nu inputs:
    ``"templated"`` for r <= ``TEMPLATED_MAX_STATE`` with nu <=
    ``TEMPLATED_MAX_INPUT``, else ``"capacity"`` for r <=
    ``CAPACITY_MAX_STATE`` with nu <= ``CAPACITY_MAX_INPUT``, else
    ``"wide"``; ``family`` forces one, which must take (r, nu)
    (``"runtime"`` and ``"wide"`` take every (r, nu)). Raises ValueError
    otherwise."""
    if r < 1 or nu < 1:
        raise ValueError(f"need r and nu >= 1, got r={r}, nu={nu}")
    fits = {"templated": r <= TEMPLATED_MAX_STATE and nu <= TEMPLATED_MAX_INPUT,
            "capacity": r <= CAPACITY_MAX_STATE and nu <= CAPACITY_MAX_INPUT,
            "runtime": True, "wide": True}
    return pick_family(f"r={r}, nu={nu}", fits, family)


def capacity_instance(r: int) -> int:
    """The capacity the C entry picks for r: the smallest instance >= r."""
    return _capacity_instance(r, CAPACITY_INSTANCES)


def input_stage_times(t_eval: torch.Tensor, substeps: int) -> torch.Tensor:
    """Every time the SDIRK2 integrator evaluates inputs at, flattened to
    ((k-1) substeps 3,): for interval i (0-based) and substep s, entries
    3 (i substeps + s) + 0, 1, 2 hold the substep start t, the first stage
    abscissa t + gamma h and the second, t + h. Computed in ``t_eval``'s
    dtype (float64 for the screen's table, which is cast to float32 at the
    call)."""
    t0 = t_eval[:-1, None]
    h = (t_eval[1:, None] - t0) / substeps
    starts = t0 + h * torch.arange(substeps, dtype=t_eval.dtype, device=t_eval.device)
    return torch.stack([starts, starts + GAMMA * h, starts + h], dim=2).reshape(-1)


def _plain(Ohat, q0, t_eval, shift, limits, u_stages, snapshots, nd, substeps,
           newton_iters, track_error):
    """The plain screen; returns (stable (N,), err_sq (G,), maxdev (N, r)),
    each with a leading L in the batched form (one problem at a time)."""
    if q0.ndim == 2:
        outs = [
            _plain(Ohat, q0[ell], t_eval, shift[ell], limits[ell], u_stages[ell],
                   None if snapshots is None else snapshots[ell], nd, substeps,
                   newton_iters, track_error)
            for ell in range(q0.shape[0])
        ]
        return tuple(torch.stack(parts) for parts in zip(*outs))
    f32 = torch.float32
    N, r, d = Ohat.shape
    G = N // nd
    nu = u_stages.shape[-1]
    dev = Ohat.device
    O = Ohat.to(f32)
    q = q0.to(f32).expand(N, r)
    shift = shift.to(f32)
    limits = limits.to(f32)
    u_tab = u_stages.to(f32)
    do_err = track_error and snapshots is not None
    snaps = snapshots.to(f32) if do_err else None

    ofs_B = 1 + r + r * (r + 1) // 2
    A = O[:, :, 1 : 1 + r]
    Nop = O[:, :, ofs_B + nu :].unflatten(-1, (nu, r))  # (N, r, nu, r)
    # The quadratic part of the Jacobian is linear in q: HT[n, i, j, c] q_c.
    HT = torch.einsum("niz,zjc->nijc", O[:, :, 1 + r : ofs_B], ckron_jacobian_pattern(r, f32, dev))
    rows, cols = (torch.as_tensor(i, device=dev) for i in ckron_indices(r))
    ones = torch.ones((N, 1), dtype=f32, device=dev)
    eye = torch.eye(r, dtype=f32, device=dev)

    def rhs(q, u):
        uq = (u[:, None] * q[:, None, :]).reshape(N, nu * r)
        feats = torch.cat([ones, q, q[:, rows] * q[:, cols], u.expand(N, nu), uq], dim=1)
        return torch.einsum("nrd,nd->nr", O, feats)

    def solve_stage(u, q_base, hg, kk):
        A_u = A + torch.einsum("niaj,a->nij", Nop, u)  # A + sum_a u_a N_a
        for _ in range(newton_iters):
            x = q_base + hg * kk
            F = kk - rhs(x, u)
            J = A_u + torch.einsum("nijc,nc->nij", HT, x)
            kk = kk - solve_small(eye - hg * J, F)
        return kk

    def clip(x):
        return torch.clamp(x, -DIVERGE_CAP, DIVERGE_CAP)  # keeps NaN

    def err_term(i, q):
        mean = torch.mean(q.reshape(G, nd, r), dim=1)  # (G, r)
        diff = mean - snaps[:, i][None, :]
        return torch.sum(diff * diff, dim=1)

    err = err_term(0, q) if do_err else torch.zeros(G, dtype=f32, device=dev)
    maxdev = torch.abs(q - shift)
    # Scalar coefficients rounded as the kernel and the XLA twin compute
    # them, in float32; each is exact as a Python float.
    g32, omg32 = np.float32(GAMMA), np.float32(1.0 - GAMMA)
    t = t_eval.to(f32)
    hs = ((t[1:] - t[:-1]) / substeps).tolist()
    for i, h in enumerate(hs):
        h = np.float32(h)
        hg, h1 = float(h * g32), float(h * omg32)
        for s in range(substeps):
            row = 3 * (i * substeps + s)
            k1 = solve_stage(u_tab[row + 1], q, hg, rhs(q, u_tab[row]))
            k2 = solve_stage(u_tab[row + 2], q + h1 * k1, hg, k1)
            q = clip(q + float(h) * (float(omg32) * k1 + float(g32) * k2))
        maxdev = torch.maximum(maxdev, torch.abs(q - shift))  # keeps NaN
        if do_err:
            err = err + err_term(i + 1, q)
    stable = torch.all((maxdev <= limits) & torch.isfinite(maxdev), dim=1)
    return stable, err, maxdev


def cahbn_ensemble_screen_torch(
    Ohat, q0, t_eval, shift, limits, u_stages, snapshots=None, nd: int = 20,
    substeps: int = 2, newton_iters: int = 6, track_error: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch screen; same arguments and results as
    ``cahbn_ensemble_screen``."""
    problem_count(q0, {"shift": (shift, 1), "limits": (limits, 1), "u_stages": (u_stages, 2),
                       "snapshots": (snapshots if track_error else None, 2)})
    stable, err, _ = _plain(Ohat, q0, t_eval, shift, limits, u_stages, snapshots,
                            nd, substeps, newton_iters, track_error)
    return stable, err


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load_library

    lib = load_library("cahbn_screen")
    fn = lib.gpboi_cahbn_screen
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    lib.gpboi_cahbn_wide_scratch.argtypes = [ctypes.c_int] * 2
    lib.gpboi_cahbn_wide_scratch.restype = ctypes.c_longlong
    return lib


def cahbn_ensemble_screen_cuda(
    Ohat, q0, t_eval, shift, limits, u_stages, snapshots=None, nd: int = 20,
    substeps: int = 2, newton_iters: int = 6, track_error: bool = True,
    family: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel; same arguments and results as
    ``cahbn_ensemble_screen``, but every tensor must be a contiguous
    float32 tensor on one CUDA device. One launch for all problems.
    Raises on anything the kernel does not take and on a failed launch.

    ``family`` forces a kernel family (``screen_family``), which must take
    (r, nu): ``"runtime"`` takes the runtime-(r, nu) kernel and
    ``"wide"`` the wide kernel at every dimension, and ``"capacity"`` the
    capacity-templated one at every dimension it holds, so that
    ``chip_smoke.py`` holds each against the others. The wide kernel
    stages each draw's operator in shared memory where it fits; where it
    does not, this wrapper allocates the device scratch its C entry asks
    for (``gpboi_cahbn_wide_scratch``)."""
    global launches
    dev = Ohat.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA screen needs CUDA tensors, got {dev}")
    if Ohat.ndim != 3 or u_stages.ndim not in (2, 3) or 0 in (Ohat.shape[1], u_stages.shape[-1]):
        raise ValueError(f"Ohat must be (N, r, d) and u_stages (n, nu) or (L, n, nu) with r and "
                         f"nu >= 1, got {tuple(Ohat.shape)} and {tuple(u_stages.shape)}")
    N, r, d = Ohat.shape
    nu = u_stages.shape[-1]
    k = t_eval.shape[0]
    family = screen_family(r, nu, family)
    if d != 1 + r + r * (r + 1) // 2 + nu + nu * r:
        raise ValueError(f"Ohat has d={d} columns; a 'cAHBN' ROM with r={r}, "
                         f"nu={nu} has {1 + r + r * (r + 1) // 2 + nu + nu * r}")
    if not 1 <= nd <= MAX_DRAWS_PER_CANDIDATE or N % nd:
        raise ValueError(f"need 1 <= nd <= {MAX_DRAWS_PER_CANDIDATE} and "
                         f"N % nd == 0, got N={N}, nd={nd}")
    if substeps < 1 or k < 1 or newton_iters < 0:
        raise ValueError(f"need substeps >= 1, k >= 1 and newton_iters >= 0, got "
                         f"{substeps}, {k}, {newton_iters}")
    track = track_error and snapshots is not None
    L = problem_count(q0, {"shift": (shift, 1), "limits": (limits, 1),
                           "u_stages": (u_stages, 2),
                           "snapshots": (snapshots if track else None, 2)})
    lead = () if L is None else (L,)
    tensors = {
        "Ohat": (Ohat, (N, r, d)), "q0": (q0, lead + (r,)), "t_eval": (t_eval, (k,)),
        "shift": (shift, lead + (r,)), "limits": (limits, lead + (r,)),
        "u_stages": (u_stages, lead + ((k - 1) * substeps * 3, nu)),
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
    per_block = lib.gpboi_cahbn_wide_scratch(r, nu) if family == "wide" else 0
    scratch = torch.empty(n_prob * N * per_block, dtype=torch.float32, device=dev) \
        if per_block else None
    with torch.cuda.device(dev):
        rc = lib.gpboi_cahbn_screen(
            Ohat.data_ptr(), q0.data_ptr(), t_eval.data_ptr(), u_stages.data_ptr(),
            shift.data_ptr(), limits.data_ptr(), snapshots.data_ptr() if track else None,
            n_prob, N, r, nu, nd, W, k, substeps, newton_iters, FAMILIES.index(family),
            stable.data_ptr(),
            partial.data_ptr() if track else None, err_sq.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"cahbn_screen launch failed: error {rc}")
    launches += 1
    family_launches[family] += 1
    return (stable[0], err_sq[0]) if L is None else (stable, err_sq)


def cahbn_ensemble_screen(
    Ohat: torch.Tensor,
    q0: torch.Tensor,
    t_eval: torch.Tensor,
    shift: torch.Tensor,
    limits: torch.Tensor,
    u_stages: torch.Tensor,
    snapshots: Optional[torch.Tensor] = None,
    nd: int = 20,
    substeps: int = 2,
    newton_iters: int = 6,
    track_error: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Screen all candidate/draw cAHBN ROM integrations of one or L
    problems.

    Parameters
    ----------
    Ohat : (N, r, d) "cAHBN" operators, N = G * nd, each candidate's draws
        contiguous, shared by all problems; cast to float32.
    q0, shift, limits : (r,) initial state and stability envelope, or
        (L, r) for L problems.
    t_eval : (k,) output times.
    u_stages : ((k-1) substeps 3, nu) inputs at ``input_stage_times(t_eval,
        substeps)``, or (L, (k-1) substeps 3, nu) for L problems.
    snapshots : (r, k) error target, (L, r, k) for L problems, or None.
    nd : draws per candidate. substeps : SDIRK2 steps per output interval.
    newton_iters : Newton steps per stage.

    Returns
    -------
    stable : (N,) bool. err_sq : (G,) float32, zeros when
    ``track_error`` is False or ``snapshots`` is None. Both with a leading
    L for L problems.
    """
    args = (Ohat, q0, t_eval, shift, limits, u_stages, snapshots)
    if Ohat.device.type == "cuda":
        f32 = [None if x is None else x.to(torch.float32).contiguous() for x in args]
        return cahbn_ensemble_screen_cuda(*f32, nd, substeps, newton_iters, track_error)
    if Ohat.device.type == "cpu":
        return cahbn_ensemble_screen_torch(*args, nd, substeps, newton_iters, track_error)
    raise ValueError(f"no screen for device {Ohat.device}")
