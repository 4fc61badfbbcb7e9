"""The windowed regularization search of the production-scale pipeline
(counterpart of ``gp_bayesopinf_tpu/pipeline/scaled.py``: ``window_errors``,
the scalar, blocked and gamma samplers, the grid screens, ``_golden_vec``
and both refinements).

One objective serves the grid and the refinement: ``window_errors`` draws
20 operator samples per (candidate, window), integrates every (candidate,
draw, window) in ONE batched RK4 call, and scores each window by the
relative error of its draw mean, 1e12 where a draw leaves the envelope.
Row problem (w, i) sees only the regularizer of window w, and window w's
rollout only its own rows, so entry w of the result is window w's
objective whatever the other entries: one call evaluates W objectives.

The screen runs in the dtype of the ``WindowProblem`` it is given
(float32 for the search, as the screens of the other pipelines; the
final ensembles take a float64 problem).
"""

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...ops.quadratic import ckron
from ...parallel.mesh import sharded_map
from ...rom import GalerkinROM
from ...rom.operators import extract_operators, operator_splits
from ...solve.ivp import CLAMP, stability_mask
from ...solve.lstsq import WeightedLSTSQ
from .gamma import resolve_gamma

REJECTED = 1e12  # objective of a window with an unstable draw
SCREEN_DRAWS = 20  # draws per candidate, the other pipelines' count
_INVPHI = (np.sqrt(5.0) - 1.0) / 2.0


def rollout(rom: GalerkinROM, ohat: torch.Tensor, q0: torch.Tensor, tw: torch.Tensor):
    """Integrate (..., W, r, d) operator draws of an autonomous ROM over
    the window grids ``tw`` (W, mw) from ``q0`` (W, r) or (..., W, r):
    (..., W, r, mw), all in one batched RK4 loop.

    The arithmetic is ``solve.ivp.rk4_solve``'s with a step size per
    window; the right-hand side c + A q + H ckron(q) is one fused
    multiply-add product per operator block on the flattened batch.
    """
    if set(rom.structure) - set("cAH"):
        raise ValueError(f"the scaled pipeline takes autonomous model forms, not '{rom.structure}'")
    lead, r = ohat.shape[:-2], rom.state_dimension
    ops = extract_operators(ohat.reshape(-1, *ohat.shape[-2:]), rom.structure, r)
    q = q0.expand(lead + (r,)).reshape(-1, r)
    mw = tw.shape[1]
    h = ((tw[:, 1:] - tw[:, :-1]) / rom.substeps).expand(lead + (mw - 1,)).reshape(-1, mw - 1)
    half, sixth = 0.5 * h, h / 6.0
    const = ops["c"][..., None] if "c" in ops else q.new_zeros(q.shape + (1,))

    def rhs(q):
        out = const
        if "A" in ops:
            out = torch.baddbmm(out, ops["A"], q[..., None])
        if "H" in ops:
            out = torch.baddbmm(out, ops["H"], ckron(q, dim=-1)[..., None])
        return out[..., 0]

    out = [q]
    for i in range(mw - 1):
        hi, hh, h6 = h[:, i : i + 1], half[:, i : i + 1], sixth[:, i : i + 1]
        for _ in range(rom.substeps):
            k1 = rhs(q)
            k2 = rhs(torch.addcmul(q, hh, k1))
            k3 = rhs(torch.addcmul(q, hh, k2))
            k4 = rhs(torch.addcmul(q, hi, k3))
            total = torch.add(torch.add(k1, k4), torch.add(k2, k3), alpha=2.0)
            q = torch.clamp(torch.addcmul(q, h6, total), -CLAMP, CLAMP)
        out.append(q)
    return torch.stack(out, dim=-1).reshape(lead + (r, mw))


@dataclasses.dataclass
class WindowProblem:
    """What a screen or an ensemble integrates, in one dtype."""

    rom: GalerkinROM
    sample: Callable  # (params (..., W[, 2]), xi (..., n, W r, d)) -> (..., n, W, r, d)
    states_w: torch.Tensor  # (W, r, mw) GP state estimates, the targets
    tw: torch.Tensor  # (W, mw) window time grids
    shift: torch.Tensor  # (r,) envelope centres; (W, r) with local bases
    limits: torch.Tensor  # (r,) envelope half-widths; (W, r) with local bases
    # Local bases: (T (W, r, r), b (W, r)), window w's end state into
    # window w+1's coordinates, q' = T_w q + b_w (``transfer_maps``); None:
    # one basis, the identity.
    transfer: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def q0s(self) -> torch.Tensor:
        """(W, r): every window starts on its GP estimate."""
        return self.states_w[:, :, 0]

    def envelope(self, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(shift, limits) of window w, each (r,)."""
        if self.shift.ndim == 1:
            return self.shift, self.limits
        return self.shift[w], self.limits[w]

    def hand_over(self, w: int, q: torch.Tensor) -> torch.Tensor:
        """(..., r) end states of window w in the coordinates of window w+1."""
        if self.transfer is None:
            return q
        T, b = self.transfer
        return q @ T[w].T + b[w]

    def integrate(self, ohat: torch.Tensor) -> torch.Tensor:
        """(..., W, r, d) draws -> (..., W, r, mw) window rollouts, every
        window anchored on its own initial state."""
        return rollout(self.rom, ohat, self.q0s, self.tw)

    def window_errors(self, params: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """(..., W) float64 screen errors of the per-window regularizers
        ``params`` on the standard normals ``xi`` (..., n, W r, d); leading
        axes are candidates, integrated together."""
        sols = self.integrate(self.sample(params, xi))  # (..., n, W, r, mw)
        ok = stability_mask(sols, self.shift, self.limits)  # (..., n, W)
        wnorm = torch.linalg.norm(self.states_w, dim=(1, 2))
        err = torch.linalg.norm(sols.mean(dim=-4) - self.states_w, dim=(-2, -1)) / wnorm
        err = err.to(torch.float64)  # float32 has no 1e12
        return torch.where(ok.all(dim=-2) & torch.isfinite(err), err, REJECTED)


def make_sampler(fac: WeightedLSTSQ, regularization: str, W: int, rom: GalerkinROM,
                 tikhonov_gamma=None) -> Callable:
    """The posterior sampler of a regularization mode, on ``fac``'s device
    and dtype: ``sample(params, xi)`` with ``params`` (..., W) (scalar and
    gamma) or (..., W, 2) (blocked: lambda_1 on the c and A columns,
    lambda_2 on the H block) and ``xi`` (..., n, W r, d)."""
    r, d = rom.state_dimension, fac.num_unknowns

    def shaped(draws):
        return draws.unflatten(-2, (W, r))

    if regularization == "scalar":
        return lambda p, xi: shaped(fac.sample(p.repeat_interleave(r, -1), xi=xi, per_row=True))
    if regularization == "blocked":
        quad = torch.zeros(d, dtype=torch.bool, device=fac.S.device)
        for name, a, b in operator_splits(rom.structure, r):
            quad[a:b] = name == "H"
        # The Gram contraction runs once; each (lambda_1, lambda_2) then
        # costs one batched (W r, d, d) Cholesky inside the screen.
        tik = fac.tikhonov()

        def sample(p, xi):
            g = torch.where(quad, p[..., 1:2], p[..., 0:1])  # (..., W, d)
            return shaped(tik.sample(g.repeat_interleave(r, -2), xi=xi))

        return sample
    kind, G = resolve_gamma(tikhonov_gamma, fac.Dt, r, d, W)
    if kind == "diag":
        tik = fac.tikhonov()
        return lambda p, xi: shaped(tik.sample(p.repeat_interleave(r, -1)[..., None] * G, xi=xi))
    mt = fac.matrix_tikhonov(G)
    return lambda p, xi: shaped(mt.sample(p.repeat_interleave(r, -1), xi=xi))


def transfer_maps(bases: torch.Tensor, mus: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact boundary transfer between local window bases (``bases``
    (W, n, r) orthonormal, ``mus`` (W, n) the windows' centres): window w's
    coefficients q map to window w+1's as q' = T_w q + b_w =
    B_{w+1}^T (mu_w + B_w q - mu_{w+1}), so T_w = B_{w+1}^T B_w and b_w =
    B_{w+1}^T (mu_w - mu_{w+1}). The last window carries the identity.
    Returns (T (W, r, r), b (W, r)) in the bases' dtype."""
    r = bases.shape[-1]
    T = torch.einsum("wnr,wns->wrs", bases[1:], bases[:-1])
    b = torch.einsum("wnr,wn->wr", bases[1:], mus[:-1] - mus[1:])
    eye = torch.eye(r, dtype=bases.dtype, device=bases.device)[None]
    return torch.cat([T, eye]), torch.cat([b, b.new_zeros((1, r))])


def build_problem(rom, fac, state_est, tw, regularization, tikhonov_gamma,
                  envelope_floor: float, dtype: torch.dtype, bases=None,
                  mus=None) -> WindowProblem:
    """The ``WindowProblem`` of a run in ``dtype``, from the float64
    factorization ``fac`` of all W r row problems, the GP state estimates
    (W, r, mw) and the window grids (W, mw); with local window bases
    ``bases`` (W, n, r) and their centres ``mus`` (W, n), also the
    boundary transfer between them.

    Each mode's envelope is 5x its amplitude over the whole span, floored
    at ``envelope_floor`` times the largest mode's: a trailing POD mode
    whose GP estimate is (rightly) smoothed to near-flat would otherwise
    reject every draw. 0.0 keeps the strict per-mode rule. Local
    coefficients exist only within their window, so there the envelope is
    per (window, mode), floored within each window.
    """
    W, r, mw = state_est.shape
    states_w = state_est.to(dtype)
    transfer = None
    if bases is not None:
        shift = states_w.mean(dim=2)  # (W, r)
        limits = 5.0 * (states_w - shift[:, :, None]).abs().amax(dim=2)
        if envelope_floor:
            limits = torch.maximum(limits, envelope_floor * limits.amax(dim=1, keepdim=True))
        transfer = transfer_maps(bases.to(dtype), mus.to(dtype))
    else:
        full = states_w.transpose(0, 1).reshape(r, W * mw)
        shift = full.mean(dim=1)
        limits = 5.0 * (full - shift[:, None]).abs().amax(dim=1)
        if envelope_floor:
            limits = torch.maximum(limits, envelope_floor * limits.max())
    fac = WeightedLSTSQ(*(x.to(dtype) for x in fac))
    sample = make_sampler(fac, regularization, W, rom, tikhonov_gamma)
    return WindowProblem(rom, sample, states_w, tw.to(dtype), shift, limits, transfer)


def grid_screen(problem: WindowProblem, grid: np.ndarray, xi, blocked: bool,
                mesh=None) -> np.ndarray:
    """Screen errors of every grid candidate in every window: (g, W), or
    (g, g, W) for the blocked pair grid (lambda_1 down, lambda_2 across).

    ``xi`` is (g, n, W r, d), each candidate its own draws; for the pair
    grid it is ONE set (n, W r, d) shared by all g^2 candidates: with so
    many candidates independent screens would hand the argmin to the
    luckiest draws, while common draws make the screen a smooth surface
    of the pair. The pair grid is integrated a row of g candidates at a
    time. With a ``mesh`` the candidates (the pair grid's rows) are split
    over "draw" and gathered (``parallel.mesh.sharded_map``)."""
    W = problem.tw.shape[0]
    dt, dev = problem.tw.dtype, problem.tw.device
    g = torch.as_tensor(grid, dtype=dt, device=dev)
    if not blocked:
        def screen(idx):
            return problem.window_errors(g[idx][:, None].expand(-1, W), xi[idx])
    else:
        pairs = torch.stack(torch.meshgrid(g, g, indexing="ij"), dim=-1)  # (g, g, 2)

        def screen(idx):
            return torch.stack([
                problem.window_errors(row[:, None, :].expand(-1, W, -1),
                                      xi.expand(len(g), *xi.shape))
                for row in pairs[idx]
            ])
    errs = screen(slice(None)) if mesh is None else sharded_map(
        lambda idx: screen(idx.to(dev)), len(g), mesh, "draw")
    errs = errs.cpu().numpy()
    dead = np.all(errs.reshape(-1, W) >= REJECTED, axis=0)
    if dead.any():
        where = f" in window(s) {np.flatnonzero(dead).tolist()}" if W > 1 else ""
        raise ValueError(
            f"scaled grid search failed: every candidate unstable{where} "
            "(extend the grid or increase num_regression_points)"
        )
    return errs


def golden_vec(fn, x0_log, f0, lo, hi, iters=12):
    """Bounded golden-section descent in log10 space, all W windows in
    lockstep.

    ``fn`` maps (W,) log10 parameters to (W,) screen errors on one frozen
    set of draws, one call for all windows. ``x0_log`` and ``f0`` seed the
    incumbents, kept wherever nothing better is found; a window with
    ``lo == hi`` is inactive and rides along. Returns the best (log10
    parameter, error) per window over all evaluated points.
    """
    best_x = np.asarray(x0_log, np.float64).copy()
    best_f = np.asarray(f0, np.float64).copy()
    a = np.asarray(lo, np.float64).copy()
    b = np.asarray(hi, np.float64).copy()

    def _eval(x):
        v = np.asarray(fn(x), np.float64)
        take = v < best_f
        best_f[take] = v[take]
        best_x[take] = x[take]
        return v

    c = b - _INVPHI * (b - a)
    dpt = a + _INVPHI * (b - a)
    fc, fd = _eval(c), _eval(dpt)
    for _ in range(iters):
        left = fc < fd
        a = np.where(left, a, c)
        b = np.where(left, dpt, b)
        new_c = b - _INVPHI * (b - a)
        new_d = a + _INVPHI * (b - a)
        x = np.where(left, new_c, new_d)
        fx = _eval(x)
        c, dpt, fc, fd = (
            np.where(left, new_c, dpt),
            np.where(left, c, new_d),
            np.where(left, fx, fd),
            np.where(left, fc, fx),
        )
    return best_x, best_f


def frozen_objective(problem: WindowProblem, xi_refine: torch.Tensor) -> Callable:
    """``single(params)``: (W,) or (W, 2) NumPy regularizers -> (W,)
    float64 screen errors on the frozen draws ``xi_refine`` (n, W r, d)."""
    dt, dev = problem.tw.dtype, problem.tw.device

    def single(params):
        p = torch.as_tensor(np.asarray(params), dtype=dt, device=dev)
        return problem.window_errors(p, xi_refine).cpu().numpy()

    return single


def refine_scalar(single: Callable, grid: np.ndarray, errs: np.ndarray) -> np.ndarray:
    """Per-window winners of the (g, W) grid errors, refined between their
    grid neighbours on the frozen draws: (W,) regularizers.

    A winner at an end of the grid keeps its grid value (the grid spans 18
    decades: an end means the problem, not the grid, is out of scale). The
    winners are evaluated again on the frozen draws, so that the descent
    compares like with like."""
    logg = np.log10(grid)
    last = len(grid) - 1
    ibest = np.argmin(errs, axis=0)  # (W,)
    active = (ibest > 0) & (ibest < last)
    logbest = logg[ibest]
    if not active.any():
        return 10.0**logbest
    lo = np.where(active, logg[np.maximum(ibest - 1, 0)], logbest)
    hi = np.where(active, logg[np.minimum(ibest + 1, last)], logbest)
    best_log, _ = golden_vec(lambda xl: single(10.0**xl), logbest, single(grid[ibest]), lo, hi)
    return 10.0**best_log


def refine_blocked(single: Callable, grid: np.ndarray, errs: np.ndarray) -> np.ndarray:
    """Per-window winners of the (g, g, W) pair-grid errors, refined on
    the frozen draws: (W, 2) regularizers (lambda_1, lambda_2).

    First a polish along the diagonal lambda_1 = lambda_2 between the
    best diagonal cell's neighbours (no worse than the scalar search),
    then two sweeps of coordinate descent on (log lambda_1, log
    lambda_2), one grid cell either side of the incumbent."""
    logg = np.log10(grid)
    g, W = len(grid), errs.shape[-1]
    cell = logg[1] - logg[0]
    pair_fn = lambda p_log: single(10.0**p_log)

    i1, i2 = np.unravel_index(np.argmin(errs.reshape(g * g, W), axis=0), (g, g))
    best_x = np.stack([logg[i1], logg[i2]], axis=-1)  # (W, 2) log10
    best_f = pair_fn(best_x)

    idiag = np.argmin(np.diagonal(errs, axis1=0, axis2=1).T, axis=0)  # (W,)
    both = lambda xl: np.stack([xl, xl], axis=-1)
    dx, df = golden_vec(
        lambda xl: pair_fn(both(xl)), logg[idiag], pair_fn(both(logg[idiag])),
        logg[np.maximum(idiag - 1, 0)], logg[np.minimum(idiag + 1, g - 1)],
    )
    take = df < best_f
    best_x[take] = both(dx)[take]
    best_f[take] = df[take]

    for _ in range(2):
        for coord in (0, 1):

            def coord_fn(xl, coord=coord):
                p = best_x.copy()
                p[:, coord] = xl
                return pair_fn(p)

            cx, cf = golden_vec(
                coord_fn, best_x[:, coord], best_f,
                best_x[:, coord] - cell, best_x[:, coord] + cell,
            )
            take = cf < best_f
            best_x[take, coord] = cx[take]
            best_f[take] = cf[take]
    return 10.0**best_x
