"""Regularization auto-search: a batched log-grid screen and a bounded
1-D refinement (counterpart of ``gp_bayesopinf_tpu/bayes/regsearch.py``).

For each candidate lambda on a log grid, draw ``ndraws`` posterior
operator samples and integrate each over both the prediction and the
estimation time domains. A candidate is rejected (objective MAXOPTVAL)
if any draw is unstable or the posterior is not SPD; otherwise it scores
the relative error of the draw mean against the GP state estimates. A
grid best at an endpoint widens the bounds; the bounded scalar
minimization between the best's neighbours then refines it on one
frozen set of draws; if it fails, the search falls back to the grid
best or raises, as the caller chooses.

Where the ROM allows, every candidate's integrations go through an
ensemble-screen kernel: the RK4 screen (``ops.ensemble_screen``) for an
autonomous "cAH" ROM, the implicit SDIRK2 screen (``ops.cahbn_screen``)
for a "cAHBN" dirk2 ROM with per-trajectory inputs. Each takes its Hopper
kernel for CUDA tensors and its plain PyTorch version for CPU tensors. A
parametric truth model whose right-hand side is itself quadratic (SEIRD)
takes the same RK4 screen through a ``KernelScreenSpec`` and an
``operator_map`` from parameter draws to operator rows.

Any other ROM form ("cA", "cAHBN" with rk4, ...), and any ROM under
``use_kernel=False``, takes the generic objective: ``rom.predict`` on the
candidates' draws, all candidates of a chunk in one batched integration,
with the integrators' 1e18 clip in place of the kernels' 1e6.

With a ``mesh`` the grid's chunks are split over one of its axes (the
JAX package's ``_mesh_sharded_grid``): each rank screens one chunk of one
device's, through the same objective, kernels included, and the errors
are gathered. The refinement runs on every rank, and rank 0's choice is
broadcast.
"""

import logging
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import scipy.optimize
import torch

from ..ops.cahbn_screen import cahbn_ensemble_screen, input_stage_times
from ..ops.ensemble_screen import quadratic_ensemble_screen
from ..parallel.mesh import axis_index, axis_size, broadcast_from_first, gather_leading_axis
from ..solve.ivp import stability_mask
from ..solve.lstsq import WeightedLSTSQ

MAXOPTVAL = 1e12  # objective ceiling of a rejected candidate
DEFAULT_GRID_PDE = np.logspace(-16, 4, 81)
DEFAULT_GRID_ODE = np.logspace(-16, 5, 22)
CHUNK = 16  # candidates per screen call; the refine pads to the same width


class RegSearchResult(NamedTuple):
    regularizer: float  # chosen lambda
    grid_best: float  # best grid point
    grid_errors: np.ndarray  # (G,) objective per grid candidate
    refined: bool  # True if the 1-D refinement succeeded


class KernelScreenSpec(NamedTuple):
    """What the screen reads off a ``GalerkinROM``, for a search without
    one: a parametric truth model whose right-hand side is quadratic
    (SEIRD2, whose parameter draws become "cAH" operator rows through
    ``SEIRD2.cah_operators``) passes this as ``rom`` together with
    ``operator_map``."""

    structure: str  # "cAH" (autonomous) or "cAHBN" (with inputs)
    state_dimension: int
    substeps: int = 4
    input_dimension: int = 0
    ivp_method: str = "rk4"


def _kernel_objective(
    lstsq: WeightedLSTSQ, rom, initial_conditions, t_pred, t_est,
    snapshots_est, ndraws: int, input_funcs: Optional[Sequence[Callable]],
    operator_map: Optional[Callable] = None,
):
    """Batched objective: (lams (C,), xi (C, ndraws, rows, cols)) -> (C,)
    float64 objective values on the host."""
    L = snapshots_est.shape[0]
    r = rom.state_dimension
    shifts = torch.mean(snapshots_est, dim=2)  # (L, r)
    limits = 5.0 * torch.amax(torch.abs(snapshots_est - shifts[:, :, None]), dim=2)
    norms = torch.sqrt(torch.sum(snapshots_est**2, dim=(1, 2))).to(torch.float32)

    grids = {"pred": t_pred, "est": t_est}
    # One screen call per time grid screens all L trajectories (the
    # kernels take them in one launch).
    if rom.structure == "cAH":
        def screen(ohats, which, snaps=None, **kw):
            return quadratic_ensemble_screen(
                ohats, initial_conditions, grids[which], shifts, limits, snaps,
                nd=ndraws, substeps=rom.substeps, **kw,
            )
    else:  # "cAHBN": the implicit screen, inputs tabulated at every stage time
        # Input functions map (n,) times to (m, n); the screen takes (L, n, m).
        u_tables = {
            which: torch.stack([f(input_stage_times(t, rom.substeps)).T for f in input_funcs])
            for which, t in grids.items()
        }

        def screen(ohats, which, snaps=None, **kw):
            return cahbn_ensemble_screen(
                ohats, initial_conditions, grids[which], shifts, limits, u_tables[which],
                snaps, nd=ndraws, substeps=rom.substeps, **kw,
            )

    def objective(lams: torch.Tensor, xi: torch.Tensor) -> np.ndarray:
        C = lams.shape[0]
        stable = lstsq.posterior_spd(lams)  # (C,)
        draws = lstsq.sample(lams, xi=xi).flatten(0, 1)  # (C ndraws, rows, cols)
        # A parametric model's draws become operator rows here (SEIRD2:
        # (1, 4) parameter rows -> (5, 21) "cAH" operators).
        ohats = draws.reshape(C * ndraws, r, -1) if operator_map is None else operator_map(draws)
        st_p, _ = screen(ohats, "pred", track_error=False)  # (L, C ndraws)
        st_e, err_sq = screen(ohats, "est", snapshots_est)  # (L, C ndraws), (L, C)
        # Combined in trajectory order, as the reference does.
        err = torch.zeros(C, dtype=torch.float32, device=lams.device)
        for ell in range(L):
            stable = stable & torch.all((st_p[ell] & st_e[ell]).reshape(C, ndraws), dim=1)
            err = err + torch.sqrt(err_sq[ell]) / norms[ell]
        err = err / L
        ok = stable & torch.isfinite(err)
        return torch.where(ok, err.to(torch.float64), MAXOPTVAL).cpu().numpy()

    return objective


def _generic_objective(
    lstsq: WeightedLSTSQ, rom, initial_conditions, t_pred, t_est, snapshots_est,
    ndraws: int, input_funcs: Optional[Sequence[Callable]], screen_dtype=None,
):
    """Batched objective through ``rom.predict``, any ROM form: (lams (C,),
    xi (C, ndraws, r, d)) -> (C,) float64 objective values on the host.

    ``screen_dtype`` runs the integrations in reduced precision: they only
    gate stability and rank candidates, and the chosen lambda's posterior
    is rebuilt at full precision afterwards.
    """
    L = snapshots_est.shape[0]
    shifts = torch.mean(snapshots_est, dim=2)  # (L, r)
    limits = 5.0 * torch.amax(torch.abs(snapshots_est - shifts[:, :, None]), dim=2)
    norms = torch.sqrt(torch.sum(snapshots_est**2, dim=(1, 2)))  # (L,)
    cast = (lambda x: x.to(screen_dtype)) if screen_dtype else (lambda x: x)
    t_pred, t_est, q0s = cast(t_pred), cast(t_est), cast(initial_conditions)
    shifts, limits, snaps, norms = cast(shifts), cast(limits), cast(snapshots_est), cast(norms)
    funcs = input_funcs if input_funcs is not None else [None] * L

    def objective(lams: torch.Tensor, xi: torch.Tensor) -> np.ndarray:
        stable = lstsq.posterior_spd(lams)  # (C,)
        ohats = cast(lstsq.sample(lams, xi=xi))  # (C, ndraws, r, d)
        total = 0.0
        for ell in range(L):
            sol_pred = rom.predict(ohats, q0s[ell], t_pred, input_func=funcs[ell])
            sol_est = rom.predict(ohats, q0s[ell], t_est, input_func=funcs[ell])
            ok = stability_mask(sol_pred, shifts[ell], limits[ell]) & stability_mask(
                sol_est, shifts[ell], limits[ell]
            )  # (C, ndraws)
            stable = stable & ok.all(dim=1)
            mean_sol = torch.mean(sol_est, dim=1)  # (C, r, m')
            miss = torch.sqrt(torch.sum((mean_sol - snaps[ell]) ** 2, dim=(1, 2)))
            total = total + miss / norms[ell]
        err = (total / L).to(torch.float64)
        err = torch.where(torch.isfinite(err), err, MAXOPTVAL)
        return torch.where(stable, err, MAXOPTVAL).cpu().numpy()

    return objective


def auto_regularize(
    lstsq: WeightedLSTSQ,
    rom,
    initial_conditions: torch.Tensor,
    t_pred: torch.Tensor,
    t_est: torch.Tensor,
    snapshots_est: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    grid: Optional[np.ndarray] = None,
    ndraws: int = 20,
    verbose: bool = True,
    xi_grid: Optional[torch.Tensor] = None,
    xi_refine: Optional[torch.Tensor] = None,
    input_funcs: Optional[Sequence[Callable]] = None,
    refine_failure: str = "fallback",
    operator_map: Optional[Callable] = None,
    use_kernel: Optional[bool] = None,
    screen_dtype: Optional[torch.dtype] = None,
    mesh=None,
    mesh_axis: str = "draw",
) -> RegSearchResult:
    """Select the regularization hyperparameter lambda.

    Parameters
    ----------
    lstsq : the weighted regression's factorization.
    rom : a ``GalerkinROM``. An autonomous "cAH" one, or a "cAHBN" one
        with ``ivp_method="dirk2"`` together with ``input_funcs``, is
        screened by its kernel; its ``substeps`` set the screen's step.
        Any other form goes through ``rom.predict``. Or a
        ``KernelScreenSpec`` together with ``operator_map``.
    initial_conditions : (L, r) or (r,) initial states, one per trajectory.
    t_pred, t_est : prediction and estimation time grids.
    snapshots_est : (L, r, m') or (r, m') GP state estimates.
    generator : stream for the posterior draws of the screen.
    grid : candidate lambdas (default ``DEFAULT_GRID_PDE``).
    ndraws : posterior draws per candidate (at most 32).
    xi_grid, xi_refine : optional standard normals replacing the draws
        from ``generator``: (G, ndraws, r, d) for the grid, each
        candidate its own, and (ndraws, r, d) for the refinement, one set
        frozen for all its evaluations. The parity tests replay the JAX
        package's random numbers through them.
    input_funcs : for a "cAHBN" ROM, one input function per trajectory,
        mapping (n,) times to (m, n) inputs.
    refine_failure : "fallback" to the grid best when the bounded
        refinement fails (the PDEs pipeline), or "raise" a RuntimeError
        (PDEsMulti).
    operator_map : for a parametric model, the map from a batch of
        regression draws (N, rows, cols) to (N, r, d) "cAH" operator rows
        (``SEIRD2.cah_operators``); the draws' r and d above are then the
        regression's rows and columns.
    use_kernel : None screens through a kernel wherever the ROM is
        eligible; False takes the generic objective (``rom.predict``)
        even then; True raises where the ROM is not eligible.
    screen_dtype : for the generic objective, the precision of the
        screen's integrations (default: the factorization's).
    mesh, mesh_axis : a mesh (``parallel.mesh.make_mesh``) whose axis
        ``mesh_axis`` splits the grid: 16 candidates a rank, one chunk of
        one device's each (the whole grid where it has fewer), padded by
        wrapping; a rank past the grid's end screens a wrapped copy, which
        is discarded. Every rank passes the same arguments and draws (the
        grid's are drawn in their global shape) and gets the same result.
        Each objective call sees the batch that one device's call would,
        so the grid errors are one device's to the bit.
    """
    if refine_failure not in ("fallback", "raise"):
        raise ValueError("refine_failure must be 'fallback' or 'raise'")
    if set("BN") & set(rom.structure) and input_funcs is None:
        raise ValueError(f"a '{rom.structure}' ROM has inputs: pass input_funcs")
    eligible = (rom.structure == "cAH" and rom.input_dimension == 0) or (
        rom.structure == "cAHBN" and rom.ivp_method == "dirk2"
    )
    if use_kernel is None:
        use_kernel = eligible
    elif use_kernel and not eligible:
        raise ValueError(
            "use_kernel requires an autonomous 'cAH' ROM or a 'cAHBN' dirk2 ROM "
            f"with input_funcs, got '{rom.structure}' ({rom.ivp_method})"
        )
    if not use_kernel and not hasattr(rom, "predict"):
        raise ValueError("the generic objective integrates through rom.predict: pass a GalerkinROM")
    if isinstance(rom, KernelScreenSpec) and operator_map is None:
        # Without the map, parameter-row draws would be reshaped into
        # operator rows of the wrong width.
        raise ValueError(
            "a KernelScreenSpec rom requires operator_map (the draw -> "
            "operator-rows expansion, e.g. SEIRD2.cah_operators)"
        )
    grid = DEFAULT_GRID_PDE if grid is None else np.sort(np.atleast_1d(grid))
    initial_conditions = torch.atleast_2d(initial_conditions)
    if snapshots_est.ndim == 2:
        snapshots_est = snapshots_est[None]
    dev, dtype = lstsq.S.device, lstsq.S.dtype
    shape = (ndraws, lstsq.num_problems, lstsq.num_unknowns)
    if use_kernel:
        objective = _kernel_objective(
            lstsq, rom, initial_conditions, t_pred, t_est, snapshots_est, ndraws,
            input_funcs, operator_map,
        )
    else:
        objective = _generic_objective(
            lstsq, rom, initial_conditions, t_pred, t_est, snapshots_est, ndraws,
            input_funcs, screen_dtype,
        )

    G = len(grid)
    if G == 1:
        best_reg = float(grid[0])
        grid_errors = np.array([np.nan])
        bounds = [best_reg / 10.0, best_reg * 10.0]
    else:
        if xi_grid is None:
            xi_grid = torch.randn(
                (G,) + shape, generator=generator, dtype=dtype, device=dev
            )
        grid_t = torch.as_tensor(grid, dtype=dtype, device=dev)
        width = min(CHUNK, G)
        ranks = 1 if mesh is None else axis_size(mesh, mesh_axis)

        def chunk(s):  # one device's chunk from candidate s, wrap padded
            idx = torch.as_tensor(np.arange(s, s + width) % G, device=dev)
            return objective(grid_t[idx], xi_grid[idx])

        parts = []
        for s in range(0, G, width * ranks):
            if mesh is None:
                errs = chunk(s)
            else:
                mine = chunk(s + width * axis_index(mesh, mesh_axis))
                errs = gather_leading_axis(torch.as_tensor(mine, device=dev)[None], mesh,
                                           mesh_axis).flatten().cpu().numpy()
            parts.append(errs[: min(width * ranks, G - s)])
        grid_errors = np.concatenate(parts)
        if verbose:
            for lam, e in zip(grid, grid_errors):
                tag = "UNSTABLE" if e >= MAXOPTVAL else f"{e:.2%} error"
                print(f"reg {lam:.4e}: {tag}")
        if np.all(grid_errors >= MAXOPTVAL):
            raise ValueError("grid search failed: every candidate unstable")
        ibest = int(np.argmin(grid_errors))
        best_reg = float(grid[ibest])
        if ibest == 0:
            print("WARNING: extend regularizer_grid to the left!")
            bounds = [best_reg / 100.0, float(grid[1])]
        elif ibest == G - 1:
            print("WARNING: extend regularizer_grid to the right!")
            bounds = [float(grid[-2]), best_reg * 100.0]
        else:
            bounds = [float(grid[ibest - 1]), float(grid[ibest + 1])]
        logging.info(f"Best regularization via gridsearch: {best_reg:.4e}")
        if verbose:
            print(f"Best regularization via gridsearch: {best_reg:.4e}")

    # Bounded refinement in log10 lambda on ONE frozen set of draws: the
    # bracketing needs a deterministic objective. Each evaluation pads the
    # candidate to the grid's chunk width, so the screen keeps one shape.
    if xi_refine is None:
        xi_refine = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
    width = min(CHUNK, max(G, 1))
    xi_single = xi_refine.expand((width,) + shape)

    def host_objective(logreg):
        lams = torch.full((width,), 10.0**logreg, dtype=dtype, device=dev)
        return float(objective(lams, xi_single)[0])

    opt = scipy.optimize.minimize_scalar(
        host_objective, method="bounded", bounds=np.log10(bounds)
    )
    x, refined = opt.x, bool(opt.success and opt.fun < MAXOPTVAL)
    if mesh is not None:  # no rank may diverge on a last bit
        x, ok = broadcast_from_first(
            torch.tensor([x, refined], dtype=torch.float64, device=dev), mesh
        ).tolist()
        x, refined = np.float64(x), bool(ok)
    if refined:
        chosen = float(10.0**x)
        logging.info(f"Best regularization via optimization: {chosen:.4e}")
        if verbose:
            print(f"Best regularization via optimization: {chosen:.4e}")
    else:
        if refine_failure == "raise":
            raise RuntimeError(
                "regularization refinement failed "
                f"(success={opt.success}, fun={opt.fun!r})"
            )
        chosen, refined = best_reg, False
        logging.info("Regularization optimization failed; using grid best")
        if verbose:
            print("Optimization failed, falling back on gridsearch")
    return RegSearchResult(chosen, best_reg, grid_errors, refined)
