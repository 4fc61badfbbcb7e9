"""``run_scaled``: the production-scale pipeline on one device
(counterpart of ``gp_bayesopinf_tpu/pipeline/scaled.py::run_scaled``).

An Euler-like problem with tens of POD modes, O(10k) snapshot columns and
a large spatial dimension: POD by a randomized range finder, one batched
GP fit over the modes, GP estimation and weighting of every (window,
mode) row problem, one TSQR factorization of them all, the windowed
regularization search and the final ensembles. The global run is the W =
1 case of the time-windowed machinery. With local window bases the front
half runs once per window (its own POD, samples and GP fit) and the back
half takes per-window envelopes and the boundary transfer between bases.

Precision by stage: the snapshot matrix, the POD sketch and the
compressed snapshots are float32 (the one large array and its tall
products); the GP fit, the GP estimation, the weighting and the
factorization are float64; the regularization screen integrates in
float32, like the screens of the other pipelines (it only gates
stability and ranks candidates); the final ensembles are float64 again.

With a mesh (``parallel.mesh.make_mesh`` with axes "draw" and "mode", one
rank a device) every rank runs ``run_scaled`` with the same arguments and
returns the same result. Every random number is drawn in its global shape
on every rank, so that the ranks split world 1's numbers: the snapshot
rows over the whole mesh (randomized POD, the compressed snapshots), the
GP fits and the TSQR's problems over "mode", the TSQR's rows, the grid's
candidates and the ensembles' draws over "draw". The GP estimation, the
refinement and the chained rollouts' bookkeeping run on every rank; the
refinement's decision is rank 0's, broadcast. Sums over ranks run in
another order than on one device, so a mesh changes the numbers at
roundoff.

A run is the span ``experiment``, each stage a child span of its name
(``utils.timing``).
"""

import dataclasses
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...gp.fit import FitResult, fit_gp_hyperparameters, initial_z
from ...gp.nlml import BoxTransform
from ...io.checkpoint import has_checkpoint, load_checkpoint, pipeline_stage_state, save_checkpoint
from ...parallel.mesh import (
    all_reduce_sum, axis_size, broadcast_from_first, gather_leading_axis, shard_leading_axis,
)
from ...parallel.sharded import randomized_pod, tall_skinny_svd
from ...rom import GalerkinROM
from ...solve.lstsq import WeightedLSTSQ
from ...utils import TimedBlock, resolve_device, stage_generators
from ...utils.device import DeviceLike
from ...utils.timing import span
from . import rollout, search
from .data import euler_states, synthetic_states
from .estimate import gp_estimate_windows, gp_estimate_windows_local, weight_windows

#: The stages of a scaled run that draw random numbers.
SCALED_STAGES = ("data", "pod", "sample", "fit", "search", "draws")
#: From this many regression points a window on, "auto" takes the
#: factored low-rank weight root.
LOWRANK_MIN_POINTS = 1024


@dataclasses.dataclass
class ScaledResult:
    num_modes: int
    regularizer: float
    ensemble_mean: np.ndarray  # (r, m')
    stable_fraction: float
    svdvals: np.ndarray
    train_error: float = float("nan")  # ensemble mean against the GP estimates
    grid: Optional[np.ndarray] = None  # candidate regularizers
    grid_errors: Optional[np.ndarray] = None  # 1e12: rejected (unstable)
    regularizer_quad: Optional[float] = None  # blocked: lambda on H
    time_windows: int = 1
    window_regularizers: Optional[np.ndarray] = None  # (W,), or (W, 2) blocked
    window_error: float = float("nan")  # every window anchored on its GP estimate
    chaining: Optional[str] = None  # W > 1: the chosen boundary scheme
    chained_error_mean: float = float("nan")  # ensemble-mean handoff
    chained_error_draws: float = float("nan")  # draw-wise with boundary rescue
    window_basis: str = "global"
    weight_method: str = "chol"  # as resolved: "chol" or "lowrank"
    weight_ranks: Optional[np.ndarray] = None  # (W, r) retained ranks, lowrank only
    # The GP samples and fits; with local bases each carries a leading W.
    sample_times: Optional[np.ndarray] = None  # (m,) times of the GP samples
    samples: Optional[np.ndarray] = None  # (r, m) compressed GP samples
    hyperparameters: Optional[np.ndarray] = None  # (r, 3) fitted sigma^2, ell, chi
    window_bases: Optional[np.ndarray] = None  # local: (W, n, r) float32 POD bases
    window_means: Optional[np.ndarray] = None  # local: (W, n) float32 window centres
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ScaledNormals:
    """Random numbers to use in place of the generators' (each optional):
    the parity tests replay the JAX package's through them. With local
    bases the sample indices, the sketch and the fit starts are per window:
    (W, m/W) indices within each window's block of k/W snapshots, (W, k/W,
    l) and (W, r, restarts + 1, 3)."""

    sample_idx: Optional[np.ndarray] = None  # (m,) sorted snapshot indices of the GP samples
    lift: Optional[torch.Tensor] = None  # (n, r) synthetic source
    noise: Optional[torch.Tensor] = None  # (n, k) either source
    sketch: Optional[torch.Tensor] = None  # (k, l) POD sketch
    z0: Optional[torch.Tensor] = None  # (r, restarts + 1, 3) GP fit starts
    xi_grid: Optional[torch.Tensor] = None  # (g, 20, W r, d); blocked: unused
    xi_refine: Optional[torch.Tensor] = None  # (20, W r, d)
    xi_final: Optional[torch.Tensor] = None  # (ndraws, W r, d)
    xi_chain: Optional[torch.Tensor] = None  # (ndraws, W r, d)


def _check_arguments(
    regularization, modelform, tikhonov_gamma, time_windows, num_regression_points,
    window_chaining, window_basis, mesh, n_snapshots, num_gp_samples, num_modes, dev,
):
    if regularization not in ("scalar", "blocked", "gamma"):
        raise ValueError(f"unknown regularization '{regularization}'")
    if regularization == "blocked" and "H" not in modelform:
        raise ValueError(
            "regularization='blocked' separates the quadratic block; "
            f"modelform '{modelform}' has no H operator"
        )
    if regularization == "gamma" and tikhonov_gamma is None:
        raise ValueError("regularization='gamma' requires tikhonov_gamma")
    if time_windows < 1:
        raise ValueError("time_windows must be >= 1")
    if time_windows > 1 and num_regression_points % time_windows:
        raise ValueError("num_regression_points must divide into time_windows")
    if window_chaining not in ("draws", "mean", "anchor"):
        raise ValueError(f"unknown window_chaining '{window_chaining}'")
    if window_basis not in ("global", "local"):
        raise ValueError(f"unknown window_basis '{window_basis}'")
    if window_basis == "local":
        if time_windows < 2:
            raise ValueError("window_basis='local' requires time_windows > 1")
        if n_snapshots % time_windows:
            raise ValueError("n_snapshots must divide into time_windows")
        if num_gp_samples % time_windows:
            raise ValueError("num_gp_samples must divide into time_windows")
    if mesh is not None:
        if not {"draw", "mode"} <= set(mesh.mesh_dim_names):
            raise ValueError(f"the mesh needs the axes 'draw' and 'mode', has {mesh.mesh_dim_names}")
        if num_modes % axis_size(mesh, "mode"):
            raise ValueError("num_modes must divide the 'mode' mesh axis")
        if mesh.device_type != dev.type:
            raise ValueError(f"a '{mesh.device_type}' mesh for a run on '{dev}'")


def _normals(shape, given, generator, dtype, device):
    if given is not None:
        return given.to(dtype=dtype, device=device)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _snapshots(stage, gens, given, dev, data_source, n_space, n_snapshots, r):
    """The (n, k) float32 snapshot matrix of ``data_source``."""
    with stage("data", "data generation"):
        if data_source == "euler":
            return euler_states(n_space, n_snapshots, device=dev, generator=gens["data"],
                                noise_normals=given.noise)
        if data_source == "synthetic":
            return synthetic_states(n_space, n_snapshots, r, device=dev, generator=gens["data"],
                                    lift_normals=given.lift, noise_normals=given.noise)
        raise ValueError(f"unknown data_source '{data_source}'")


def _fit(ts, Y, gens, n_restarts, z0, mesh):
    """The batched GP fit of the rows of ``Y`` at the times ``ts``; with a
    mesh each rank fits its block of rows (modes) over "mode", from its
    block of the starts drawn for all rows, and the fits are gathered."""
    # 32 restarts: 8 left ~10% of the modes in the all-noise optimum of the
    # likelihood at the production scale.
    box = BoxTransform.from_bounds(
        (1e-5, 1e5), (1e-3, 1e2), (1e-10, 1e2), device=Y.device, dtype=torch.float64
    )
    kw = dict(n_restarts=n_restarts, adam_steps=150, polish_iters=30)
    if mesh is None:
        return fit_gp_hyperparameters(ts, Y, box, gens["fit"], z0=z0, **kw)
    if z0 is None:
        z0 = initial_z(box, Y.shape[0], n_restarts, gens["fit"])
    mine = lambda x: shard_leading_axis(x, mesh, "mode")  # noqa: E731
    fit = fit_gp_hyperparameters(ts, mine(Y), box, z0=mine(z0), **kw)
    return FitResult(*gather_leading_axis(torch.stack(fit, dim=1), mesh, "mode").unbind(1))


def _project(basis, centered, mesh):
    """basis^T centered, (r, k); with a mesh each rank's rows, summed."""
    if mesh is None:
        return basis.T @ centered
    space = mesh.mesh_dim_names
    rows = lambda x: shard_leading_axis(x, mesh, space)  # noqa: E731
    return all_reduce_sum(rows(basis).T @ rows(centered), mesh, space)


def _compress_and_fit(
    stage, gens, given, dev, data_source, n_space, n_snapshots, r, num_gp_samples, n_restarts,
    mesh=None,
):
    """The front half: snapshots, POD, the GP samples and the batched GP
    fit. Returns (ts (m,) sample times, Y (r, m) compressed samples,
    svdvals, the fit), float64 from the samples on."""
    f64 = torch.float64
    states = _snapshots(stage, gens, given, dev, data_source, n_space, n_snapshots, r)

    with stage("pod", "randomized POD"):
        centered = states - states.mean(dim=1, keepdim=True)
        basis, svdvals = randomized_pod(
            centered, r, mesh=mesh, row_axis=None if mesh is None else mesh.mesh_dim_names,
            generator=gens["pod"], Omega=given.sketch,
        )
        compressed = _project(basis, centered, mesh)  # (r, k)

    t_all = np.linspace(0.0, 1.0, n_snapshots)
    sample_idx = given.sample_idx
    if sample_idx is None:
        perm = torch.randperm(n_snapshots, generator=gens["sample"], device=dev)
        sample_idx = np.sort(perm[:num_gp_samples].cpu().numpy())
    ts = torch.as_tensor(t_all[sample_idx], dtype=f64, device=dev)
    Y = compressed[:, torch.as_tensor(sample_idx, device=dev)].to(f64)  # (r, m)

    with stage("gp_fit", "GP fit"):
        fit = _fit(ts, Y, gens, n_restarts, given.z0, mesh)
    return ts, Y, svdvals, fit


def _orthonormal(basis: torch.Tensor) -> torch.Tensor:
    """The orthonormal basis nearest to ``basis`` (n, r): B (B^T B)^{-1/2},
    computed in float64 and returned in ``basis``'s dtype.

    The boundary transfer between local bases is exact only for
    orthonormal ones, and the float32 range finder leaves a window's basis
    orthonormal only to ~1e-4 at the production width (n 6000, k/W 1250;
    its Gram floor keeps the sketch's noise directions short of unit
    length): one symmetric orthogonalization finishes it. It moves the
    basis by as much, towards the exact singular vectors."""
    b = basis.to(torch.float64)
    w, V = torch.linalg.eigh(b.T @ b)
    return (b @ ((V / torch.sqrt(w)) @ V.T)).to(basis.dtype)


def _compress_and_fit_local(
    stage, gens, given, dev, data_source, n_space, n_snapshots, r, num_gp_samples, n_restarts,
    W, mesh=None,
):
    """The front half with local window bases (the ``window_basis="local"``
    branch of the reference's ``run_scaled``): each window's block of k/W
    snapshot columns is centred on its own mean and gets its own randomized
    POD, its own m/W GP samples and its own batched GP fit. Returns (ts (W,
    m/W), Y (W, r, m/W) float64, svdvals (W, l), the fit of (W, r)
    hyperparameters, bases (W, n, r) and centres (W, n), both float32)."""
    f64 = torch.float64
    states = _snapshots(stage, gens, given, dev, data_source, n_space, n_snapshots, r)
    kw, mw = n_snapshots // W, num_gp_samples // W
    t_all = np.linspace(0.0, 1.0, n_snapshots)
    idx = given.sample_idx
    if idx is None:
        idx = np.stack([
            np.sort(torch.randperm(kw, generator=gens["sample"], device=dev)[:mw].cpu().numpy())
            for _ in range(W)
        ])
    ts = torch.as_tensor(np.stack([t_all[w * kw + idx[w]] for w in range(W)]), dtype=f64,
                         device=dev)
    bases, mus, svs, Ys = [], [], [], []
    with stage("pod", "randomized POD per window"):
        for w in range(W):
            block = states[:, w * kw : (w + 1) * kw]
            mu = block.mean(dim=1, keepdim=True)
            centered = block - mu
            basis, sv = randomized_pod(
                centered, r, mesh=mesh, row_axis=None if mesh is None else mesh.mesh_dim_names,
                generator=gens["pod"], Omega=None if given.sketch is None else given.sketch[w],
            )
            basis = _orthonormal(basis)
            bases.append(basis)
            mus.append(mu[:, 0])
            svs.append(sv)
            Ys.append(_project(basis, centered, mesh)[:, torch.as_tensor(idx[w], device=dev)])
    Y = torch.stack(Ys).to(f64)  # (W, r, m/W)
    with stage("gp_fit", "GP fit per window"):
        fits = [_fit(ts[w], Y[w], gens, n_restarts, None if given.z0 is None else given.z0[w],
                     mesh) for w in range(W)]
    fit = FitResult(*(torch.stack(field) for field in zip(*fits)))
    return ts, Y, torch.stack(svs), fit, torch.stack(bases), torch.stack(mus)


@span("experiment")
def run_scaled(
    n_space: int = 6000,
    n_snapshots: int = 10000,
    num_modes: int = 30,
    num_gp_samples: int = 512,
    num_regression_points: int = 2048,
    n_restarts: int = 32,
    ndraws: int = 256,
    grid_size: int = 16,
    seed: int = 0,
    modelform: str = "cA",
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    envelope_floor: float = 0.02,
    weight_method: str = "auto",
    data_source: str = "synthetic",
    regularization: str = "scalar",
    time_windows: int = 1,
    window_chaining: str = "draws",
    tikhonov_gamma: Union[None, str, np.ndarray] = None,
    window_basis: str = "global",
    mesh=None,
    normals: Optional[ScaledNormals] = None,
    *,
    device: DeviceLike,
) -> ScaledResult:
    """Run the scaled pipeline end to end on ``device``. The defaults are
    the production scale; tests call it at tiny sizes.

    ``envelope_floor`` floors each mode's 5x-amplitude stability envelope
    at this fraction of the largest mode's (``search.build_problem``).

    ``weight_method``: "chol" (or "eigh"), the dense Cholesky factor of C
    + eta I per mode (O(r m'^3)); "lowrank", the rank-adaptive factored root
    (``gp.lowrank``, O(r m' p^2)); "auto", lowrank from 1024 regression
    points a window on.

    ``data_source``: "synthetic" (``data.synthetic_states``) or "euler"
    (``data.euler_states``, n_space = 3 nx).

    ``regularization``: "scalar", one ridge lambda; "blocked", lambda_1
    on the c and A columns and lambda_2 on the quadratic H block,
    searched over a 2-D grid (needs "H" in ``modelform``); "gamma",
    candidates ``lambda * Gamma`` with the shape ``Gamma`` from
    ``tikhonov_gamma`` (``gamma.resolve_gamma``).

    ``time_windows``: W > 1 learns a separate ROM, with its own
    regression and regularization search, on each of W contiguous parts
    of the training span. All windows share one batched screen, and one
    golden-section descent refines all their regularizers in lockstep.
    ``window_chaining`` ("draws", "mean", "anchor"; ``rollout``) picks the
    boundary scheme that ``train_error`` and ``ensemble_mean`` report; all
    three errors are recorded.

    ``window_basis`` (W > 1): "global" projects every window onto one POD
    basis of the whole span; "local" gives each window its own r-mode POD
    basis of its own centred snapshots, its own m/W GP samples and fits
    and its own envelope, and the chained rollouts carry states across a
    boundary by the exact transfer q' = B_{w+1}^T (mu_w + B_w q -
    mu_{w+1}) (``search.transfer_maps``). Local bases need k and m
    divisible by W.

    ``checkpoint_dir``: the front half (data, POD, the GP samples and the
    GP fit) is saved to ``<checkpoint_dir>/scaled_fit_stage``
    (``io.checkpoint``); a later run whose sizes, seed and source match
    loads it in place of computing it and returns the same result to the
    bit (every later stage draws from a generator of its own). A
    checkpoint of another run is recomputed and overwritten. With a mesh,
    rank 0 writes it and every rank reads it.

    ``mesh``: a ``parallel.mesh.make_mesh`` mesh with axes "draw" and
    "mode" over the ranks of the process group, this rank's ``device``
    among them (module docstring); ``num_modes`` must divide over "mode",
    and the snapshot rows, the regression points a window and the draws
    over their axes. None: one device, no collectives.
    ``normals`` replaces random numbers (``ScaledNormals``).
    """
    _check_arguments(
        regularization, modelform, tikhonov_gamma, time_windows, num_regression_points,
        window_chaining, window_basis, mesh, n_snapshots, num_gp_samples, num_modes,
        torch.device(device),
    )
    dev = resolve_device(device)
    if mesh is not None and mesh.get_rank() != 0:
        verbose = False
    f64 = torch.float64
    gens = stage_generators(seed, dev, SCALED_STAGES)
    given = normals or ScaledNormals()
    times = {}

    def stage(name, message):
        block = TimedBlock(f"scaled: {message}", device=dev, silent=not verbose, name=name)
        times[name] = block
        return block

    W, r = time_windows, num_modes
    mw = num_regression_points // W
    if weight_method == "auto":
        weight_method = "lowrank" if mw >= LOWRANK_MIN_POINTS else "chol"
    elif weight_method == "eigh":  # either dense name: the Cholesky factor, as the reference
        weight_method = "chol"
    blocked = regularization == "blocked"
    local = window_basis == "local"

    ckpt_path = os.path.join(checkpoint_dir, "scaled_fit_stage") if checkpoint_dir else None
    # The JAX package's key, and the two sizes of the front half that it
    # leaves out: a checkpoint of another sample count or restart count
    # would resume other samples or another fit.
    ckpt_shape = [n_space, n_snapshots, num_modes, seed, data_source, window_basis,
                  W if local else 0, num_gp_samples, n_restarts]
    resumed = None
    if ckpt_path and has_checkpoint(ckpt_path):
        state, meta = load_checkpoint(ckpt_path, device=dev)
        if meta.get("shape") == ckpt_shape:
            resumed = state
    bases = mus = None
    if resumed is not None:
        ts, Y, svdvals = resumed["ts"], resumed["Y"], resumed["svdvals"]
        fit = FitResult(*(resumed[k] for k in FitResult._fields))
        if local:
            bases, mus = resumed["bases"], resumed["mus"]
    else:
        front = _compress_and_fit_local if local else _compress_and_fit
        ts, Y, svdvals, fit, *local_bases = front(
            stage, gens, given, dev, data_source, n_space, n_snapshots, r, num_gp_samples,
            n_restarts, *((W,) if local else ()), mesh=mesh,
        )
        if local:
            bases, mus = local_bases
        if ckpt_path:
            extra = dict(bases=bases, mus=mus) if local else {}
            save_checkpoint(
                ckpt_path,
                pipeline_stage_state(ts=ts, Y=Y, svdvals=svdvals, **fit._asdict(), **extra),
                metadata={"shape": ckpt_shape},
            )

    rom = GalerkinROM(modelform, state_dimension=r, substeps=2)
    tw = torch.linspace(0.0, 1.0, num_regression_points, dtype=f64, device=dev).reshape(W, mw)
    with stage("estimate", f"GP estimation ({weight_method}, float64)"):
        estimate = gp_estimate_windows_local if local else gp_estimate_windows
        state_est, ddt_est, weight_ctx = estimate(
            ts, Y, fit.sigma2, fit.ell, fit.chi, tw, weight_method
        )
    with stage("weighting", f"weighting ({weight_method}, float64)"):
        Dt, zt = weight_windows(rom, state_est, ddt_est, weight_ctx)
    d = Dt.shape[-1]
    with stage("factorization", "TSQR factorization of all row problems"):
        Dt_flat, zt_flat = Dt.reshape(W * r, mw, d), zt.reshape(W * r, mw)
        # The row problems over "mode", their m' rows over "draw". One
        # device's 8 row blocks on a mesh too: with a rank count that
        # divides 8, each rank QRs some of the same blocks, and S and V are
        # one device's to the bit.
        U, S, V = tall_skinny_svd(Dt_flat, mesh, None if mesh is None else ("mode", "draw", None),
                                  row_blocks=8)
        fac = WeightedLSTSQ(U, S, V, torch.einsum("rmd,rm->rd", U, zt_flat), Dt_flat, zt_flat)

    make = lambda dtype: search.build_problem(
        rom, fac, state_est, tw, regularization, tikhonov_gamma, envelope_floor, dtype,
        bases, mus,
    )
    screen = make(torch.float32)
    grid = np.logspace(-12, 6, grid_size)
    shape = (W * r, d)
    xi_refine = _normals((search.SCREEN_DRAWS,) + shape, given.xi_refine, gens["search"],
                         torch.float32, dev)
    with stage("screening", "regularization screening"):
        # The pair grid shares the refinement's frozen draws.
        xi_grid = xi_refine if blocked else _normals(
            (grid_size, search.SCREEN_DRAWS) + shape, given.xi_grid, gens["search"],
            torch.float32, dev,
        )
        errs = search.grid_screen(screen, grid, xi_grid, blocked, mesh)
    with stage("refinement", "regularization refinement"):
        single = search.frozen_objective(screen, xi_refine)
        refine = search.refine_blocked if blocked else search.refine_scalar
        params_np = refine(single, grid, errs)  # (W,) or (W, 2)
        if mesh is not None:  # no rank may diverge on a last bit
            params_np = broadcast_from_first(torch.as_tensor(params_np, device=dev),
                                             mesh).cpu().numpy()

    final = make(f64)
    params = torch.as_tensor(params_np, dtype=f64, device=dev)
    with stage("ensemble", "posterior ensemble"):
        xi_final = _normals((ndraws,) + shape, given.xi_final, gens["draws"], f64, dev)
        means_w, frac = rollout.final_ensemble(final, params, xi_final, mesh)
        window_error = rollout.span_error(means_w, final)

    result = ScaledResult(
        num_modes=r,
        regularizer=float(params_np.reshape(-1)[0]),
        ensemble_mean=rollout.full_span(means_w).cpu().numpy(),
        stable_fraction=frac,
        svdvals=svdvals.cpu().numpy(),
        train_error=window_error,
        grid=grid,
        grid_errors=errs[..., 0] if W == 1 else errs,
        regularizer_quad=float(params_np.reshape(-1)[1]) if blocked else None,
        weight_method=weight_method,
        sample_times=ts.cpu().numpy(),
        samples=Y.cpu().numpy(),
        hyperparameters=torch.stack([fit.sigma2, fit.ell, fit.chi], dim=-1).cpu().numpy(),
        window_basis=window_basis,
        window_bases=None if bases is None else bases.cpu().numpy(),
        window_means=None if mus is None else mus.cpu().numpy(),
        weight_ranks=(
            np.array([[root.rank for root in row] for row in weight_ctx[1]])
            if weight_method == "lowrank" else None
        ),
    )
    if W > 1:
        with stage("chain", "chained rollout"):
            xi_chain = _normals((ndraws,) + shape, given.xi_chain, gens["draws"], f64, dev)
            _chained(result, final, params, params_np, xi_chain, window_error, window_chaining,
                     means_w, blocked, mesh)
    result.stage_seconds = {name: block.elapsed for name, block in times.items()}
    return result


def _chained(result, final, params, params_np, xi_chain, window_error, window_chaining,
             means_anchor, blocked, mesh):
    """Fill the W > 1 fields of ``result``: the chained rollouts under all
    three boundary schemes and the chosen one's mean and error."""
    if mesh is not None:
        xi_chain = shard_leading_axis(xi_chain, mesh, "draw")
    ohat = final.sample(params, xi_chain)
    means_mean = rollout.chain_mean(final, ohat, mesh)
    means_draws, _ = rollout.chain_draws(final, ohat, mesh)
    result.chained_error_mean = rollout.span_error(means_mean, final)
    result.chained_error_draws = rollout.span_error(means_draws, final)
    means, result.train_error = {
        "mean": (means_mean, result.chained_error_mean),
        "draws": (means_draws, result.chained_error_draws),
        "anchor": (means_anchor, window_error),
    }[window_chaining]
    result.ensemble_mean = rollout.full_span(means).cpu().numpy()
    # The geometric mean of the windows' choices (the search is in log
    # space); the table is window_regularizers.
    lams = np.asarray(params_np, np.float64)
    geo = np.exp(np.mean(np.log(lams.reshape(len(lams), -1)), axis=0))
    result.regularizer = float(geo[0])
    result.regularizer_quad = float(geo[1]) if blocked else None
    result.time_windows = len(lams)
    result.window_regularizers = lams
    result.window_error = window_error
    result.chaining = window_chaining
