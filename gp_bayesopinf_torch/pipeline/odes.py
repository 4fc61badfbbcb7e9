"""SEIRD parameter-estimation pipeline
(counterpart of ``gp_bayesopinf_tpu/pipeline/odes.py``).

1. Sample a noisy trajectory on the host, each variable at sample times
   of its own unless ``synced``, integer days only unless told otherwise.
2. One batched GP fit over the five state variables.
3. The five-block weighted regression for the four parameters, and the
   regularization search through the quadratic ensemble-screen kernel:
   parameter draws become "cAH" operator rows by ``SEIRD2.cah_operators``.
4. The posterior ensemble over the prediction domain with the
   5x-amplitude stability filter, and a second ensemble from unseen
   initial conditions.

``crosscheck=True`` also (a) recomputes the GP estimation products with
NumPy/SciPy (LAPACK) at the fitted hyperparameters and reports the
largest deviations, and (b) fits every GP again with scipy's L-BFGS-B on
the exact NLML, rebuilds the parameter posterior in NumPy/SciPy alone and
compares posterior means and standard deviations with
``np.allclose(rtol=1e-1)``: a wrong optimum of ``gp/fit.py`` shows there.

Every device stage runs on the ``device`` argument, in float64 apart from
the float32 screen. A run is the span ``experiment``, each stage a child
span of its name, the data stage's host solves ``data.truth`` (the two
truths on the prediction grid) and ``data.samples`` (the per-variable
solves and the noise) (``utils.timing``).
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .configs import SEIRDConfig
from ..bayes import BayesianODE, KernelScreenSpec, OperatorPosterior, auto_regularize
from ..gp import fit_gaussian_processes, regression_weights
from ..models import SEIRD2
from ..solve import weighted_lstsq_fit
from ..utils import ODE_STAGES, TimedBlock, host_rng, resolve_device, stage_generators
from ..utils.device import DeviceLike
from ..utils.timing import span


@dataclasses.dataclass
class SEIRDResult:
    model: SEIRD2
    bayesian_model: BayesianODE
    regularizer: float
    time_domain: np.ndarray
    true_states: np.ndarray  # (5, k)
    sample_times: np.ndarray  # (5, m)
    snapshots: np.ndarray  # (5, m)
    t_estimation: np.ndarray
    gps: list  # of GaussianProcess
    draws: torch.Tensor  # (ndraws, 5, k)
    valid: torch.Tensor  # (ndraws,) bool
    newic_draws: torch.Tensor  # (ndraws, 5, k)
    newic_valid: torch.Tensor  # (ndraws,) bool
    newic_true_states: np.ndarray  # (5, k)
    crosscheck: Optional[Dict[str, float]] = None
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def sample_trajectory(
    rng: np.random.Generator,
    model: SEIRD2,
    config: SEIRDConfig,
    training_span,
    num_samples: int,
    noiselevel: float,
    synced: bool = False,
    integersonly: bool = True,
):
    """Noisy snapshots on the host; returns (sample_times (5, m),
    snapshots (5, m)) NumPy arrays.

    Unless ``synced``, every variable has sample times of its own and is
    read off a truth solve over them. ``integersonly`` draws the times
    without replacement from the integers below the span's end; the
    span's ends are always sampled.
    """
    t0, t1 = training_span
    nvars = model.num_variables

    def draw_times():
        if integersonly:
            t = np.sort(rng.choice(int(t1), size=num_samples, replace=False)).astype(np.float64)
        else:
            t = np.sort(rng.uniform(t0, t1, size=num_samples))
        t[0], t[-1] = t0, t1
        return t

    q0 = np.asarray(config.initial_conditions)
    if synced:
        t = draw_times()
        snaps = model.noise_host(rng, model.solve_host(q0, t), noiselevel)
        return np.broadcast_to(t, (nvars, num_samples)).copy(), snaps
    rows, times = [], []
    for i in range(nvars):
        t = draw_times()
        rows.append(model.noise_host(rng, model.solve_host(q0, t), noiselevel)[i])
        times.append(t)
    return np.stack(times), np.stack(rows)


@span("experiment")
def run_seird(
    training_span=(0.0, 90.0),
    num_samples: int = 90,
    noiselevel: float = 0.10,
    num_regression_points: int = 360,
    gp_regularizer: float = 1e-8,
    ndraws: int = 100,
    config: Optional[SEIRDConfig] = None,
    synced: bool = False,
    integersonly: bool = True,
    crosscheck: bool = False,
    weight_method: Optional[str] = None,
    verbose: bool = True,
    *,
    device: DeviceLike,
) -> SEIRDResult:
    """Run the SEIRD experiment start to finish on ``device``.

    The arguments are the JAX package's (the paper's ex1a is
    ``(0.0, 90.0), 90, 0.10, 360`` with 600 draws) plus ``device`` and
    ``weight_method`` (``gp.gp.resolve_weight_method``).
    """
    dev = resolve_device(device)
    f64 = torch.float64
    config = config or SEIRDConfig()
    gens = stage_generators(config.seed, dev, ODE_STAGES)
    times = {}

    def stage(name, message):
        block = TimedBlock(message, device=dev, silent=not verbose, name=name)
        times[name] = block
        return block

    def on_device(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=f64, device=dev)

    model = SEIRD2(
        parameters=tuple(SEIRD2.convert_parameters(config.true_parameters6).tolist()),
        substeps=config.substeps,
    )
    t_pred = np.asarray(config.time_domain, dtype=np.float64)
    t_pred_t = on_device(t_pred)
    q0 = np.asarray(config.initial_conditions, dtype=np.float64)
    q0_new = np.asarray(config.test_initial_conditions, dtype=np.float64)

    with stage("data", "generating training data"):
        with span("data.truth"):
            true_states = model.solve_host(q0, t_pred)
            newic_true_states = model.solve_host(q0_new, t_pred)
        with span("data.samples"):
            sample_times, snapshots = sample_trajectory(
                host_rng(config.seed, "sample", ODE_STAGES), model, config, training_span,
                num_samples, noiselevel, synced=synced, integersonly=integersonly,
            )

    t_est = np.linspace(training_span[0], training_span[1], num_regression_points)
    t_est_t = on_device(t_est)
    with stage("gp_fit", "fitting Gaussian processes (batched)\n"):
        bounds = config.gp_bounds
        gps = fit_gaussian_processes(
            t_est_t, on_device(sample_times), on_device(snapshots),
            constant_bounds=bounds.constant,
            length_scale_bounds=bounds.length_scale,
            noise_level_bounds=bounds.noise_level,
            n_restarts_optimizer=bounds.n_restarts,
            gp_regularizer=gp_regularizer,
            generator=gens["fit"],
            weight_method=weight_method,
        )
        if verbose:
            for label, gp in zip(model.LABELS, gps):
                print(f"[{label}] {gp}".replace("\n\t", "  "))

    xcheck = _crosscheck(gps, t_est, gp_regularizer, verbose) if crosscheck else None

    with stage("regression", "constructing posterior hyperparameters\n"):
        state_est = torch.stack([gp.state_estimate for gp in gps])  # (5, m')
        roots, are_cholesky = regression_weights([gps])  # (1, 5, m', m'), or factored
        fac = weighted_lstsq_fit(
            model.data_matrix_blocks(state_est),  # (5, m', 4)
            roots,
            torch.stack([gp.ddt_estimate for gp in gps])[None],  # (1, 5, m')
            weights_are_cholesky=are_cholesky,
        )
        # The right-hand side is exactly quadratic, so parameter draws map
        # to "cAH" operator rows and the search runs on the screen kernel.
        res = auto_regularize(
            fac,
            KernelScreenSpec("cAH", model.num_variables, substeps=model.substeps),
            state_est[:, 0], t_pred_t, t_est_t, state_est,
            generator=gens["search"], grid=config.reg_grid, ndraws=20,
            verbose=verbose, operator_map=model.cah_operators,
        )
        posterior = OperatorPosterior.from_lstsq(fac, res.regularizer)
        bayesian_model = BayesianODE(model, posterior, res.regularizer)

    if crosscheck:
        with stage("crosscheck", "second-backend (scipy) posterior crosscheck\n"):
            mean2, cov2, _ = _second_backend_posterior(
                gps, t_est, gp_regularizer, res.regularizer, config
            )
            xcheck.update(_compare_posteriors(bayesian_model, mean2, cov2, verbose=verbose))

    with stage("ensemble", "sampling posterior distribution"):
        shift = torch.mean(state_est, dim=1)
        limits = 5.0 * torch.amax(torch.abs(state_est - shift[:, None]), dim=1)
        draws, valid = bayesian_model.solution_posterior(
            on_device(q0), t_pred_t, ndraws, generator=gens["draws"],
            stability_envelope=(shift, limits),
        )
        n_bad = int((~valid).sum())
        if verbose and n_bad:
            print(f"\n{n_bad}/{ndraws} DRAWS UNSTABLE")

    with stage("newic", "new-IC generalization ensemble"):
        newic_draws, newic_valid = bayesian_model.solution_posterior(
            on_device(q0_new), t_pred_t, ndraws, generator=gens["newic"],
        )

    return SEIRDResult(
        model=model,
        bayesian_model=bayesian_model,
        regularizer=res.regularizer,
        time_domain=t_pred,
        true_states=true_states,
        sample_times=sample_times,
        snapshots=snapshots,
        t_estimation=t_est,
        gps=gps,
        draws=draws,
        valid=valid,
        newic_draws=newic_draws,
        newic_valid=newic_valid,
        newic_true_states=newic_true_states,
        crosscheck=xcheck,
        stage_seconds={name: block.elapsed for name, block in times.items()},
    )


def ensemble_error(result: SEIRDResult, newic: bool = False) -> float:
    """Relative Frobenius error of the valid draws' mean against the truth
    over the prediction grid; with ``newic`` that of the ensemble from the
    unseen initial conditions."""
    draws, valid, truth = (
        (result.newic_draws, result.newic_valid, result.newic_true_states) if newic
        else (result.draws, result.valid, result.true_states)
    )
    truth = torch.as_tensor(truth, dtype=draws.dtype, device=draws.device)
    mean = draws[valid].sum(dim=0) / max(int(valid.sum()), 1)
    return float(torch.linalg.norm(mean - truth) / torch.linalg.norm(truth))


def _estimates_np(t, y, te, s2, ell, chi, eta):
    """NumPy/SciPy (LAPACK) GP estimation products: state, ddt, sqrtW."""
    import scipy.linalg as la

    ell2 = ell * ell

    def kap(a, b):
        d = a[:, None] - b[None, :]
        return s2 * np.exp(-(d * d) / (2 * ell2))

    Kyy = kap(t, t) + chi * np.eye(t.size)
    kzy = kap(te, t)
    Kzy = -(te[:, None] - t[None, :]) * kzy / ell2
    dzz = te[:, None] - te[None, :]
    Kzz = (1 - dzz * dzz / ell2) * kap(te, te) / ell2

    cho = la.cho_factor(Kyy)
    alpha = la.cho_solve(cho, y)
    state = kzy @ alpha
    ddt = Kzy @ alpha
    cross = Kzy @ la.cho_solve(cho, Kzy.T)
    C = Kzz - 0.5 * (cross + cross.T)
    w, V = la.eigh(C + eta * np.eye(te.size))
    sqrtW = (V / np.sqrt(w)) @ V.T
    return state, ddt, sqrtW


def _gp_data(gp):
    return gp.t_training.cpu().numpy(), gp.y.cpu().numpy()


def _crosscheck(gps, t_est, eta, verbose=True) -> Dict[str, float]:
    """Recompute the estimation products with NumPy/SciPy (LAPACK) at the
    same hyperparameters; returns the largest deviations (absolute for the
    estimates, relative to its largest entry for the weight, which is
    compared as W = R^T R so that either root serves)."""
    worst = {"state_estimate": 0.0, "ddt_estimate": 0.0, "sqrtW": 0.0}
    te = np.asarray(t_est)
    for gp in gps:
        state, ddt, sqrtW = _estimates_np(
            *_gp_data(gp), te, gp.constant, gp.length_scale, gp.noise_level, eta
        )
        for name, ref in (("state_estimate", state), ("ddt_estimate", ddt)):
            dev = float(np.max(np.abs(getattr(gp, name).cpu().numpy() - ref)))
            worst[name] = max(worst[name], dev)
        dense = gp.lowrank_root.dense() if gp.weight_method == "lowrank" else gp.sqrtW
        root = dense.cpu().numpy()
        if gp.weight_method == "chol":
            W = np.linalg.inv(root @ root.T)
        else:
            W = root.T @ root
        W_ref = sqrtW.T @ sqrtW
        worst["sqrtW"] = max(
            worst["sqrtW"],
            float(np.max(np.abs(W - W_ref))) / max(float(np.max(np.abs(W_ref))), 1e-300),
        )
    if verbose:
        print("Backend crosscheck (PyTorch vs LAPACK), max deviations:")
        for k, v in worst.items():
            print(f"  {k}: {v:.3e}")
    return worst


def _second_backend_posterior(gps, t_est, eta, lam, config, n_restarts=25):
    """Fit every GP again and rebuild the parameter posterior, all in
    NumPy/SciPy: scipy's L-BFGS-B over the exact NLML from seeded random
    starts, then the estimation products and the blockwise-weighted
    regression. Nothing of the PyTorch fitting path is reused.

    Returns (mean (4,), cov (4, 4), hyperparameters (5, 3)).
    """
    import scipy.optimize

    b = config.gp_bounds
    te = np.asarray(t_est)
    lo = np.log([b.constant[0], b.length_scale[0], b.noise_level[0]])
    hi = np.log([b.constant[1], b.length_scale[1], b.noise_level[1]])
    states, ddts, sqrtWs, hypers = [], [], [], []
    for i, gp in enumerate(gps):
        t, y = _gp_data(gp)
        rng = np.random.default_rng(1000 + i)

        def nlml_np(z):
            s2_, ell_, chi_ = np.exp(z)
            d = t[:, None] - t[None, :]
            K = s2_ * np.exp(-(d * d) / (2 * ell_ * ell_)) + chi_ * np.eye(t.size)
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                return 1e30
            a = np.linalg.solve(L.T, np.linalg.solve(L, y))
            return float(
                0.5 * y @ a + np.sum(np.log(np.diag(L))) + 0.5 * t.size * np.log(2 * np.pi)
            )

        best = (np.inf, np.zeros(3))
        starts = [np.clip(np.zeros(3), lo, hi)] + list(rng.uniform(lo, hi, (n_restarts, 3)))
        for z0 in starts:
            opt = scipy.optimize.minimize(
                nlml_np, z0, method="L-BFGS-B", bounds=list(zip(lo, hi))
            )
            if opt.fun < best[0]:
                best = (opt.fun, opt.x)
        s2, ell, chi = np.exp(best[1])
        hypers.append((s2, ell, chi))
        state, ddt, sqrtW = _estimates_np(t, y, te, s2, ell, chi, eta)
        states.append(state)
        ddts.append(ddt)
        sqrtWs.append(sqrtW)

    D_blocks = SEIRD2.data_matrix_blocks(torch.as_tensor(np.stack(states))).numpy()
    d = D_blocks.shape[-1]
    Dt = np.vstack([sqrtWs[k] @ D_blocks[k] for k in range(len(gps))])
    zt = np.concatenate([sqrtWs[k] @ ddts[k] for k in range(len(gps))])
    A = np.vstack([Dt, lam * np.eye(d)])
    mean = np.linalg.lstsq(A, np.concatenate([zt, np.zeros(d)]), rcond=None)[0]
    cov = np.linalg.inv(Dt.T @ Dt + lam * lam * np.eye(d))
    return mean, cov, np.asarray(hypers)


def _compare_posteriors(bayesian_model, mean2, cov2, verbose=True) -> Dict[str, float]:
    """Differences of the posterior's mean and standard deviations from
    the second backend's, with ``np.allclose(rtol=1e-1)`` verdicts."""
    mean1 = bayesian_model.mean.cpu().numpy()
    cov1 = bayesian_model.cov.cpu().numpy()
    std1 = np.sqrt(np.diag(cov1))
    std2 = np.sqrt(np.diag(cov2))
    stats = {
        "posterior_mean_absdiff": float(np.max(np.abs(mean1 - mean2))),
        "posterior_mean_reldiff": float(
            np.max(np.abs(mean1 - mean2) / np.maximum(np.abs(mean2), 1e-300))
        ),
        "posterior_std_reldiff": float(np.max(np.abs(std1 - std2) / np.maximum(std2, 1e-300))),
        "posterior_cov_frob": float(np.linalg.norm(cov1 - cov2)),
        "posterior_mean_allclose": bool(np.allclose(mean1, mean2, rtol=1e-1)),
        "posterior_std_allclose": bool(np.allclose(std1, std2, rtol=1e-1)),
    }
    if verbose:
        print("Dual-backend posterior comparison (PyTorch fit vs scipy fit):")
        print(f"  means PyTorch: {mean1}")
        print(f"  means scipy:   {mean2}")
        print(f"  stds  PyTorch: {std1}")
        print(f"  stds  scipy:   {std2}")
        for k, v in stats.items():
            print(f"  {k}: {v}")
    return stats
