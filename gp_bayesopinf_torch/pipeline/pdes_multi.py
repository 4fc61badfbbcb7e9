"""Multi-trajectory GP-BayesOpInf pipeline: the cubic heat equation with
bimodal forcing inputs (counterpart of
``gp_bayesopinf_tpu/pipeline/pdes_multi.py``; HDF5 export and plotting
come later).

1. data: host truth solves of the L training trajectories as one stacked
   tridiagonal system; noisy samples at shared sample times.
2. pod: joint POD of the lifted state (q, q^2) over all trajectories.
3. gp_fit: one batched fit of the L r (trajectory, mode) GPs.
4. regression: the "cAHBN" regression stacked over trajectories, each
   mode's weights block-diagonal over them; the regularization search
   through the implicit SDIRK2 screen, whose failed refinement aborts the
   run as the reference's PDEsMulti does.
5. ensemble: the L trajectories' posterior ensembles as one batch.
6. newparam: the ensemble at unseen input parameters, against a host
   truth solve.

Every stage but the host truth solves runs on the ``device`` argument,
in float64 apart from the float32 screen.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .configs import HeatMultiConfig
from ..bayes import BayesianROM, OperatorPosterior, auto_regularize
from ..gp import fit_gaussian_processes, regression_weights
from ..models import CubicHeatBimodal, HeatBimodal, solve_host_stacked
from ..rom import GalerkinROM, QuadraticLiftedBasis
from ..solve import weighted_lstsq_fit
from ..utils import MULTI_STAGES, TimedBlock, resolve_device, stage_generators
from ..utils.device import DeviceLike


def input_func_factory(params):
    """u(t) of one (a, b) input pair: (n,) times -> (2, n) inputs."""
    a, b = params

    def input_func(t):
        return HeatBimodal.oscillators(t, a, b)

    return input_func


def stacked_input_func(params, device: DeviceLike):
    """u(t) of L input pairs at once: (n,) times -> (L, 1, 2, n), the form
    ``BayesianROM.solution_posterior`` takes for L trajectories."""
    amps = torch.as_tensor(params, dtype=torch.float64, device=device)[:, :, None, None]

    def input_func(t):
        return HeatBimodal.oscillators(t, amps[:, 0], amps[:, 1]).movedim(0, -2)

    return input_func


@dataclasses.dataclass
class HeatMultiResult:
    basis: QuadraticLiftedBasis
    rom: GalerkinROM
    bayesian_model: BayesianROM
    regularizer: float
    time_domain: np.ndarray
    true_states: torch.Tensor  # (L, n, k)
    time_domain_sampled: np.ndarray
    snapshots: torch.Tensor  # (L, n, m)
    snapshots_compressed: torch.Tensor  # (L, r, m)
    t_estimation: np.ndarray
    gps: List[list]  # gps[ell][i]
    draws_compressed: torch.Tensor  # (L, ndraws, r, k)
    valid: torch.Tensor  # (L, ndraws) bool
    newparam_draws: Optional[torch.Tensor] = None  # (ndraws, r, k)
    newparam_valid: Optional[torch.Tensor] = None  # (ndraws,)
    newparam_true: Optional[torch.Tensor] = None  # (n, k)
    spatial_domain: Optional[np.ndarray] = None
    input_parameters: Optional[tuple] = None
    test_parameters: Optional[tuple] = None
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def run_heat_multi(
    training_span=(0.0, 1.0),
    num_samples: int = 20,
    noiselevel: float = 0.05,
    num_regression_points: int = 80,
    num_pod_modes: int = 5,
    gp_regularizer: float = 1e-8,
    ndraws: int = 100,
    config: Optional[HeatMultiConfig] = None,
    generalization_test: bool = True,
    weight_method: Optional[str] = None,
    verbose: bool = True,
    *,
    device: DeviceLike,
) -> HeatMultiResult:
    """Run the multi-trajectory experiment start to finish on ``device``.

    The arguments are the JAX package's (flagship ex3 is
    ``(0.0, 1.0), 20, 0.05, 80, 5``) plus ``device`` and
    ``weight_method`` (``gp.gp.resolve_weight_method``: the factored
    low-rank root from m' = 1024 on).
    """
    dev = resolve_device(device)
    f64 = torch.float64
    config = config or HeatMultiConfig()
    gens = stage_generators(config.seed, dev, MULTI_STAGES)
    L, r = len(config.input_parameters), num_pod_modes
    times = {}

    def stage(name, message):
        block = TimedBlock(message, device=dev, silent=not verbose, name=name)
        times[name] = block
        return block

    def tensor(x):
        return torch.as_tensor(x, dtype=f64, device=dev)

    t_pred = np.asarray(config.time_domain, dtype=np.float64)
    t_pred_t = tensor(t_pred)
    x = np.asarray(config.spatial_domain)
    q0_full = HeatBimodal.initial_conditions(x, config.left_bc, config.right_bc)

    def make_fom(params):
        a, b = params
        return CubicHeatBimodal(
            x, config.left_bc, config.right_bc, config.diffusion,
            a=a, b=b, substeps=config.fom_substeps,
        )

    with stage("data", f"generating training data ({L} trajectories)"):
        lo, hi = training_span
        u = torch.rand(num_samples, generator=gens["sample"], dtype=f64, device=dev)
        t_sampled = np.sort((lo + (hi - lo) * u).cpu().numpy())
        t_sampled[0], t_sampled[-1] = training_span
        foms = [make_fom(p) for p in config.input_parameters]
        true_states = tensor(solve_host_stacked(foms, q0_full, t_pred))
        sampled = tensor(solve_host_stacked(foms, q0_full, t_sampled))
        snapshots = torch.stack([
            fom.noise(sampled[ell], noiselevel, generator=gens["noise"])
            for ell, fom in enumerate(foms)
        ])

    with stage("pod", f"joint POD to {r} modes"):
        basis = QuadraticLiftedBasis.fit(torch.cat(list(snapshots), dim=1), num_vectors=r)
        snapshots_compressed = torch.stack([basis.compress(s) for s in snapshots])

    t_est = np.linspace(training_span[0], training_span[1], num_regression_points)
    t_est_t = tensor(t_est)
    with stage("gp_fit", f"fitting {L * r} Gaussian processes (batched)\n"):
        bounds = config.gp_bounds
        gps_flat = fit_gaussian_processes(
            t_est_t, tensor(t_sampled), snapshots_compressed.reshape(L * r, -1),
            constant_bounds=bounds.constant,
            length_scale_bounds=bounds.length_scale,
            noise_level_bounds=bounds.noise_level,
            n_restarts_optimizer=bounds.n_restarts,
            gp_regularizer=gp_regularizer,
            generator=gens["fit"],
            weight_method=weight_method,
        )
        gps = [gps_flat[ell * r : (ell + 1) * r] for ell in range(L)]

    rom = GalerkinROM(
        config.structure, state_dimension=r, input_dimension=2,
        ivp_method=config.ivp_method, substeps=config.rom_substeps,
    )
    input_funcs = [input_func_factory(p) for p in config.input_parameters]
    with stage("regression", "constructing posterior hyperparameters\n"):
        state_ests = torch.stack([torch.stack([gp.state_estimate for gp in g]) for g in gps])
        D_blocks = torch.stack([
            rom.data_matrix(state_ests[ell], input_funcs[ell](t_est_t)) for ell in range(L)
        ])  # (L, m', d)
        by_mode = [[gps[ell][i] for ell in range(L)] for i in range(r)]
        rhs = torch.stack([torch.stack([g.ddt_estimate for g in m]) for m in by_mode])
        roots, are_cholesky = regression_weights(by_mode)  # (r, L, m', m'), or factored
        fac = weighted_lstsq_fit(D_blocks, roots, rhs, weights_are_cholesky=are_cholesky)
        res = auto_regularize(
            fac, rom, state_ests[:, :, 0], t_pred_t, t_est_t, state_ests,
            generator=gens["search"], grid=config.reg_grid, ndraws=20,
            verbose=verbose, input_funcs=input_funcs, refine_failure="raise",
        )
        posterior = OperatorPosterior.from_lstsq(fac, res.regularizer)
        bayesian_model = BayesianROM(rom, posterior, res.regularizer)

    with stage("ensemble", f"sampling posterior distributions ({L} trajectories)"):
        qbar = torch.mean(state_ests, dim=2)  # (L, r)
        bound = 5.0 * torch.amax(torch.abs(state_ests - qbar[..., None]), dim=2)
        draws_c, valid = bayesian_model.solution_posterior(
            state_ests[:, :, 0], t_pred_t, ndraws, generator=gens["draws"],
            stability_envelope=(qbar, bound),
            input_func=stacked_input_func(config.input_parameters, dev),
        )
        if verbose:
            for ell, n_bad in enumerate((~valid).sum(dim=1).tolist()):
                if n_bad:
                    print(f"trajectory {ell}: {n_bad}/{ndraws} unstable")

    result = HeatMultiResult(
        basis=basis,
        rom=rom,
        bayesian_model=bayesian_model,
        regularizer=res.regularizer,
        time_domain=t_pred,
        true_states=true_states,
        time_domain_sampled=t_sampled,
        snapshots=snapshots,
        snapshots_compressed=snapshots_compressed,
        t_estimation=t_est,
        gps=gps,
        draws_compressed=draws_c,
        valid=valid,
        spatial_domain=x,
        input_parameters=tuple(config.input_parameters),
        test_parameters=tuple(config.test_parameters),
    )

    if generalization_test:
        with stage("newparam", "sampling at the test parameters"):
            fom_new = make_fom(config.test_parameters)
            truth_new = tensor(fom_new.solve_host(q0_full, t_pred))
            draws_new, valid_new = bayesian_model.solution_posterior(
                basis.compress(truth_new)[:, 0], t_pred_t, ndraws,
                generator=gens["newparam"],
                input_func=input_func_factory(config.test_parameters),
            )
        result.newparam_draws = draws_new
        result.newparam_valid = valid_new
        result.newparam_true = truth_new
    result.stage_seconds = {name: block.elapsed for name, block in times.items()}
    return result


def _mean_error(draws: torch.Tensor, valid: torch.Tensor, truth: torch.Tensor,
                decompress=None) -> float:
    mean = draws[valid].sum(dim=0) / max(int(valid.sum()), 1)
    if decompress is not None:
        mean = decompress(mean)
    return float(torch.linalg.norm(mean - truth) / torch.linalg.norm(truth))


def ensemble_errors(
    result: HeatMultiResult, full_state: bool = False
) -> Tuple[List[float], Optional[float]]:
    """Relative Frobenius errors of the valid draws' mean over the
    prediction grid: one per training trajectory, and the one at the test
    parameters (None without the generalization test). Against the
    compressed truth by default; with ``full_state`` the mean is
    decompressed and held against the full-state truth, the metric of the
    reference's own ex3 report."""
    basis = result.basis

    def err(draws, valid, truth):
        if full_state:
            return _mean_error(draws, valid, truth, basis.decompress)
        return _mean_error(draws, valid, basis.compress(truth))

    errs = [err(d, v, t) for d, v, t in
            zip(result.draws_compressed, result.valid, result.true_states)]
    new = None
    if result.newparam_draws is not None:
        new = err(result.newparam_draws, result.newparam_valid, result.newparam_true)
    return errs, new
