"""Compressible-Euler GP-BayesOpInf pipeline, single trajectory
(counterpart of ``gp_bayesopinf_tpu/pipeline/pdes.py``).

1. Solve the Euler truth model and sample noisy snapshots.
2. POD compression with the nondimensionalizing Euler basis.
3. One batched GP fit over the POD modes.
4. Quadratic "cAH" ROM regression with the GP weights, regularization
   search through the ensemble-screen kernel, operator posterior.
5. Posterior ensemble with the 5x-amplitude stability filter,
   decompressed to the full state space.
6. On request (``ddtdata``), the GP derivative estimates beside finite
   differences of the samples and the truth model's own derivatives.

Every stage runs on the ``device`` argument, in float64 apart from the
float32 screen. A run is the span ``experiment``, each stage a child span
of its name, the data stage's two solves ``data.truth`` and
``data.samples`` (``utils.timing``).
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .configs import EulerConfig
from ..bayes import BayesianROM, OperatorPosterior, auto_regularize
from ..gp import fit_gaussian_processes, regression_weights
from ..models import Euler
from ..rom import EulerScaledBasis, GalerkinROM
from ..solve import weighted_lstsq_fit
from ..utils import TimedBlock, resolve_device, stage_generators
from ..utils.device import DeviceLike
from ..utils.timing import span


@dataclasses.dataclass
class EulerResult:
    model: Euler
    basis: EulerScaledBasis
    rom: GalerkinROM
    bayesian_model: BayesianROM
    regularizer: float
    time_domain: np.ndarray
    true_states: torch.Tensor  # (n, k)
    time_domain_sampled: np.ndarray
    snapshots_sampled: torch.Tensor  # (n, m)
    snapshots_compressed: torch.Tensor  # (r, m)
    t_estimation: np.ndarray
    gps: list  # of GaussianProcess
    draws_compressed: torch.Tensor  # (ndraws, r, k)
    valid: torch.Tensor  # (ndraws,) bool
    draws: Optional[torch.Tensor] = None  # decompressed valid draws (nv, n, k)
    svdvals: Optional[torch.Tensor] = None
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    ddtdata: Optional[Dict[str, np.ndarray]] = None  # see derivative_comparison_data


@span("experiment")
def run_euler(
    training_span=(0.0, 0.06),
    num_samples: int = 200,
    noiselevel: float = 0.03,
    num_regression_points: int = 400,
    num_pod_modes: int = 6,
    gp_regularizer: float = 1e-8,
    ndraws: int = 100,
    config: Optional[EulerConfig] = None,
    decompress_draws: bool = True,
    ddtdata: bool = False,
    weight_method: Optional[str] = None,
    verbose: bool = True,
    *,
    device: DeviceLike,
) -> EulerResult:
    """Run the Euler experiment start to finish on ``device``.

    The arguments are the JAX package's (flagship ex1a is
    ``(0.0, 0.06), 200, 0.03, 400, 6``) plus ``device``.
    ``weight_method`` picks the GP weight root, "eigh", "chol" or the
    factored "lowrank"; None and "auto" take "lowrank" from m' = 1024 on
    (``gp.gp.resolve_weight_method``), so ex1c and ex2c (m' = 3200) run
    factored. ``ddtdata`` fills the result's ``ddtdata``
    (``derivative_comparison_data``).
    """
    dev = resolve_device(device)
    f64 = torch.float64
    config = config or EulerConfig()
    gens = stage_generators(config.seed, dev)
    times = {}

    def stage(name, message):
        block = TimedBlock(message, device=dev, silent=not verbose, name=name)
        times[name] = block
        return block

    model = Euler(config.spatial_domain, substeps=config.fom_substeps)
    t_pred = np.asarray(config.time_domain, dtype=np.float64)
    t_pred_t = torch.as_tensor(t_pred, dtype=f64, device=dev)
    q0_full = model.initial_conditions(config.init_params, device=dev)

    with stage("data", "generating training data"):
        with span("data.truth"):
            true_states = model.solve(q0_full, t_pred)
        with span("data.samples"):
            lo, hi = training_span
            u = torch.rand(num_samples, generator=gens["sample"], dtype=f64, device=dev)
            t_sampled = np.sort((lo + (hi - lo) * u).cpu().numpy())
            t_sampled[0], t_sampled[-1] = training_span
            snapshots = model.noise(
                model.solve(q0_full, t_sampled), noiselevel, generator=gens["noise"]
            )

    with stage("pod", f"reducing states to {num_pod_modes} dimensions"):
        basis = EulerScaledBasis.fit(
            snapshots, num_vectors=num_pod_modes,
            v_ref=config.v_ref, rho_ref=config.rho_ref,
        )
        snapshots_compressed = basis.compress(snapshots)

    t_est = np.linspace(training_span[0], training_span[1], num_regression_points)
    t_est_t = torch.as_tensor(t_est, dtype=f64, device=dev)
    with stage("gp_fit", "fitting Gaussian processes (batched)\n"):
        bounds = config.gp_bounds
        gps = fit_gaussian_processes(
            t_est_t,
            torch.as_tensor(t_sampled, dtype=f64, device=dev),
            snapshots_compressed,
            constant_bounds=bounds.constant,
            length_scale_bounds=bounds.length_scale,
            noise_level_bounds=bounds.noise_level,
            n_restarts_optimizer=bounds.n_restarts,
            gp_regularizer=gp_regularizer,
            generator=gens["fit"],
            weight_method=weight_method,
        )
        if verbose:
            for i, gp in enumerate(gps):
                print(f"[mode {i}] {gp}".replace("\n\t", "  "))

    rom = GalerkinROM(
        config.structure,
        state_dimension=num_pod_modes,
        ivp_method=config.ivp_method,
        substeps=config.rom_substeps,
    )
    with stage("regression", "constructing posterior hyperparameters\n"):
        state_est = torch.stack([gp.state_estimate for gp in gps])
        D = rom.data_matrix(state_est)[None]  # (1, m', d)
        rhs = torch.stack([gp.ddt_estimate for gp in gps])[:, None]  # (r, 1, m')
        # Dense roots (r, 1, m', m'), or factored ones applied as thin
        # products without an (m', m') matrix.
        roots, are_cholesky = regression_weights([[gp] for gp in gps])
        fac = weighted_lstsq_fit(D, roots, rhs, weights_are_cholesky=are_cholesky)
        res = auto_regularize(
            fac, rom, state_est[:, 0], t_pred_t, t_est_t, state_est,
            generator=gens["search"], grid=config.reg_grid, ndraws=20,
            verbose=verbose,
        )
        posterior = OperatorPosterior.from_lstsq(fac, res.regularizer)
        bayesian_model = BayesianROM(rom, posterior, res.regularizer)

    with stage("ensemble", "sampling posterior distribution"):
        qbar = torch.mean(snapshots_compressed, dim=1)
        bound = 5.0 * torch.amax(torch.abs(snapshots_compressed - qbar[:, None]), dim=1)
        draws_c, valid = bayesian_model.solution_posterior(
            snapshots_compressed[:, 0], t_pred_t, ndraws,
            generator=gens["draws"], stability_envelope=(qbar, bound),
        )
        n_bad = int((~valid).sum())
        if verbose and n_bad:
            print(f"\n{n_bad}/{ndraws} draws unstable")

    draws_full = None
    if decompress_draws:
        with stage("decompress", "decompressing valid draws"):
            draws_full = basis.decompress(draws_c[valid])

    ddt = None
    if ddtdata:
        with stage("ddtdata", "derivative comparison data"):
            ddt = derivative_comparison_data(
                model, basis, gps, q0_full, t_sampled, snapshots_compressed, t_est,
                ndraws, generator=gens["draws"],
            )

    return EulerResult(
        model=model,
        basis=basis,
        rom=rom,
        bayesian_model=bayesian_model,
        regularizer=res.regularizer,
        time_domain=t_pred,
        true_states=true_states,
        time_domain_sampled=t_sampled,
        snapshots_sampled=snapshots,
        snapshots_compressed=snapshots_compressed,
        t_estimation=t_est,
        gps=gps,
        draws_compressed=draws_c,
        valid=valid,
        draws=draws_full,
        svdvals=basis.svdvals,
        stage_seconds={name: block.elapsed for name, block in times.items()},
        ddtdata=ddt,
    )


def derivative_comparison_data(
    model: Euler, basis: EulerScaledBasis, gps, q0_full: torch.Tensor, t_sampled,
    snapshots_compressed: torch.Tensor, t_est, ndraws: int,
    generator: Optional[torch.Generator] = None, normals: Optional[torch.Tensor] = None,
) -> Dict[str, np.ndarray]:
    """The GP derivative moments beside finite differences of the
    compressed samples and the truth model's compressed derivatives on
    1000 times over the estimation span, as NumPy arrays.

    ``ddts_GPstd`` is the standard deviation of ``ndraws`` samples of
    N(ddt_estimate, ddt_covariance) per mode; their standard normals,
    (r, ndraws, m'), come from ``generator`` unless given as ``normals``.
    """
    means = torch.stack([gp.ddt_estimate for gp in gps])  # (r, m')
    # A factored root gives its covariance back from the retained eigenpairs.
    covs = torch.stack([
        gp.lowrank_root.covariance() if gp.ddt_covariance is None else gp.ddt_covariance
        for gp in gps
    ])
    # The covariance is only positive semi-definite, with eigenvalues that
    # come out negative at roundoff: factor by eigh with a clamped spectrum.
    w, V = torch.linalg.eigh(0.5 * (covs + covs.transpose(-1, -2)))
    factor = V * torch.sqrt(torch.clamp(w, min=0.0))[:, None, :]
    if normals is None:
        normals = torch.randn(
            (means.shape[0], ndraws, means.shape[1]), generator=generator,
            dtype=means.dtype, device=means.device,
        )
    samples = means[:, None, :] + normals @ factor.transpose(-1, -2)

    t_sampled = np.asarray(t_sampled)
    fd = np.gradient(snapshots_compressed.cpu().numpy(), t_sampled, edge_order=2, axis=1)

    t_fine = np.linspace(t_est[0], t_est[-1], 1000)
    cons = model.unlift(model.solve(q0_full, t_fine))
    ddt_lifted = model.lift_ddts(cons, model.derivative(0.0, cons))
    ddt_compressed = basis.entries.T @ basis._pre(ddt_lifted)

    return {
        "time_domain_FD": t_sampled,
        "ddts_finitedifferences": fd,
        "time_domain_GP": np.asarray(t_est),
        "ddts_GPmean": means.cpu().numpy(),
        "ddts_GPstd": samples.std(dim=1, correction=0).cpu().numpy(),
        "time_domain_truth": t_fine,
        "ddts_truth": ddt_compressed.cpu().numpy(),
    }


def ensemble_error(result: EulerResult) -> float:
    """Relative Frobenius error of the valid draws' mean against the
    compressed truth over the prediction grid (the metric of
    ``scripts/ex1a_stability_study.py``)."""
    truth_c = result.basis.compress(result.true_states)
    valid = result.valid
    mean = result.draws_compressed[valid].sum(dim=0) / max(int(valid.sum()), 1)
    return float(torch.linalg.norm(mean - truth_c) / torch.linalg.norm(truth_c))
