"""User-facing Gaussian-process objects
(counterpart of ``gp_bayesopinf_tpu/gp/gp.py``, dense weight roots only).

``fit_gaussian_processes`` fits the hyperparameters of every POD mode in
one batched optimization and computes every estimation product in one
batched call. ``GaussianProcess`` is a per-mode view holding the fitted
hyperparameters and the estimation products.
"""

import dataclasses
from typing import List, Optional

import torch

from .estimates import batched_gp_estimates, gp_predict
from .fit import fit_gp_hyperparameters
from .nlml import BoxTransform

# From this many estimation points on the JAX package's "auto" switches to
# its factored low-rank weight root, which is not ported yet.
LOWRANK_MIN_POINTS = 1024


def resolve_weight_method(weight_method: Optional[str], num_points: int) -> str:
    """The dense weight root to use: "eigh" or "chol" as given; None and
    "auto" mean "eigh" below ``LOWRANK_MIN_POINTS`` estimation points.
    Whatever needs the low-rank root raises NotImplementedError."""
    if weight_method in ("eigh", "chol"):
        return weight_method
    if weight_method in (None, "auto"):
        if num_points >= LOWRANK_MIN_POINTS:
            raise NotImplementedError(
                f"weight method 'auto' means the low-rank root at m' >= "
                f"{LOWRANK_MIN_POINTS} (got {num_points}), which is not ported "
                "yet; pass 'eigh' or 'chol' for a dense root"
            )
        return "eigh"
    if weight_method == "lowrank":
        raise NotImplementedError("the low-rank weight root is not ported yet")
    raise ValueError(f"unknown weight method '{weight_method}'")


@dataclasses.dataclass
class GaussianProcess:
    """One fitted RBF + white-noise GP for a single POD mode."""

    t_training: torch.Tensor
    y: torch.Tensor
    constant: float  # sigma^2
    length_scale: float  # ell
    noise_level: float  # chi

    t_estimation: Optional[torch.Tensor] = None
    state_estimate: Optional[torch.Tensor] = None
    ddt_estimate: Optional[torch.Tensor] = None
    ddt_covariance: Optional[torch.Tensor] = None
    sqrtW: Optional[torch.Tensor] = None  # the weight root, by weight_method:
    weight_method: str = "eigh"  # "eigh": (C + eta I)^{-1/2}; "chol": chol(C + eta I)

    def __str__(self):
        return "\n\t".join(
            [
                "Gaussian radial basis function kernel",
                r"k(t, t') = \sigma^2 exp(-(t - t')^2 / (2 \ell^2)) + \chi I",
                rf"\sigma^2 = {self.constant:.4e}",
                rf"\ell = {self.length_scale:.4e}",
                rf"\chi = {self.noise_level:.4e}",
            ]
        )

    def predict(self, t: torch.Tensor):
        """Posterior mean and standard deviation at times ``t``."""
        return gp_predict(
            self.t_training, self.y, t,
            self.constant, self.length_scale, self.noise_level,
        )


def fit_gaussian_processes(
    time_domain_training: torch.Tensor,
    time_domain_sampled: torch.Tensor,
    snapshots_sampled: torch.Tensor,
    constant_bounds=(1e-5, 1e5),
    length_scale_bounds=(1e-5, 1e2),
    noise_level_bounds=(1e-16, 1e2),
    n_restarts_optimizer: int = 50,
    gp_regularizer: float = 1e-8,
    generator: Optional[torch.Generator] = None,
    adam_steps: int = 60,
    polish_iters: int = 10,
    z0: Optional[torch.Tensor] = None,
    weight_method: Optional[str] = None,
) -> List[GaussianProcess]:
    """Fit one GP to every row of ``snapshots_sampled`` in one batch.

    ``time_domain_training`` are the m' estimation times,
    ``time_domain_sampled`` the (m,) sample times, or (r, m) for times
    of each row's own, and ``snapshots_sampled`` the (r, m) samples.
    ``generator`` draws the random restarts; ``z0`` replaces them (see
    ``fit_gp_hyperparameters``). ``weight_method`` as in
    ``resolve_weight_method``. Raises ValueError if a mode's weight covariance is not positive
    definite.
    """
    Y = torch.atleast_2d(snapshots_sampled)
    t_est = time_domain_training
    weight_method = resolve_weight_method(weight_method, t_est.shape[0])
    box = BoxTransform.from_bounds(
        constant_bounds, length_scale_bounds, noise_level_bounds,
        device=Y.device, dtype=Y.dtype,
    )
    fit = fit_gp_hyperparameters(
        time_domain_sampled, Y, box, generator,
        n_restarts=n_restarts_optimizer,
        adam_steps=adam_steps,
        polish_iters=polish_iters,
        z0=z0,
    )
    T = time_domain_sampled.expand(Y.shape)
    est = batched_gp_estimates(
        T, Y, t_est, fit.sigma2, fit.ell, fit.chi, gp_regularizer, method=weight_method
    )
    if not bool(est.ok.all()):
        bad = torch.nonzero(~est.ok).flatten().tolist()
        raise ValueError(
            f"inverse covariance not positive definite for modes {bad}, "
            "increase eta"
        )
    hyper = torch.stack([fit.sigma2, fit.ell, fit.chi], dim=1).tolist()
    return [
        GaussianProcess(
            T[i], Y[i], *hyper[i],
            t_estimation=t_est,
            state_estimate=est.state_estimate[i],
            ddt_estimate=est.ddt_estimate[i],
            ddt_covariance=est.ddt_covariance[i],
            sqrtW=est.weight_root[i],
            weight_method=weight_method,
        )
        for i in range(Y.shape[0])
    ]
