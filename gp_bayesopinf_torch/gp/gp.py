"""User-facing Gaussian-process objects
(counterpart of ``gp_bayesopinf_tpu/gp/gp.py``).

``fit_gaussian_processes`` fits the hyperparameters of every POD mode in
one batched optimization and computes every estimation product in one
batched call. ``GaussianProcess`` is a per-mode view holding the fitted
hyperparameters and the estimation products.

A fit is the span ``gp.fit``, its estimates and weight roots the child
span ``gp.estimates`` (``utils.timing``; the fit's phases are
``gp/fit.py``'s).
"""

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .estimates import batched_gp_estimates, gp_predict
from .fit import fit_gp_hyperparameters
from .lowrank import LowRankWeightRoot, batched_lowrank_gp_estimates
from .nlml import BoxTransform
from ..ops.rbf import rbf
from ..utils.device import DeviceLike
from ..utils.timing import span

# From this many estimation points on "auto" switches to the factored
# low-rank weight root (``gp.lowrank``): where the dense (m', m')
# factorization starts to dominate.
LOWRANK_MIN_POINTS = 1024


def resolve_weight_method(
    weight_method: Optional[str], num_points: int,
    lowrank_min_points: int = LOWRANK_MIN_POINTS,
) -> str:
    """The weight root to use: "eigh", "chol" or "lowrank" as given; None
    and "auto" mean "lowrank" from ``lowrank_min_points`` estimation points
    on and "eigh" below."""
    if weight_method in ("eigh", "chol", "lowrank"):
        return weight_method
    if weight_method in (None, "auto"):
        return "lowrank" if num_points >= lowrank_min_points else "eigh"
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
    weight_method: str = "eigh"  # "eigh": (C + eta I)^{-1/2}; "chol": chol(C + eta I);
    #                              "lowrank": the factored root in lowrank_root,
    #                              ddt_covariance and sqrtW stay None
    lowrank_root: Optional[LowRankWeightRoot] = None

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

    @property
    def nsamples(self) -> int:
        return int(self.t_training.shape[0])

    def predict(self, t: torch.Tensor):
        """Posterior mean and standard deviation at times ``t``."""
        return gp_predict(
            self.t_training, self.y, t,
            self.constant, self.length_scale, self.noise_level,
        )

    def prediction_bounds(self, t: torch.Tensor, kind: str = "95%"):
        """(lower, mean, upper) at times ``t``, the bounds ``width`` standard
        deviations off the mean: "std" 1, "95%" 1.96, "2std" 2, "3std" 3."""
        mean, std = self.predict(t)
        width = {"std": 1.0, "95%": 1.96, "2std": 2.0, "3std": 3.0}.get(kind)
        if width is None:
            raise ValueError(kind)
        return mean - width * std, mean, mean + width * std

    def __call__(self, t: torch.Tensor, tprime: torch.Tensor) -> torch.Tensor:
        """The kernel k(t, t') with the white-noise term where t == t'."""
        K = rbf(t, tprime, self.constant, self.length_scale)
        same = t[:, None] == tprime[None, :]
        return K + self.noise_level * same.to(K.dtype)

    def rbf_eval(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        """The squared-exponential part of the kernel at (t1, t2)."""
        return rbf(t1, t2, self.constant, self.length_scale)

    def compute_lstsq_matrices(self, t_est: torch.Tensor, eta: float = 1e-8, method: str = "eigh"):
        """Compute the state and derivative estimates, the derivative
        covariance and the weight root (``method`` "eigh" or "chol") at the
        estimation times ``t_est``, on the device of the training data; the
        GP keeps them and is returned. Raises ValueError if the weight
        covariance is not positive definite."""
        est = batched_gp_estimates(
            self.t_training[None], self.y[None], t_est,
            torch.tensor([self.constant], dtype=self.y.dtype, device=self.y.device),
            torch.tensor([self.length_scale], dtype=self.y.dtype, device=self.y.device),
            torch.tensor([self.noise_level], dtype=self.y.dtype, device=self.y.device),
            eta, method=method,
        )
        if not bool(est.ok[0]):
            raise ValueError("inverse covariance not positive definite, increase eta")
        self.weight_method = method
        self.t_estimation = t_est
        self.state_estimate = est.state_estimate[0]
        self.ddt_estimate = est.ddt_estimate[0]
        self.ddt_covariance = est.ddt_covariance[0]
        self.sqrtW = est.weight_root[0]
        self.lowrank_root = None
        return self

    _EST_FIELDS = ("t_estimation", "state_estimate", "ddt_estimate", "ddt_covariance", "sqrtW")

    def save(self, path: str):
        """Write the fitted GP with its estimation products, the factored
        root included, to a NumPy ``.npz`` file (the JAX package's
        layout), so that a loaded GP is usable at once."""
        payload = dict(
            t_training=self.t_training.cpu().numpy(), y=self.y.cpu().numpy(),
            constant=self.constant, length_scale=self.length_scale,
            noise_level=self.noise_level,
        )
        if self.state_estimate is not None:
            payload["weight_method"] = self.weight_method
            for name in self._EST_FIELDS:
                value = getattr(self, name)
                if value is not None:
                    payload[name] = value.cpu().numpy()
        if self.lowrank_root is not None:
            root = self.lowrank_root
            payload.update(
                lowrank_Q=root.Q.cpu().numpy(), lowrank_gain=root.gain.cpu().numpy(),
                lowrank_lam=root.lam.cpu().numpy(), lowrank_eta=float(root.eta),
                lowrank_resid=float(root.resid),
            )
        np.savez(path, **payload)

    @staticmethod
    def load(path: str, *, device: DeviceLike) -> "GaussianProcess":
        """Read a GP written by ``save`` (or by the JAX package) onto
        ``device``."""
        put = lambda x: torch.as_tensor(np.array(x), device=device)
        with np.load(path) as z:
            gp = GaussianProcess(
                put(z["t_training"]), put(z["y"]), float(z["constant"]),
                float(z["length_scale"]), float(z["noise_level"]),
            )
            if "state_estimate" in z:
                gp.weight_method = str(z["weight_method"])
                for name in GaussianProcess._EST_FIELDS:
                    if name in z:
                        setattr(gp, name, put(z[name]))
            if "lowrank_Q" in z:
                gp.lowrank_root = LowRankWeightRoot(
                    put(z["lowrank_Q"]), put(z["lowrank_gain"]), put(z["lowrank_lam"]),
                    float(z["lowrank_eta"]), float(z["lowrank_resid"]),
                )
        return gp


@span("gp.fit")
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
    lowrank_min_points: int = LOWRANK_MIN_POINTS,
) -> List[GaussianProcess]:
    """Fit one GP to every row of ``snapshots_sampled`` in one batch.

    ``time_domain_training`` are the m' estimation times,
    ``time_domain_sampled`` the (m,) sample times, or (r, m) for times
    of each row's own, and ``snapshots_sampled`` the (r, m) samples.
    ``generator`` draws the random restarts; ``z0`` replaces them (see
    ``fit_gp_hyperparameters``). ``weight_method`` as in
    ``resolve_weight_method``, ``lowrank_min_points`` being where "auto"
    turns to the factored root. Raises ValueError if a mode's weight
    covariance is not positive definite.
    """
    Y = torch.atleast_2d(snapshots_sampled)
    t_est = time_domain_training
    weight_method = resolve_weight_method(weight_method, t_est.shape[0], lowrank_min_points)
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
    with span("gp.estimates"):
        if weight_method == "lowrank":
            return _fit_lowrank_gps(T, Y, t_est, fit, float(gp_regularizer))
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


def regression_weights(gps_by_row):
    """The weights of ``solve.weighted_lstsq_fit`` from fitted GPs,
    ``gps_by_row[i][b]`` being the GP of problem row i and block b:
    ``(weight_roots, weights_are_cholesky)``, the roots a (r, B, m', m')
    tensor for a dense weight method and nested factored roots for
    "lowrank"."""
    method = gps_by_row[0][0].weight_method
    if method == "lowrank":
        return [[gp.lowrank_root for gp in row] for row in gps_by_row], False
    roots = torch.stack([torch.stack([gp.sqrtW for gp in row]) for row in gps_by_row])
    return roots, method == "chol"


def _fit_lowrank_gps(T, Y, t_est, fit, eta: float) -> List[GaussianProcess]:
    """Estimation with factored roots (``gp.lowrank``) for every mode at
    once. The dense ``ddt_covariance`` and ``sqrtW`` stay None; the
    regression applies ``GaussianProcess.lowrank_root`` by two thin
    products per right-hand side."""
    ests = batched_lowrank_gp_estimates(T, Y, t_est, fit.sigma2, fit.ell, fit.chi, eta=eta)
    hyper = torch.stack([fit.sigma2, fit.ell, fit.chi], dim=1).tolist()
    return [
        GaussianProcess(
            T[i], Y[i], *hyper[i],
            t_estimation=t_est,
            state_estimate=est.state_estimate,
            ddt_estimate=est.ddt_estimate,
            weight_method="lowrank",
            lowrank_root=est.root,
        )
        for i, est in enumerate(ests)
    ]
