"""Gaussian posteriors over ROM operators and posterior-ensemble prediction
(counterpart of ``gp_bayesopinf_tpu/bayes/posterior.py``).

``OperatorPosterior`` holds one Gaussian per operator row, N(mean_i,
F_i F_i^T), with the covariance factor F_i = V_i diag(1/sqrt(S_i^2 +
lambda^2)) from the regression's spectral form. A draw is mean + F xi.
The ensemble integrates all draws as one batch (a leading draw axis) in
float64 and masks draws that leave the 5x-amplitude envelope or diverge.
``BayesianROM`` holds a posterior over ROM operators, ``BayesianODE`` one
Gaussian (a single row) over the parameters of an ODE model. The
ensembles' integration is the span ``posterior.integrate``
(``utils.timing``).
"""

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..rom.model import GalerkinROM
from ..solve.ivp import finite_mask, stability_mask
from ..solve.lstsq import WeightedLSTSQ
from ..utils.timing import span


class OperatorPosterior(NamedTuple):
    """Row-wise Gaussian posterior N(means[i], F_i F_i^T)."""

    means: torch.Tensor  # (r, d)
    cov_factors: torch.Tensor  # (r, d, d)

    @property
    def nrows(self) -> int:
        return self.means.shape[0]

    @property
    def ncols(self) -> int:
        return self.means.shape[1]

    @staticmethod
    def from_lstsq(lstsq: WeightedLSTSQ, lam: float) -> "OperatorPosterior":
        """Posterior of the weighted regression at regularizer lambda."""
        scale = torch.rsqrt(torch.clamp(lstsq.precision_eigs(lam), min=1e-300))
        return OperatorPosterior(lstsq.solve(lam), lstsq.V * scale[:, None, :])

    @staticmethod
    def from_moments(means: torch.Tensor, covs: torch.Tensor) -> "OperatorPosterior":
        """Posterior from dense means (r, d) or (d,) and covariances
        (r, d, d) or (d, d), factored by Cholesky."""
        means = torch.atleast_2d(means)
        if covs.ndim == 2:
            covs = covs[None]
        return OperatorPosterior(means, torch.linalg.cholesky(covs))

    def covariances(self) -> torch.Tensor:
        return torch.einsum("rik,rjk->rij", self.cov_factors, self.cov_factors)

    def sample(
        self,
        ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
        batch_shape: Tuple[int, ...] = (),
    ) -> torch.Tensor:
        """(*batch_shape, ndraws, r, d) operator draws; the standard normals
        ``xi`` come from ``generator`` unless given (then their shape sets
        the result's)."""
        if xi is None:
            xi = torch.randn(
                tuple(batch_shape) + (ndraws, self.nrows, self.ncols),
                generator=generator, dtype=self.means.dtype, device=self.means.device,
            )
        return self.means + torch.einsum("rij,...nrj->...nri", self.cov_factors, xi)


@dataclasses.dataclass(frozen=True)
class BayesianROM:
    """Bayesian reduced-order model: operator posterior + ROM structure."""

    model: GalerkinROM
    posterior: OperatorPosterior
    regularizer: Optional[float] = None

    @property
    def ndims(self) -> int:
        return self.model.state_dimension

    @property
    def means(self) -> torch.Tensor:
        return self.posterior.means

    @property
    def covs(self) -> torch.Tensor:
        return self.posterior.covariances()

    def rvs(
        self,
        ndraws: Optional[int] = 1,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Operator draws (ndraws, r, d); the standard normals ``xi``,
        (ndraws, r, d), come from ``generator`` unless given."""
        return self.posterior.sample(ndraws, generator, xi)

    def predict(
        self,
        initial_conditions: torch.Tensor,
        timepoints: torch.Tensor,
        input_func: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One posterior draw integrated through the ROM, (r, k);
        ``xi`` (1, r, d) as in ``rvs``, ``input_func`` as in
        ``GalerkinROM.predict``."""
        ohat = self.rvs(1, generator, xi)[0]
        return self.model.predict(ohat, initial_conditions, timepoints, input_func)

    def solution_posterior(
        self,
        initial_conditions: torch.Tensor,
        timepoints: torch.Tensor,
        ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
        stability_envelope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        input_func: Optional[Callable] = None,
    ):
        """Posterior ensemble of ROM solutions.

        Parameters
        ----------
        initial_conditions : (r,) initial state, or (L, r) for L
            trajectories integrated as one batch, each with its own draws.
        timepoints : (k,) output times.
        ndraws, generator, xi : the draws, as in ``OperatorPosterior.sample``
            (``xi`` is (ndraws, r, d), or (L, ndraws, r, d)).
        stability_envelope : optional (shift, limits), each (r,) or (L, r);
            draws outside the envelope, or non-finite, are marked invalid.
        input_func : the ROM's inputs, as in ``GalerkinROM.predict``; for
            L trajectories it returns (L, 1, m, n).

        Returns
        -------
        draws : ([L,] ndraws, r, k). valid : ([L,] ndraws) bool.
        """
        batch = initial_conditions.shape[:-1]
        ohats = self.posterior.sample(ndraws, generator, xi, batch_shape=batch)
        with span("posterior.integrate"):
            draws = self.model.predict(
                ohats, initial_conditions[..., None, :], timepoints, input_func
            )
        if stability_envelope is None:
            return draws, finite_mask(draws)
        shift, limits = (x[..., None, :] for x in stability_envelope)
        return draws, stability_mask(draws, shift, limits)


@dataclasses.dataclass(frozen=True)
class BayesianODE:
    """Bayesian posterior over the parameters of an ODE model.

    ``model`` exposes ``solve(initial_conditions, timepoints,
    parameters=...)`` taking a leading axis of parameter draws
    (``models.seird.SEIRD2``). The posterior has one row: the d parameters.
    """

    OVERSAMPLE = 8  # candidates per draw of ``rvs(nonnegative=True)``

    model: object
    posterior: OperatorPosterior  # r = 1 row, d parameters
    regularizer: Optional[float] = None

    @property
    def mean(self) -> torch.Tensor:
        return self.posterior.means[0]

    @property
    def cov(self) -> torch.Tensor:
        return self.posterior.covariances()[0]

    @property
    def num_params(self) -> int:
        return self.posterior.ncols

    def rvs(
        self,
        ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
        nonnegative: bool = False,
    ) -> torch.Tensor:
        """Parameter draws (ndraws, d); the standard normals ``xi``,
        (ndraws, 1, d), come from ``generator`` unless given.

        With ``nonnegative=True`` each draw is the first of
        ``OVERSAMPLE`` candidates without a negative component (``xi`` is
        then (OVERSAMPLE ndraws, 1, d), a draw's candidates contiguous),
        or the mean if it has none.
        """
        if not nonnegative:
            return self.posterior.sample(ndraws, generator, xi)[:, 0, :]
        if ndraws is not None:
            ndraws = ndraws * self.OVERSAMPLE
        pool = self.posterior.sample(ndraws, generator, xi)[:, 0, :]
        pool = pool.reshape(-1, self.OVERSAMPLE, self.num_params)
        ok = torch.all(pool >= 0, dim=-1)  # (ndraws, OVERSAMPLE)
        first = torch.argmax(ok.to(torch.int8), dim=1)  # the first maximum
        chosen = pool[torch.arange(pool.shape[0], device=pool.device), first]
        return torch.where(ok.any(dim=1)[:, None], chosen, self.mean)

    def predict(
        self, initial_conditions: torch.Tensor, timepoints: torch.Tensor,
        generator: Optional[torch.Generator] = None, xi: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One posterior draw integrated through the model, (n, k)."""
        params = self.rvs(1, generator, xi)[0]
        return self.model.solve(initial_conditions, timepoints, parameters=params)

    def solution_posterior(
        self,
        initial_conditions: torch.Tensor,
        timepoints: torch.Tensor,
        ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
        stability_envelope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """Posterior ensemble of model solutions from the (n,) initial
        state, all draws integrated as one batch.

        ``ndraws``, ``generator`` and ``xi`` as in ``rvs``;
        ``stability_envelope`` an optional (shift (n,), limits (n,)).
        Returns draws (ndraws, n, k) and valid (ndraws,) bool.
        """
        params = self.rvs(ndraws, generator, xi)
        with span("posterior.integrate"):
            draws = self.model.solve(initial_conditions, timepoints, parameters=params)
        if stability_envelope is None:
            return draws, finite_mask(draws)
        return draws, stability_mask(draws, *stability_envelope)
