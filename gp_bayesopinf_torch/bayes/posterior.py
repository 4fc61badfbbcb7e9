"""Gaussian posteriors over ROM operators and posterior-ensemble prediction
(counterpart of ``gp_bayesopinf_tpu/bayes/posterior.py``, ``BayesianROM``).

``OperatorPosterior`` holds one Gaussian per operator row, N(mean_i,
F_i F_i^T), with the covariance factor F_i = V_i diag(1/sqrt(S_i^2 +
lambda^2)) from the regression's spectral form. A draw is mean + F xi.
The ensemble integrates all draws as one batch (a leading draw axis) in
float64 and masks draws that leave the 5x-amplitude envelope or diverge.
"""

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..rom.model import GalerkinROM
from ..solve.ivp import finite_mask, stability_mask
from ..solve.lstsq import WeightedLSTSQ


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
        draws = self.model.predict(
            ohats, initial_conditions[..., None, :], timepoints, input_func
        )
        if stability_envelope is None:
            return draws, finite_mask(draws)
        shift, limits = (x[..., None, :] for x in stability_envelope)
        return draws, stability_mask(draws, shift, limits)
