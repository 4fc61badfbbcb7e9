"""Gaussian posteriors over ROM operators and posterior-ensemble prediction
(counterpart of ``gp_bayesopinf_tpu/bayes/posterior.py``, ``BayesianROM``).

``OperatorPosterior`` holds one Gaussian per operator row, N(mean_i,
F_i F_i^T), with the covariance factor F_i = V_i diag(1/sqrt(S_i^2 +
lambda^2)) from the regression's spectral form. A draw is mean + F xi.
The ensemble integrates all draws as one batch (a leading draw axis) in
float64 and masks draws that leave the 5x-amplitude envelope or diverge.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

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
    ) -> torch.Tensor:
        """(ndraws, r, d) operator draws; the standard normals ``xi`` come
        from ``generator`` unless given."""
        if xi is None:
            xi = torch.randn(
                (ndraws, self.nrows, self.ncols), generator=generator,
                dtype=self.means.dtype, device=self.means.device,
            )
        return self.means[None] + torch.einsum("rij,nrj->nri", self.cov_factors, xi)


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
    ):
        """Posterior ensemble of ROM solutions.

        Parameters
        ----------
        initial_conditions : (r,) initial state.
        timepoints : (k,) output times.
        ndraws, generator, xi : the draws, as in ``OperatorPosterior.sample``.
        stability_envelope : optional (shift (r,), limits (r,)); draws
            outside the envelope, or non-finite, are marked invalid.

        Returns
        -------
        draws : (ndraws, r, k). valid : (ndraws,) bool.
        """
        ohats = self.posterior.sample(ndraws, generator, xi)
        draws = self.model.predict(ohats, initial_conditions, timepoints)
        if stability_envelope is None:
            return draws, finite_mask(draws)
        shift, limits = stability_envelope
        return draws, stability_mask(draws, shift, limits)
