"""Exact GP negative log marginal likelihood and the bound transform
(counterpart of ``gp_bayesopinf_tpu/gp/nlml.py``).

    NLML(theta) = 1/2 y^T K^{-1} y + 1/2 log|K| + m/2 log(2 pi),
    theta = (log sigma2, log ell, log chi),
    K = sigma2 exp(-(t - t')^2 / (2 ell^2)) + chi I.

Bounds are enforced by a smooth logistic reparameterization
(``BoxTransform``). Everything takes leading batch axes, so one call
evaluates a whole population of (mode, restart) instances.
"""

import math
from typing import NamedTuple

import torch

from ..ops.rbf import rbf_gram


def nlml(log_params: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood of the RBF + white-noise GP.

    Parameters
    ----------
    log_params : (..., 3) tensor of (log sigma2, log ell, log chi).
    t, y : (..., m) training times and targets.

    Returns
    -------
    (...) tensor. A failed Cholesky factorization gives +inf, so restart
    selection discards it: ``torch.linalg.cholesky`` would raise where
    JAX returns NaN, hence ``cholesky_ex`` and its ``info``.
    """
    sigma2, ell, chi = torch.exp(log_params).unbind(-1)
    m = t.shape[-1]
    K = rbf_gram(t, sigma2, ell, chi)
    L, info = torch.linalg.cholesky_ex(K)
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
    val = 0.5 * torch.sum(y * alpha, -1) + 0.5 * logdet + 0.5 * m * math.log(
        2.0 * math.pi
    )
    ok = (info == 0) & torch.isfinite(val)
    return torch.where(ok, val, torch.full_like(val, math.inf))


class BoxTransform(NamedTuple):
    """Smooth bijection from unconstrained R^3 onto a log-space box:
    log theta = lo + (hi - lo) * sigmoid(z)."""

    lo: torch.Tensor  # (3,) log lower bounds
    hi: torch.Tensor  # (3,) log upper bounds

    def to_log_params(self, z: torch.Tensor) -> torch.Tensor:
        return self.lo + (self.hi - self.lo) * torch.sigmoid(z)

    def from_log_params(self, log_params: torch.Tensor) -> torch.Tensor:
        # Clip strictly inside the box so the logit is finite.
        frac = (log_params - self.lo) / (self.hi - self.lo)
        frac = torch.clamp(frac, 1e-6, 1.0 - 1e-6)
        return torch.log(frac) - torch.log1p(-frac)

    @staticmethod
    def from_bounds(
        constant_bounds,
        length_scale_bounds,
        noise_level_bounds,
        *,
        device,
        dtype=torch.float64,
    ) -> "BoxTransform":
        """Build the transform from (lo, hi) hyperparameter bound pairs."""
        bounds = torch.tensor(
            [constant_bounds, length_scale_bounds, noise_level_bounds],
            dtype=dtype, device=device,
        )
        return BoxTransform(torch.log(bounds[:, 0]), torch.log(bounds[:, 1]))


def nlml_in_box(z: torch.Tensor, box: BoxTransform, t, y) -> torch.Tensor:
    """NLML as a function of the unconstrained coordinates."""
    return nlml(box.to_log_params(z), t, y)
