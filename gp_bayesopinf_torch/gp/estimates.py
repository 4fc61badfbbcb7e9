"""GP state and time-derivative estimates and the least-squares weight
root (counterpart of ``gp_bayesopinf_tpu/gp/estimates.py``).

Given fitted hyperparameters (sigma2, ell, chi) and training data (t, y),
at the estimation times t_est:

    state_estimate  y~ = kappa_zy K_yy^{-1} y                    (m',)
    ddt_estimate    z~ = K_zy K_yy^{-1} y                        (m',)
    ddt_covariance  C  = K_zz - K_zy K_yy^{-1} K_yz (symmetrized)
    weight root        = (C + eta I)^{-1/2} via eigh, or
                         chol(C + eta I)                         (m', m')

All modes run as one batch on the caller's device in float64. The weight
root is the symmetric inverse square root (method "eigh", the default) or
the lower Cholesky factor L of C + eta I (method "chol"), which the
regression applies as L^{-1} by a triangular solve: the same weighted
norm without an eigendecomposition.
"""

from typing import NamedTuple

import torch

from ..ops.rbf import lstsq_kernel_matrices, rbf, rbf_gram


class GPEstimates(NamedTuple):
    """Per-mode estimation products, each with a leading (r,) axis."""

    state_estimate: torch.Tensor  # (r, m')
    ddt_estimate: torch.Tensor  # (r, m')
    ddt_covariance: torch.Tensor  # (r, m', m')
    weight_root: torch.Tensor  # (r, m', m') (C + eta I)^{-1/2}, or chol(C + eta I)
    ok: torch.Tensor  # (r,) bool: K_yy and C + eta I were SPD

    @property
    def sqrtW(self) -> torch.Tensor:
        return self.weight_root


def spd_inverse_sqrt(C: torch.Tensor, eta: float = 0.0):
    """((C + eta I)^{-1/2}, ok) for a batch of symmetric (..., n, n).

    ``ok`` is True where every eigenvalue of C + eta I is positive; the
    root is finite garbage elsewhere, for the caller to reject.
    """
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    w, V = torch.linalg.eigh(C + eta * eye)
    ok = torch.all(w > 0, dim=-1)
    w_safe = torch.where(w > 0, w, torch.ones_like(w))
    root = (V * torch.rsqrt(w_safe)[..., None, :]) @ V.transpose(-1, -2)
    return root, ok


def spd_cholesky(C: torch.Tensor, eta: float = 0.0):
    """(L, ok) with C + eta I = L L^T, L lower triangular, for a batch of
    symmetric (..., n, n). ``ok`` is False where the factorization broke
    down; L is garbage there, for the caller to reject."""
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(C + eta * eye)
    return L, info == 0


WEIGHT_ROOTS = {"eigh": spd_inverse_sqrt, "chol": spd_cholesky}


def batched_gp_estimates(
    T: torch.Tensor,
    Y: torch.Tensor,
    t_est: torch.Tensor,
    sigma2: torch.Tensor,
    ell: torch.Tensor,
    chi: torch.Tensor,
    eta: float = 1e-8,
    method: str = "eigh",
) -> GPEstimates:
    """Estimates for every mode at once.

    ``T`` and ``Y`` are (r, m), ``t_est`` (m',), the hyperparameters (r,).
    ``method`` picks the weight root: "eigh" or "chol".
    """
    if method not in WEIGHT_ROOTS:
        raise ValueError(f"unknown weight method '{method}'")
    K = lstsq_kernel_matrices(T, t_est, sigma2, ell, chi)
    L, info = torch.linalg.cholesky_ex(K.K_yy)
    alpha = torch.cholesky_solve(Y[..., None], L)  # (r, m, 1)
    state = (K.kappa_zy @ alpha)[..., 0]
    ddt = (K.K_zy @ alpha)[..., 0]

    # C = K_zz - K_zy K_yy^{-1} K_yz, symmetrized against roundoff.
    V = torch.cholesky_solve(K.K_zy.transpose(-1, -2), L)  # (r, m, m')
    cross = K.K_zy @ V
    C = K.K_zz - 0.5 * (cross + cross.transpose(-1, -2))

    root, ok = WEIGHT_ROOTS[method](C, eta)
    return GPEstimates(state, ddt, C, root, ok & (info == 0))


def gp_predict(t, y, t_query, sigma2, ell, chi):
    """Posterior predictive mean and standard deviation at query times, as
    ``sklearn.GaussianProcessRegressor.predict(return_std=True)`` gives
    them (the white-noise term counts in the prior variance)."""
    L = torch.linalg.cholesky(rbf_gram(t, sigma2, ell, chi))
    k_sy = rbf(t_query, t, sigma2, ell)
    mean = k_sy @ torch.cholesky_solve(y[:, None], L)[:, 0]
    Vs = torch.cholesky_solve(k_sy.T, L)  # (m, k)
    var = (sigma2 + chi) - torch.sum(k_sy * Vs.T, dim=1)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))
