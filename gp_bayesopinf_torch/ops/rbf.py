"""Squared-exponential kernel and its derivative kernels
(counterpart of ``gp_bayesopinf_tpu/ops/rbf.py``).

For kappa(t, t') = sigma2 exp(-(t - t')^2 / (2 ell^2)):

    K_yy     = kappa(t, t) + chi I                       (m, m)
    kappa_zy = kappa(t_est, t)                           (m', m)
    K_zy     = d/dt1 kappa(t_est, t)                     (m', m)
    K_zz     = d^2/(dt1 dt2) kappa(t_est, t_est)         (m', m')

Times may carry leading batch axes, (..., m); hyperparameters are Python
scalars or tensors of the batch shape (...), one value per GP.
"""

from typing import NamedTuple

import torch


def _hyper(x):
    """A per-GP hyperparameter broadcast against (..., m1, m2) matrices."""
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return x[..., None, None]
    return x


def _diff(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    return t1[..., :, None] - t2[..., None, :]


def rbf(t1: torch.Tensor, t2: torch.Tensor, sigma2, ell) -> torch.Tensor:
    """kappa(t1, t2) = sigma2 exp(-(t1 - t2)^2 / (2 ell^2)), (..., m1, m2)."""
    diff = _diff(t1, t2)
    sigma2, ell = _hyper(sigma2), _hyper(ell)
    return sigma2 * torch.exp(-(diff * diff) / (2.0 * ell * ell))


def rbf_gram(t: torch.Tensor, sigma2, ell, chi) -> torch.Tensor:
    """K_yy = kappa(t, t) + chi I, the noisy training Gram matrix."""
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    return rbf(t, t, sigma2, ell) + _hyper(chi) * eye


def derivative_gram(t_est: torch.Tensor, t: torch.Tensor, sigma2, ell):
    """(K_zy (..., m', m), K_zz (..., m', m')) derivative kernel blocks."""
    K = lstsq_kernel_matrices(t, t_est, sigma2, ell, 0.0)
    return K.K_zy, K.K_zz


class KernelMatrices(NamedTuple):
    """All Gram blocks the GP-BayesOpInf least-squares stage needs."""

    K_yy: torch.Tensor  # (..., m, m)   kappa(t, t) + chi I
    kappa_zy: torch.Tensor  # (..., m', m)  kappa(t_est, t)
    K_zy: torch.Tensor  # (..., m', m)  d1 kappa(t_est, t)
    K_zz: torch.Tensor  # (..., m', m') d1 d2 kappa(t_est, t_est)


def lstsq_kernel_matrices(
    t: torch.Tensor, t_est: torch.Tensor, sigma2, ell, chi
) -> KernelMatrices:
    """Every kernel matrix used downstream, from one set of hyperparameters
    per GP. ``t`` is (..., m) training times, ``t_est`` (m',) or (..., m')
    estimation times."""
    dyy = _diff(t, t)
    sigma2, ell, chi = (_hyper(x) for x in (sigma2, ell, chi))
    ell2 = ell * ell

    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    K_yy = sigma2 * torch.exp(-(dyy * dyy) / (2.0 * ell2)) + chi * eye

    dzy = _diff(t_est, t)
    kappa_zy = sigma2 * torch.exp(-(dzy * dzy) / (2.0 * ell2))
    K_zy = -dzy * kappa_zy / ell2

    dzz = _diff(t_est, t_est)
    kzz = sigma2 * torch.exp(-(dzz * dzz) / (2.0 * ell2))
    K_zz = (1.0 - dzz * dzz / ell2) * kzz / ell2
    return KernelMatrices(K_yy, kappa_zy, K_zy, K_zz)
