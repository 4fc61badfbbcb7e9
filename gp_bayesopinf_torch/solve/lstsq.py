"""Weighted, regularized least squares through one batched SVD
(counterpart of ``gp_bayesopinf_tpu/solve/lstsq.py``, dense weight roots;
the Tikhonov variants and factored roots come later).

For each operator row i = 1..r the Bayesian regression solves

    min_o || D o - z_i ||^2_{W_i} + lambda^2 || o ||^2,   W_i = sqrtW_i^T sqrtW_i.

With one SVD per row, sqrtW_i D = U_i S_i V_i^T, everything downstream is
spectral and reuses the factorization across regularization candidates:

    mean_i(lambda)   = V_i diag(S_i / (S_i^2 + lambda^2)) U_i^T z~_i
    P_i(lambda)      = V_i diag(S_i^2 + lambda^2) V_i^T
    sample_i(lambda) = mean_i + V_i (xi / sqrt(S_i^2 + lambda^2)).

Methods taking ``lam`` accept a scalar or a 1-D tensor of candidates;
each candidate then adds a leading axis to the result.
"""

from typing import NamedTuple, Optional

import torch


class WeightedLSTSQ(NamedTuple):
    """Spectral factorization of r weighted regressions with d unknowns
    and M weighted rows each."""

    U: torch.Tensor  # (r, M, d)
    S: torch.Tensor  # (r, d)
    V: torch.Tensor  # (r, d, d) right singular vectors as columns
    Utz: torch.Tensor  # (r, d) U^T z~
    Dt: torch.Tensor  # (r, M, d) weighted data matrices sqrtW D
    zt: torch.Tensor  # (r, M) weighted right-hand sides

    @property
    def num_problems(self) -> int:
        return self.S.shape[0]

    @property
    def num_unknowns(self) -> int:
        return self.S.shape[1]

    def _lam2(self, lam) -> torch.Tensor:
        lam = torch.as_tensor(lam, dtype=self.S.dtype, device=self.S.device)
        return (lam * lam)[..., None, None]  # broadcasts against (r, d)

    def solve(self, lam) -> torch.Tensor:
        """Posterior mean rows, (..., r, d)."""
        filt = self.S / (self.S * self.S + self._lam2(lam))
        return torch.einsum("rij,...rj->...ri", self.V, filt * self.Utz)

    def precision_eigs(self, lam) -> torch.Tensor:
        """Eigenvalues S^2 + lambda^2 of each row's precision, (..., r, d).
        The eigenvectors are the columns of V."""
        return self.S * self.S + self._lam2(lam)

    def posterior_spd(self, lam) -> torch.Tensor:
        """(...) bool: every row's posterior covariance is SPD."""
        eigs = self.precision_eigs(lam)
        return ((eigs > 0) & torch.isfinite(eigs)).flatten(-2).all(dim=-1)

    def sample(
        self,
        lam,
        ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Operator-row draws from N(mean, P^{-1}), (..., ndraws, r, d).

        The standard normals ``xi``, shaped (..., ndraws, r, d), come from
        ``generator`` unless given.
        """
        mean = self.solve(lam)
        scale = torch.rsqrt(torch.clamp(self.precision_eigs(lam), min=1e-300))
        if xi is None:
            xi = torch.randn(
                mean.shape[:-2] + (ndraws,) + mean.shape[-2:],
                generator=generator, dtype=self.S.dtype, device=self.S.device,
            )
        dev = torch.einsum("rij,...nrj->...nri", self.V, xi * scale[..., None, :, :])
        return mean[..., None, :, :] + dev

    def covariances(self, lam) -> torch.Tensor:
        """Dense posterior covariances (..., r, d, d)."""
        inv = 1.0 / self.precision_eigs(lam)
        return torch.einsum("rik,...rk,rjk->...rij", self.V, inv, self.V)

    def precisions(self, lam) -> torch.Tensor:
        """Dense posterior precisions (..., r, d, d)."""
        return torch.einsum("rik,...rk,rjk->...rij", self.V, self.precision_eigs(lam), self.V)


def weighted_lstsq_fit(
    D_blocks: torch.Tensor, weight_roots: torch.Tensor, rhs: torch.Tensor,
    weights_are_cholesky: bool = False,
) -> WeightedLSTSQ:
    """Weight the blocks and factorize every row problem at once.

    Parameters
    ----------
    D_blocks : (B, m, d) unweighted data-matrix blocks (B = 1 for one
        trajectory, the number of state variables for the ODE parameter
        problem, the number of trajectories for several).
    weight_roots : (r, B, m, m) roots R with W = R^T R (the GP ``sqrtW``
        matrices).
    rhs : (r, B, m) unweighted right-hand sides (GP ddt estimates).
    weights_are_cholesky : the roots are lower Cholesky factors L of the
        weights' inverses (the GP derivative covariance C + eta I =
        L L^T), applied as L^{-1} by triangular solves.
    """
    r, B, m, _ = weight_roots.shape
    d = D_blocks.shape[-1]
    if tuple(D_blocks.shape) != (B, m, d):
        raise ValueError(f"D_blocks shape {tuple(D_blocks.shape)} != {(B, m, d)}")
    if tuple(rhs.shape) != (r, B, m):
        raise ValueError(f"rhs shape {tuple(rhs.shape)} != {(r, B, m)}")
    if B * m < d:
        raise ValueError("underdetermined problem: need B*m >= d")

    if weights_are_cholesky:
        Dt = torch.linalg.solve_triangular(weight_roots, D_blocks[None], upper=False)
        zt = torch.linalg.solve_triangular(weight_roots, rhs[..., None], upper=False)
    else:
        Dt = torch.einsum("rbij,bjd->rbid", weight_roots, D_blocks)
        zt = torch.einsum("rbij,rbj->rbi", weight_roots, rhs)
    Dt, zt = Dt.reshape(r, B * m, d), zt.reshape(r, B * m)
    U, S, Vh = torch.linalg.svd(Dt, full_matrices=False)
    V = Vh.transpose(-1, -2)
    Utz = torch.einsum("rmd,rm->rd", U, zt)
    return WeightedLSTSQ(U, S, V, Utz, Dt, zt)
