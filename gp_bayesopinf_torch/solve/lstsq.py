"""Weighted, regularized least squares through one batched SVD
(counterpart of ``gp_bayesopinf_tpu/solve/lstsq.py``).

For each operator row i = 1..r the Bayesian regression solves

    min_o || D o - z_i ||^2_{W_i} + lambda^2 || o ||^2,   W_i = sqrtW_i^T sqrtW_i.

With one SVD per row, sqrtW_i D = U_i S_i V_i^T, everything downstream is
spectral and reuses the factorization across regularization candidates:

    mean_i(lambda)   = V_i diag(S_i / (S_i^2 + lambda^2)) U_i^T z~_i
    P_i(lambda)      = V_i diag(S_i^2 + lambda^2) V_i^T
    sample_i(lambda) = mean_i + V_i (xi / sqrt(S_i^2 + lambda^2)).

Methods taking ``lam`` accept a scalar or a 1-D tensor of candidates;
each candidate then adds a leading axis to the result. With
``per_row=True`` the last axis of ``lam`` holds one regularizer per row
problem, (..., r), and the axes before it are the candidates.

A regularizer that is not a multiple of the identity (a diagonal or a
full Tikhonov matrix Gamma) is not diagonalized by the data's singular
vectors. ``TikhonovLSTSQ`` and ``MatrixTikhonovLSTSQ`` hold the normal
equations instead, contracted once, so that each candidate of a search
costs one batched (d, d) Cholesky. Their regularizer arguments take
leading candidate axes like ``lam`` above.
"""

from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch


def _draws(L: torch.Tensor, mean: torch.Tensor, ndraws, generator, xi) -> torch.Tensor:
    """mean + L^{-T} xi for lower factors ``L`` (..., r, d, d) of the
    precisions: draws (..., ndraws, r, d) from N(mean, P^{-1}). The
    standard normals ``xi``, shaped like the result, come from
    ``generator`` unless given."""
    if xi is None:
        xi = torch.randn(
            mean.shape[:-2] + (ndraws,) + mean.shape[-2:],
            generator=generator, dtype=mean.dtype, device=mean.device,
        )
    dev = torch.linalg.solve_triangular(
        L.transpose(-1, -2), xi.movedim(-3, -1), upper=True
    )  # (..., r, d, ndraws)
    return mean[..., None, :, :] + dev.movedim(-1, -3)


def _cholesky_spd(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """(...) bool from factors (..., r, d, d) and their ``cholesky_ex``
    info (..., r): every row's factorization succeeded with a finite,
    positive diagonal."""
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (torch.isfinite(diag) & (diag > 0)).all(dim=-1) & (info == 0)
    return ok.all(dim=-1)


def _per_row_gamma(Gamma: torch.Tensor, r: int, d: int) -> torch.Tensor:
    """A (d, d) or (r, d, d) Tikhonov matrix as (r, d, d)."""
    if tuple(Gamma.shape) == (d, d):
        return Gamma.expand(r, d, d)
    if tuple(Gamma.shape) != (r, d, d):
        raise ValueError(
            f"Gamma shape {tuple(Gamma.shape)} is neither {(d, d)} nor {(r, d, d)}"
        )
    return Gamma


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

    def _lam2(self, lam, per_row: bool = False) -> torch.Tensor:
        lam = torch.as_tensor(lam, dtype=self.S.dtype, device=self.S.device)
        lam2 = lam * lam
        return lam2[..., None] if per_row else lam2[..., None, None]  # against (r, d)

    def solve(self, lam, per_row: bool = False) -> torch.Tensor:
        """Posterior mean rows, (..., r, d)."""
        filt = self.S / (self.S * self.S + self._lam2(lam, per_row))
        return torch.einsum("rij,...rj->...ri", self.V, filt * self.Utz)

    def precision_eigs(self, lam, per_row: bool = False) -> torch.Tensor:
        """Eigenvalues S^2 + lambda^2 of each row's precision, (..., r, d).
        The eigenvectors are the columns of V."""
        return self.S * self.S + self._lam2(lam, per_row)

    def posterior_spd(self, lam, per_row: bool = False) -> torch.Tensor:
        """(...) bool: every row's posterior covariance is SPD."""
        eigs = self.precision_eigs(lam, per_row)
        return ((eigs > 0) & torch.isfinite(eigs)).flatten(-2).all(dim=-1)

    def sample(
        self,
        lam,
        ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        xi: Optional[torch.Tensor] = None,
        per_row: bool = False,
    ) -> torch.Tensor:
        """Operator-row draws from N(mean, P^{-1}), (..., ndraws, r, d).

        The standard normals ``xi``, shaped (..., ndraws, r, d), come from
        ``generator`` unless given.
        """
        mean = self.solve(lam, per_row)
        scale = torch.rsqrt(torch.clamp(self.precision_eigs(lam, per_row), min=1e-300))
        if xi is None:
            xi = torch.randn(
                mean.shape[:-2] + (ndraws,) + mean.shape[-2:],
                generator=generator, dtype=self.S.dtype, device=self.S.device,
            )
        dev = torch.einsum("rij,...nrj->...nri", self.V, xi * scale[..., None, :, :])
        return mean[..., None, :, :] + dev

    def _normal_equations(self):
        DtD = torch.einsum("rmi,rmj->rij", self.Dt, self.Dt)
        Dtz = torch.einsum("rmi,rm->ri", self.Dt, self.zt)
        return DtD, Dtz

    def _as(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.S.dtype, device=self.S.device)

    def solve_tikhonov(self, gamma_diag) -> torch.Tensor:
        """Posterior mean rows (r, d) with a diagonal Tikhonov regularizer,
        ``gamma_diag`` (d,) or (r, d): the normal equations
        (D~^T D~ + diag(gamma^2)) o = D~^T z~ solved directly."""
        g = self._as(gamma_diag).expand(self.num_problems, self.num_unknowns)
        DtD, Dtz = self._normal_equations()
        return torch.linalg.solve(DtD + torch.diag_embed(g * g), Dtz)

    def posterior_tikhonov(self, Gamma):
        """(means (r, d), precisions (r, d, d)) under a full Tikhonov
        matrix ``Gamma``, (d, d) for every row or (r, d, d): the precision
        is D~^T D~ + Gamma^T Gamma."""
        Gamma = _per_row_gamma(self._as(Gamma), self.num_problems, self.num_unknowns)
        DtD, Dtz = self._normal_equations()
        P = DtD + torch.einsum("rki,rkj->rij", Gamma, Gamma)
        return torch.linalg.solve(P, Dtz), P

    def solve_tikhonov_matrix(self, Gamma) -> torch.Tensor:
        """Posterior mean rows with a full Tikhonov matrix
        (``posterior_tikhonov``)."""
        return self.posterior_tikhonov(Gamma)[0]

    def tikhonov(self) -> "TikhonovLSTSQ":
        """The normal equations, contracted once, for repeated solves with
        diagonal Tikhonov regularizers."""
        return TikhonovLSTSQ(*self._normal_equations())

    def matrix_tikhonov(self, Gamma) -> "MatrixTikhonovLSTSQ":
        """The same for a search over scaled full regularizers ``scale *
        Gamma``; ``Gamma`` (d, d) for every row or (r, d, d)."""
        Gamma = _per_row_gamma(self._as(Gamma), self.num_problems, self.num_unknowns)
        G2 = torch.einsum("rki,rkj->rij", Gamma, Gamma)
        return MatrixTikhonovLSTSQ(*self._normal_equations(), G2)

    def covariances(self, lam) -> torch.Tensor:
        """Dense posterior covariances (..., r, d, d)."""
        inv = 1.0 / self.precision_eigs(lam)
        return torch.einsum("rik,...rk,rjk->...rij", self.V, inv, self.V)

    def precisions(self, lam) -> torch.Tensor:
        """Dense posterior precisions (..., r, d, d)."""
        return torch.einsum("rik,...rk,rjk->...rij", self.V, self.precision_eigs(lam), self.V)


class _NormalEquations:
    """What the two normal-equation factorizations share: the factor of a
    candidate's precision, and solve, sample and posterior_spd from it."""

    @property
    def num_problems(self) -> int:
        return self.DtD.shape[0]

    @property
    def num_unknowns(self) -> int:
        return self.DtD.shape[-1]

    def _factor(self, reg):
        L, info = torch.linalg.cholesky_ex(self.precision(reg))
        return torch.where((info == 0)[..., None, None], L, torch.nan), info

    def precision_cholesky(self, reg) -> torch.Tensor:
        """Lower Cholesky factors (..., r, d, d) of the precisions. Where
        a precision is not positive definite the factor is NaN, so are
        that row's mean and draws, and ``posterior_spd`` is False: a
        batched screen rejects the candidate and goes on."""
        return self._factor(reg)[0]

    def _solve(self, L: torch.Tensor) -> torch.Tensor:
        return torch.cholesky_solve(self.Dtz[..., None].expand(L.shape[:-1] + (1,)), L)[..., 0]

    def solve(self, reg) -> torch.Tensor:
        """Posterior mean rows, (..., r, d)."""
        return self._solve(self.precision_cholesky(reg))

    def sample(
        self, reg, ndraws: Optional[int] = None,
        generator: Optional[torch.Generator] = None, xi: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Operator-row draws from N(mean, P^{-1}), (..., ndraws, r, d):
        with P = L L^T, L^{-T} xi has covariance P^{-1}. The standard
        normals ``xi``, shaped like the result, come from ``generator``
        unless given."""
        L = self.precision_cholesky(reg)
        return _draws(L, self._solve(L), ndraws, generator, xi)

    def posterior_spd(self, reg) -> torch.Tensor:
        """(...) bool: every row's precision has a finite Cholesky factor."""
        return _cholesky_spd(*self._factor(reg))


class TikhonovLSTSQ(
    _NormalEquations, NamedTuple("_T", [("DtD", torch.Tensor), ("Dtz", torch.Tensor)])
):
    """Normal equations of r weighted regressions, for searches over
    diagonal Tikhonov regularizers: P = DtD + diag(gamma^2).

    ``DtD`` (r, d, d) are the Gram matrices (sqrtW D)^T (sqrtW D), ``Dtz``
    (r, d) the right-hand sides (sqrtW D)^T z~. A regularizer
    ``gamma_diag`` is a scalar, (d,) or (r, d), or (..., r, d) for
    several candidates.
    """

    def precision(self, gamma_diag) -> torch.Tensor:
        g = torch.as_tensor(gamma_diag, dtype=self.DtD.dtype, device=self.DtD.device)
        g = g.expand(g.shape[:-2] + (self.num_problems, self.num_unknowns))
        return self.DtD + torch.diag_embed(g * g)


class MatrixTikhonovLSTSQ(
    _NormalEquations,
    NamedTuple("_M", [("DtD", torch.Tensor), ("Dtz", torch.Tensor), ("G2", torch.Tensor)]),
):
    """Normal equations for a search over scaled full Tikhonov matrices
    ``scale_i * Gamma_i``, one fixed Gamma per row and a multiplier
    searched: P_i(s) = DtD_i + s_i^2 G2_i with ``G2`` (r, d, d) = Gamma^T
    Gamma. ``scale`` is a scalar or (r,), or (..., r) for several
    candidates. Built by ``WeightedLSTSQ.matrix_tikhonov``.
    """

    def precision(self, scale) -> torch.Tensor:
        s = torch.as_tensor(scale, dtype=self.DtD.dtype, device=self.DtD.device)
        s = s.expand(s.shape[:-1] + (self.num_problems,))
        return self.DtD + (s * s)[..., None, None] * self.G2


def weighted_lstsq_fit(
    D_blocks: torch.Tensor,
    weight_roots: Union[torch.Tensor, Sequence],
    rhs: torch.Tensor,
    weights_are_cholesky: bool = False,
    svd_fn: Optional[Callable] = None,
) -> WeightedLSTSQ:
    """Weight the blocks and factorize every row problem at once.

    Parameters
    ----------
    D_blocks : (B, m, d) unweighted data-matrix blocks (B = 1 for one
        trajectory, the number of state variables for the ODE parameter
        problem, the number of trajectories for several).
    weight_roots : (r, B, m, m) roots R with W = R^T R (the GP ``sqrtW``
        matrices). Anything but a tensor is taken as factored symmetric
        roots (``gp.lowrank.LowRankWeightRoot``): one per problem row, or
        a length-r sequence of length-B sequences, each applied by two
        thin products, so that no (m, m) matrix is formed.
    rhs : (r, B, m) unweighted right-hand sides (GP ddt estimates).
    weights_are_cholesky : the roots are lower Cholesky factors L of the
        weights' inverses (the GP derivative covariance C + eta I =
        L L^T), applied as L^{-1} by triangular solves. Ignored for
        factored roots.
    svd_fn : a thin SVD (r, M, d) -> (U, S, V) to use in place of
        ``torch.linalg.svd``, e.g. ``parallel.sharded.tall_skinny_svd``.
    """
    if not isinstance(weight_roots, torch.Tensor):
        Dt, zt = _apply_factored_roots(D_blocks, weight_roots, rhs)
        return _factorize(Dt, zt, svd_fn)
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
    return _factorize(Dt.reshape(r, B * m, d), zt.reshape(r, B * m), svd_fn)


def _factorize(Dt: torch.Tensor, zt: torch.Tensor, svd_fn: Optional[Callable]) -> WeightedLSTSQ:
    if svd_fn is not None:
        U, S, V = svd_fn(Dt)
    else:
        U, S, Vh = torch.linalg.svd(Dt, full_matrices=False)
        V = Vh.transpose(-1, -2)
    Utz = torch.einsum("rmd,rm->rd", U, zt)
    return WeightedLSTSQ(U, S, V, Utz, Dt, zt)


def _apply_factored_roots(D_blocks: torch.Tensor, roots: Sequence, rhs: torch.Tensor):
    """Weight with factored roots: (Dt (r, B m, d), zt (r, B m)), float64
    on the tensors' device. ``roots`` is a length-r sequence of roots
    (B = 1) or of length-B sequences of them."""
    if D_blocks.ndim == 2:
        D_blocks = D_blocks[None]
    B, m, d = D_blocks.shape
    r = rhs.shape[0]
    if tuple(rhs.shape) != (r, B, m):
        raise ValueError(f"rhs shape {tuple(rhs.shape)} != {(r, B, m)}")
    if B * m < d:
        raise ValueError("underdetermined problem: need B*m >= d")
    # A factored root is itself a tuple: tell a row of roots from a root
    # by its ``apply``.
    roots = [[row] if hasattr(row, "apply") else list(row) for row in roots]
    if len(roots) != r or any(len(row) != B for row in roots):
        raise ValueError(f"factored roots must be r={r} rows of B={B} blocks")
    Dt = torch.stack([
        torch.cat([roots[i][b].apply(D_blocks[b]) for b in range(B)]) for i in range(r)
    ])
    zt = torch.stack([
        torch.cat([roots[i][b].apply(rhs[i, b]) for b in range(B)]) for i in range(r)
    ])
    return Dt, zt
