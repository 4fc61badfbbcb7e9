"""Low-rank GP weight roots for many estimation points
(counterpart of ``gp_bayesopinf_tpu/gp/lowrank.py``).

For the smooth RBF kernel the derivative-posterior covariance
``C = K_zz - K_zy K_yy^{-1} K_yz`` is numerically low rank. A pivoted
Cholesky run to tolerance gives ``C ~= U U^T`` with p << m' columns from
``diag(C)`` and p rows of C made on demand from closed-form kernel
entries: the (m', m') matrix is never formed. With the thin SVD
``U = Q S R^T`` and ``lam = S^2``, Woodbury gives

    (C + eta I)^{-1/2} = eta^{-1/2} (I - Q diag(1 - sqrt(eta / (eta + lam))) Q^T),

so applying the symmetric inverse square root, all the weighted
regression needs, is two (m', p) products per right-hand side.

Everything runs in float64 on the device of the tensors given. The
pivoted Cholesky is a sequential loop of an argmax, one kernel row and a
rank-p update; every mode shares the estimation grid, so the loop runs
over all r modes at once (one batched launch per step in place of r) with
a per-mode "done" mask, and each mode's pivots and rank are those of its
own one-mode loop. The product ``C @ Q`` of the Rayleigh-Ritz pass is a
blockwise dense product (the JAX package's Toeplitz FFT route saves host
flops the card does not lack).
"""

from typing import List, NamedTuple, Optional

import torch

# Stopping tolerance of the pivoted Cholesky as a fraction of the eta I
# regularizer (``tol_factor=None`` reads this): the JAX package's value,
# at which its ex1c (m' = 3200) stable count lands within ~1% of the dense
# root's.
DEFAULT_TOL_FACTOR = 1e-8


class LowRankWeightRoot(NamedTuple):
    """Factored (C + eta I)^{-1/2} = (I - Q diag(gain) Q^T) / sqrt(eta).

    ``Q`` has orthonormal columns; ``gain`` is 1 - sqrt(eta / (eta + lam))
    for the p retained eigenvalues ``lam`` of C.
    """

    Q: torch.Tensor  # (m', p)
    gain: torch.Tensor  # (p,)
    lam: torch.Tensor  # (p,)
    eta: float
    resid: float  # largest diagonal entry left by the pivoted Cholesky

    @property
    def rank(self) -> int:
        return self.Q.shape[1]

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        """(C + eta I)^{-1/2} @ X for X (m',) or (m', d): two thin products,
        the (m', m') root is never formed."""
        vec = X.ndim == 1
        if vec:
            X = X[:, None]
        Y = (X - self.Q @ (self.gain[:, None] * (self.Q.T @ X))) / self.eta**0.5
        return Y[:, 0] if vec else Y

    def dense(self) -> torch.Tensor:
        """The (m', m') symmetric inverse root (for tests)."""
        eye = torch.eye(self.Q.shape[0], dtype=self.Q.dtype, device=self.Q.device)
        return (eye - (self.Q * self.gain) @ self.Q.T) / self.eta**0.5

    def covariance(self) -> torch.Tensor:
        """Dense C ~= Q diag(lam) Q^T from the retained eigenpairs (the
        derivative-comparison data reads it); the neglected tail lies
        below the factorization's tolerance."""
        return (self.Q * self.lam) @ self.Q.T


class LowRankEstimates(NamedTuple):
    """One mode's GP estimation products with a factored weight root."""

    state_estimate: torch.Tensor  # (m',)
    ddt_estimate: torch.Tensor  # (m',)
    root: LowRankWeightRoot


def _kzz_rows(t_rows: torch.Tensor, t_est: torch.Tensor, sigma2, ell2) -> torch.Tensor:
    """Rows of K_zz = d1 d2 kappa at times ``t_rows`` (..., b) against
    ``t_est`` (m',): (..., b, m'). ``sigma2`` and ``ell2`` broadcast
    against the result."""
    dz = t_rows[..., :, None] - t_est
    dz2 = dz * dz
    return (sigma2 / ell2) * (1.0 - dz2 / ell2) * torch.exp(-dz2 / (2.0 * ell2))


def _pivoted_cholesky_C(t_est, K_zy, V, diag_C, sigma2, ell, tol: float, max_rank: int):
    """Pivoted Cholesky of every mode's C at once, rows on demand.

    ``K_zy`` (r, m', m), ``V = K_yy^{-1} K_yz`` (r, m, m'), ``diag_C``
    (r, m'), ``sigma2`` and ``ell`` (r,). Row j of a mode's C is the
    closed-form K_zz row minus one (m,) x (m, m') product. The pivot is
    the largest residual diagonal; a mode stops where that falls to
    ``tol`` or at ``max_rank`` columns, and then adds zero columns while
    the others go on.

    Returns (cols (r, m', P) with zero columns past each mode's rank,
    ranks (r,) list of int, resid (r,) largest remaining diagonal).
    """
    r, mp = diag_C.shape
    cap = min(max_rank, mp)
    ar = torch.arange(r, device=diag_C.device)
    ell2 = (ell * ell)[:, None]
    s2 = sigma2[:, None]
    d = diag_C.clone()
    cols = diag_C.new_zeros((r, mp, min(cap, 64)))
    ranks = torch.zeros(r, dtype=torch.long, device=d.device)
    zero = d.new_zeros(())
    p = 0
    while p < cap:
        dj, j = torch.max(d, dim=1)
        active = dj > tol  # a finished mode has d <= tol everywhere
        if not bool(active.any()):
            break
        if p == cols.shape[2]:  # grow the panel
            grown = cols.new_zeros((r, mp, min(cap, 2 * p)))
            grown[:, :, :p] = cols
            cols = grown
        row = _kzz_rows(t_est[j][:, None], t_est, s2[:, None], ell2[:, None])[:, 0]
        row = row - torch.bmm(K_zy[ar, j][:, None, :], V)[:, 0]
        if p:
            row = row - torch.bmm(cols[:, :, :p], cols[ar, j, :p][:, :, None])[:, :, 0]
        ljj = torch.sqrt(dj)
        col = row / ljj[:, None]
        col[ar, j] = ljj
        col = torch.where(active[:, None], col, zero)
        cols[:, :, p] = col
        d_new = torch.clamp(d - col * col, min=0.0)
        d_new[ar, j] = 0.0
        d = torch.where(active[:, None], d_new, d)
        ranks += active
        p += 1
    return cols[:, :, :p], ranks.tolist(), torch.amax(d, dim=1).tolist()


def _C_matmat(t_est, K_zy, V, sigma2, ell, Q, block: int = 2048) -> torch.Tensor:
    """One mode's C @ Q from closed-form kernel entries, a row block of
    K_zz at a time: O(m' block) memory, the (m', m') matrix never whole."""
    ell2 = ell * ell
    VQ = V @ Q  # (m, p)
    out = torch.empty_like(Q)
    for s in range(0, t_est.shape[0], block):
        e = min(s + block, t_est.shape[0])
        out[s:e] = _kzz_rows(t_est[s:e], t_est, sigma2, ell2) @ Q - K_zy[s:e] @ VQ
    return out


def _dense_root(t_est, K_zy, V, sigma2, ell, eta: float) -> LowRankWeightRoot:
    """The exact root by a dense eigh, in Woodbury form with p = m': for a
    mode whose C is not numerically low rank at the tolerance."""
    cross = K_zy @ V
    C = _kzz_rows(t_est, t_est, sigma2, ell * ell) - 0.5 * (cross + cross.T)
    lam, Q = torch.linalg.eigh(C)
    lam = torch.clamp(lam.flip(0), min=0.0)
    Q = Q.flip(1)
    return LowRankWeightRoot(Q, 1.0 - torch.sqrt(eta / (eta + lam)), lam, eta, 0.0)


def _woodbury_root(U, resid, t_est, K_zy, V, sigma2, ell, eta, refine) -> LowRankWeightRoot:
    """The Woodbury root from one mode's Cholesky factor ``U`` (m', p)."""
    Q, s, _ = torch.linalg.svd(U, full_matrices=False)
    lam = s * s
    keep = lam > 0.0
    Q, lam = Q[:, keep], lam[keep]
    if refine and Q.shape[1]:
        # Rayleigh-Ritz on span(Q) with C @ Q assembled anew: the pivoted
        # Cholesky's subtractive updates carry a larger backward error
        # than an eigensolver's; this restores the retained eigenpairs.
        M = Q.T @ _C_matmat(t_est, K_zy, V, sigma2, ell, Q)
        lam, S = torch.linalg.eigh(0.5 * (M + M.T))
        lam, S = lam.flip(0), S.flip(1)
        keep = lam > 0.0
        lam, S = lam[keep], S[:, keep]
        Q = Q @ S
    return LowRankWeightRoot(Q, 1.0 - torch.sqrt(eta / (eta + lam)), lam, eta, resid)


def batched_lowrank_gp_estimates(
    T: torch.Tensor,
    Y: torch.Tensor,
    t_est: torch.Tensor,
    sigma2: torch.Tensor,
    ell: torch.Tensor,
    chi: torch.Tensor,
    eta: float = 1e-8,
    tol_factor: Optional[float] = None,
    max_rank: Optional[int] = None,
    refine: bool = True,
) -> List[LowRankEstimates]:
    """GP estimates with rank-adaptive factored weight roots for every
    mode: ``T`` and ``Y`` (r, m), ``t_est`` (m',), hyperparameters (r,).

    The estimation math is ``gp.estimates.batched_gp_estimates``'s at
    O(m' p^2) in place of O(m'^3). ``tol_factor`` is the pivoted
    Cholesky's tolerance as a fraction of ``eta`` (None: ``DEFAULT_TOL_
    FACTOR``); ``max_rank`` caps the retained rank (default min(m', 4 +
    m' // 2)), and a mode that reaches the cap above the tolerance takes
    the dense eigh root; ``refine`` runs the Rayleigh-Ritz pass. Raises
    ValueError where a training Gram matrix is not positive definite.
    """
    f64 = torch.float64
    T, Y, t_est = T.to(f64), Y.to(f64), t_est.to(f64)
    sigma2, ell, chi = (torch.as_tensor(x, dtype=f64, device=Y.device) for x in (sigma2, ell, chi))
    r, m = Y.shape
    mp = t_est.shape[0]
    ell2 = (ell * ell)[:, None, None]
    s2 = sigma2[:, None, None]

    dyy = T[:, :, None] - T[:, None, :]
    eye = torch.eye(m, dtype=f64, device=Y.device)
    K_yy = s2 * torch.exp(-(dyy * dyy) / (2.0 * ell2)) + chi[:, None, None] * eye
    dzy = t_est[None, :, None] - T[:, None, :]
    kappa_zy = s2 * torch.exp(-(dzy * dzy) / (2.0 * ell2))
    K_zy = -dzy * kappa_zy / ell2

    L, info = torch.linalg.cholesky_ex(K_yy)
    if bool((info != 0).any()):
        bad = torch.nonzero(info).flatten().tolist()
        raise ValueError(f"training Gram matrix not positive definite for modes {bad}")
    alpha = torch.cholesky_solve(Y[..., None], L)
    state = (kappa_zy @ alpha)[..., 0]
    ddt = (K_zy @ alpha)[..., 0]

    V = torch.cholesky_solve(K_zy.transpose(-1, -2), L)  # (r, m, m')
    diag_C = (sigma2 / (ell * ell))[:, None] - torch.einsum("rim,rmi->ri", K_zy, V)
    diag_C = torch.clamp(diag_C, min=0.0)

    if max_rank is None:
        max_rank = min(mp, 4 + mp // 2)
    tol = (DEFAULT_TOL_FACTOR if tol_factor is None else tol_factor) * eta
    cols, ranks, resids = _pivoted_cholesky_C(t_est, K_zy, V, diag_C, sigma2, ell, tol, max_rank)

    out = []
    for i in range(r):
        mode = (t_est, K_zy[i], V[i], sigma2[i], ell[i], eta)
        if ranks[i] >= max_rank and resids[i] > tol:
            root = _dense_root(*mode)
        else:
            root = _woodbury_root(cols[i, :, : ranks[i]], resids[i], *mode, refine)
        out.append(LowRankEstimates(state[i], ddt[i], root))
    return out


def lowrank_gp_estimates(
    t: torch.Tensor, y: torch.Tensor, t_est: torch.Tensor, sigma2, ell, chi,
    eta: float = 1e-8, tol_factor: Optional[float] = None,
    max_rank: Optional[int] = None, refine: bool = True,
) -> LowRankEstimates:
    """One mode's estimates: ``t`` and ``y`` (m,), scalar hyperparameters
    (see ``batched_lowrank_gp_estimates``)."""
    hyper = [torch.as_tensor(x, dtype=torch.float64, device=y.device).reshape(1)
             for x in (sigma2, ell, chi)]
    return batched_lowrank_gp_estimates(
        t[None], y[None], t_est, *hyper, eta=eta, tol_factor=tol_factor,
        max_rank=max_rank, refine=refine,
    )[0]
