"""Plain building blocks of the benchmark's reference.

Written from the formulas of GP-BayesOpInf (arXiv:2408.03455) in NumPy,
SciPy and plain PyTorch operations, in any floating dtype, so that the
same code gives the float64 reference and the lower-precision control.
Nothing here imports the measured package; its outputs reach this code
only to be judged.

The GP formulas are adapted from ``tests/reference_impl.py`` (commit
2d005ae, ``kernel_matrices``, ``estimates_and_weights``, ``gp_nlml``):
the dtype is a parameter, and a failed factorization gives NaN instead
of raising, so that a control in lower precision reads as failed.
"""

import math

import numpy as np
import scipy.linalg as la
import scipy.optimize
import torch

#: The random streams of one experiment, in the order its seed spawns them.
STREAMS = ("sample", "noise", "fit", "search", "draws")
#: The multi-trajectory experiment's streams: one more, for the test parameters.
MULTI_STREAMS = STREAMS + ("newparam",)
#: A state at or beyond this magnitude has diverged (the ensembles' rule).
DIVERGED = 1e16
CLAMP = 1e18
SDIRK_GAMMA = 1.0 - 0.5 * 2.0**0.5


def stage_streams(seed: int, names, device) -> dict:
    """One ``torch.Generator`` on ``device`` per stream name, seeded from
    ``np.random.SeedSequence(seed).spawn(len(names))``: the rule by which
    an experiment's seed defines its sample times, noise and draws."""
    out = {}
    for name, child in zip(names, np.random.SeedSequence(seed).spawn(len(names))):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0]))
        out[name] = gen
    return out


def sample_times(gen, m: int, span, device) -> np.ndarray:
    """m sorted sample times in ``span`` with both ends included."""
    lo, hi = span
    u = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
    t = np.sort((lo + (hi - lo) * u).cpu().numpy())
    t[0], t[-1] = span
    return t


def normals(gen, shape, device) -> torch.Tensor:
    """float64 standard normals of ``shape`` from ``gen``, on the host."""
    return torch.randn(shape, generator=gen, dtype=torch.float64, device=device).cpu()


def grid(spec) -> np.ndarray:
    """An array from a configuration entry: a list, or {"linspace": [a,
    b, n]} / {"logspace": [a, b, n]}, optionally with "drop_last"."""
    if not isinstance(spec, dict):
        return np.asarray(spec, dtype=np.float64)
    kind = "linspace" if "linspace" in spec else "logspace"
    a, b, n = spec[kind]
    out = getattr(np, kind)(a, b, int(n))
    return out[:-1] if spec.get("drop_last") else out


# -- POD ---------------------------------------------------------------------------
def pod(states: np.ndarray, r: int, dtype):
    """(entries (n, r), mean (n,)) of the mean-shifted thin SVD."""
    X = states.astype(dtype)
    mean = X.mean(axis=1)
    U = la.svd(X - mean[:, None], full_matrices=False, lapack_driver="gesvd")[0]
    return U[:, :r], mean


def align_columns(ref: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Signs (r,) that turn the rows of ``ref`` (r, ...) toward the rows of
    ``target``: singular vectors are defined up to sign."""
    dots = np.sum(ref.reshape(ref.shape[0], -1) * target.reshape(target.shape[0], -1), axis=1)
    return np.where(dots < 0, -1.0, 1.0)


# -- GP estimation -------------------------------------------------------------------
def kernel_matrices(t, t_est, sigma2, ell, chi):
    """K_yy, kappa_zy, K_zy, K_zz for the RBF + white kernel."""
    ell2 = ell * ell

    def kappa(a, b):
        d = a[:, None] - b[None, :]
        return sigma2 * np.exp(-(d * d) / (2 * ell2))

    K_yy = kappa(t, t) + chi * np.eye(t.size, dtype=t.dtype)
    kappa_zy = kappa(t_est, t)
    K_zy = -(t_est[:, None] - t[None, :]) * kappa_zy / ell2
    dzz = t_est[:, None] - t_est[None, :]
    K_zz = (1 - dzz * dzz / ell2) * kappa(t_est, t_est) / ell2
    return K_yy, kappa_zy, K_zy, K_zz


def gp_estimates(t, y, t_est, sigma2, ell, chi, dtype):
    """(state estimate, ddt estimate, ddt covariance C) of one GP at fitted
    hyperparameters, in ``dtype``; NaN where the Cholesky factorization
    fails."""
    c = lambda x: np.asarray(x, dtype=dtype)
    t, y, t_est = c(t), c(y), c(t_est)
    sigma2, ell, chi = (dtype(v) for v in (sigma2, ell, chi))
    K_yy, kappa_zy, K_zy, K_zz = kernel_matrices(t, t_est, sigma2, ell, chi)
    try:
        cho = la.cho_factor(K_yy)
    except la.LinAlgError:
        nan = np.full(t_est.size, np.nan, dtype)
        return nan, nan, np.full((t_est.size, t_est.size), np.nan, dtype)
    alpha = la.cho_solve(cho, y)
    cross = K_zy @ la.cho_solve(cho, K_zy.T)
    return kappa_zy @ alpha, K_zy @ alpha, K_zz - 0.5 * (cross + cross.T)


def weight_root(C, eta, dtype):
    """(C + eta I)^{-1/2} by a symmetric eigendecomposition, in ``dtype``;
    NaN where an eigenvalue is not positive."""
    C = np.asarray(C, dtype)
    w, V = la.eigh(C + dtype(eta) * np.eye(C.shape[0], dtype=dtype))
    w = np.where(w > 0, w, np.nan)
    return (V / np.sqrt(w)) @ V.T


#: Where a factored root's spectrum ends, as a share of eta: the method's
#: pivoted Cholesky stops once the residual diagonal is this small.
LOWRANK_TOL = 1e-8


def lowrank_root(C, eta, dtype) -> dict:
    """The factored root (I - Q diag(gain) Q^T) / sqrt(eta) of (C + eta
    I)^{-1/2}, in ``dtype``: the eigenpairs of C above ``LOWRANK_TOL``
    eta, {"Q", "gain", "lam"}."""
    C = np.asarray(C, dtype)
    lam, Q = la.eigh(C, subset_by_value=(dtype(LOWRANK_TOL * eta), np.inf))
    return {"Q": Q, "gain": 1.0 - np.sqrt(dtype(eta) / (dtype(eta) + lam)), "lam": lam}


def apply_lowrank(Q, lam, eta, X, dtype):
    """(C + eta I)^{-1/2} X for C = Q diag(lam) Q^T with orthonormal ``Q``:
    (X - Q diag(1 - sqrt(eta / (eta + lam))) Q^T X) / sqrt(eta), in
    ``dtype``; the gain is worked out here from ``lam``."""
    Q, lam, X = (np.asarray(a, dtype) for a in (Q, lam, X))
    eta = dtype(eta)
    gain = 1.0 - np.sqrt(eta / (eta + lam))
    X2 = X.reshape(X.shape[0], -1)
    return ((X2 - Q @ (gain[:, None] * (Q.T @ X2))) / np.sqrt(eta)).reshape(X.shape)


def gp_nlml(t, y, sigma2, ell, chi, dtype) -> float:
    """Exact negative log marginal likelihood, in ``dtype``; NaN where the
    Cholesky factorization fails."""
    t, y = np.asarray(t, dtype), np.asarray(y, dtype)
    K_yy = kernel_matrices(t, t, *(dtype(v) for v in (sigma2, ell, chi)))[0]
    try:
        cho = la.cho_factor(K_yy)
    except la.LinAlgError:
        return math.nan
    alpha = la.cho_solve(cho, y)
    logdet = 2 * np.sum(np.log(np.diag(cho[0])))
    return float(0.5 * y @ alpha + 0.5 * logdet + 0.5 * t.size * np.log(2 * np.pi))


def nlml_and_grad(t, y, logp, dtype):
    """(NLML, its gradient in (log sigma2, log ell, log chi)) of the RBF +
    white kernel, in ``dtype``; (inf, 0) where the Cholesky factorization
    fails."""
    t, y = np.asarray(t, dtype), np.asarray(y, dtype)
    s2, ell, chi = (dtype(v) for v in np.exp(logp))
    d2 = (t[:, None] - t[None, :]) ** 2
    E = np.exp(-d2 / (2 * ell * ell))
    eye = np.eye(t.size, dtype=dtype)
    try:
        cho = la.cho_factor(s2 * E + chi * eye)
    except la.LinAlgError:
        return math.inf, np.zeros(3)
    alpha = la.cho_solve(cho, y)
    W = la.cho_solve(cho, eye) - np.outer(alpha, alpha)
    value = 0.5 * y @ alpha + np.sum(np.log(np.diag(cho[0]))) + 0.5 * t.size * np.log(2 * np.pi)
    dK = (s2 * E, s2 * E * d2 / (ell * ell), chi * eye)
    grad = np.array([0.5 * np.sum(W * k) for k in dK], dtype=np.float64)
    return float(value), grad


def fit_starts(gen, rows: int, restarts: int, bounds, device) -> np.ndarray:
    """(rows, restarts + 1, 3) log hyperparameters at which the method's
    multi-start fit begins, drawn from the experiment's "fit" stream: the
    kernel's default (log 0), then log-uniform points in the inner 96% of
    each bound."""
    lo, hi = np.log(np.asarray(bounds, np.float64)).T
    u = torch.rand((rows, restarts, 3), generator=gen, dtype=torch.float64, device=device)
    points = lo + (hi - lo) * (0.02 + 0.96 * u.cpu().numpy())
    default = np.broadcast_to(np.clip(0.0, lo, hi), (rows, 1, 3))
    return np.concatenate([default, points], axis=1)


def descend(t, y, bounds, logp, dtype):
    """(NLML, log hyperparameters) where L-BFGS-B ends from ``logp``
    inside ``bounds`` ((lo, hi) of sigma2, ell, chi), in ``dtype``."""
    lo, hi = np.log(np.asarray(bounds, np.float64)).T
    res = scipy.optimize.minimize(lambda x: nlml_and_grad(t, y, x, dtype), np.clip(logp, lo, hi),
                                  jac=True, method="L-BFGS-B", bounds=list(zip(lo, hi)),
                                  options={"maxiter": 500, "ftol": 1e-15, "gtol": 1e-10})
    return (float(res.fun) if np.isfinite(res.fun) else math.inf), res.x


# -- regression ------------------------------------------------------------------------
def ckron_pairs(r: int):
    """The unique quadratic monomials q_a q_b, a >= b, in the order
    (0,0), (1,0), (1,1), (2,0), ..."""
    return np.tril_indices(r)


def features(q, u, structure: str):
    """(..., d) operator features of (..., r) states and (..., m) inputs
    (None without inputs), column blocks in ``structure`` order (c, A, H,
    B, N; N input-major, entry a r + b being u_a q_b). Takes NumPy arrays
    or tensors."""
    tensor = isinstance(q, torch.Tensor)
    rows, cols = _pairs_tensors(q.shape[-1]) if tensor else ckron_pairs(q.shape[-1])
    parts = []
    for ch in structure:
        if ch == "c":
            parts.append(torch.ones_like(q[..., :1]) if tensor else np.ones_like(q[..., :1]))
        elif ch == "A":
            parts.append(q)
        elif ch == "H":
            parts.append(q[..., rows] * q[..., cols])
        elif ch == "B":
            parts.append(u.expand(q.shape[:-1] + u.shape[-1:]) if tensor
                         else np.broadcast_to(u, q.shape[:-1] + u.shape[-1:]))
        elif ch == "N":
            prod = u[..., :, None] * q[..., None, :]
            parts.append(prod.reshape(prod.shape[:-2] + (u.shape[-1] * q.shape[-1],)))
    return torch.cat(parts, -1) if tensor else np.concatenate(parts, -1)


_PAIRS = {}


def _pairs_tensors(r: int):
    if r not in _PAIRS:
        _PAIRS[r] = tuple(torch.as_tensor(i) for i in ckron_pairs(r))
    return _PAIRS[r]


class Regression:
    """The weighted, regularized regression of each operator row i:
    min ||Dt_i o - z_i||^2 + lambda^2 ||o||^2 with Dt_i = sqrtW_i D, through
    one SVD per row. ``signs_from`` (r, d, d), a factor whose columns are
    the right singular vectors up to scaling, fixes the singular vectors'
    signs, so that a draw mean + V (xi / sqrt(S^2 + lambda^2)) matches one
    made with the same standard normals ``xi``."""

    def __init__(self, Dt, zt, dtype, signs_from=None):
        self.U, self.S, self.V, self.Utz = [], [], [], []
        for i, (A, z) in enumerate(zip(Dt, zt)):
            U, S, Vh = la.svd(np.asarray(A, dtype), full_matrices=False, lapack_driver="gesvd")
            V = Vh.T
            if signs_from is not None:  # a pair of singular vectors changes sign together
                flip = np.where(np.sum(V * signs_from[i], axis=0) < 0, -1.0, 1.0).astype(dtype)
                U, V = U * flip, V * flip
            self.U.append(U)
            self.S.append(S)
            self.V.append(V)
            self.Utz.append(U.T @ np.asarray(z, dtype))
        self.S, self.V, self.Utz = np.stack(self.S), np.stack(self.V), np.stack(self.Utz)

    def mean(self, lam) -> np.ndarray:
        """(r, d) posterior means."""
        filt = self.S / (self.S * self.S + lam * lam)
        return np.einsum("rij,rj->ri", self.V, filt * self.Utz)

    def factor(self, lam) -> np.ndarray:
        """(r, d, d) covariance factors V diag(1 / sqrt(S^2 + lambda^2))."""
        return self.V / np.sqrt(self.S * self.S + lam * lam)[:, None, :]

    def covariance(self, lam) -> np.ndarray:
        F = self.factor(lam)
        return np.einsum("rik,rjk->rij", F, F)

    def draws(self, lam, xi) -> np.ndarray:
        """(..., n, r, d) operator draws mean + F xi for normals (..., n, r, d)."""
        return self.mean(lam) + np.einsum("rij,...nrj->...nri", self.factor(lam), xi)


# -- ROM integration (plain PyTorch, any float dtype) ------------------------------------
def _rom_rhs(O, q, u, structure):
    return (O * features(q, u, structure)[:, None, :]).sum(-1)


def rk4_rom(O, q0, t, substeps: int, structure: str = "cAH"):
    """Classical RK4 of dq/dt = O features(q): operators (N, r, d), initial
    states (N, r), output times (k,) as a NumPy array; returns (N, r, k)
    in the operators' dtype."""
    q = q0
    out = [q]
    for i in range(len(t) - 1):
        h = float((t[i + 1] - t[i]) / substeps)
        for _ in range(substeps):
            k1 = _rom_rhs(O, q, None, structure)
            k2 = _rom_rhs(O, q + 0.5 * h * k1, None, structure)
            k3 = _rom_rhs(O, q + 0.5 * h * k2, None, structure)
            k4 = _rom_rhs(O, q + h * k3, None, structure)
            q = torch.clamp(q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), -CLAMP, CLAMP)
        out.append(q)
    return torch.stack(out, dim=-1)


def stage_times(t, substeps: int) -> np.ndarray:
    """(k - 1, substeps, 3) times of each SDIRK2 substep: its start, its
    first stage abscissa t + gamma h and its end."""
    t = np.asarray(t, np.float64)
    h = (t[1:] - t[:-1])[:, None] / substeps
    starts = t[:-1, None] + h * np.arange(substeps)
    return np.stack([starts, starts + SDIRK_GAMMA * h, starts + h], axis=-1)


def _solve(A, b):
    """Solve (N, n, n) A x = (N, n) b: by LU in float32 and float64, else by
    Gaussian elimination without pivoting (the Newton matrices I - h gamma
    J are near the identity), a column at a time over the whole batch."""
    if A.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve(A, b)
    A, b = A.clone(), b.clone()
    n = b.shape[-1]
    for k in range(n - 1):
        f = A[:, k + 1:, k] / A[:, k, k, None]
        A[:, k + 1:, k:] -= f[:, :, None] * A[:, k, None, k:]
        b[:, k + 1:] -= f * b[:, k, None]
    x = torch.empty_like(b)
    for i in reversed(range(n)):
        x[:, i] = (b[:, i] - (A[:, i, i + 1:] * x[:, i + 1:]).sum(-1)) / A[:, i, i]
    return x


def sdirk2_rom(O, q0, t, substeps: int, u_table, newton_iters: int = 6):
    """2-stage L-stable SDIRK with up to ``newton_iters`` full Newton steps
    a stage, for dq/dt = O features(q, u) with O in "cAHBN" order:
    operators (N, r, d), initial states (N, r), inputs ``u_table`` (N, k -
    1, substeps, 3, m) at ``stage_times``; returns (N, r, k). A stage's
    Newton iteration stops once its step is below a few units of roundoff
    of the stage value on every row: the same stage values as six fixed
    steps, to roundoff."""
    N, r, d = O.shape
    m = u_table.shape[-1]
    rows, cols = _pairs_tensors(r)
    P = len(rows)
    c, A = O[:, :, 0], O[:, :, 1:1 + r]
    H = O[:, :, 1 + r:1 + r + P]
    Bop = O[:, :, 1 + r + P:1 + r + P + m]
    Nop = O[:, :, 1 + r + P + m:].unflatten(-1, (m, r))  # (N, r, m, r)
    T = torch.zeros((P, r, r), dtype=O.dtype)
    for z, (a, b) in enumerate(zip(rows.tolist(), cols.tolist())):
        T[z, a, b] += 1.0
        T[z, b, a] += 1.0
    HT = torch.einsum("niz,zjc->nijc", H, T).reshape(N, r * r, r)
    eye = torch.eye(r, dtype=O.dtype)
    tol = 16 * torch.finfo(O.dtype).eps

    def rhs(c_u, A_u, x):
        quad = x[:, rows] * x[:, cols]
        return c_u + torch.bmm(A_u, x[:, :, None])[:, :, 0] + torch.bmm(H, quad[:, :, None])[:, :, 0]

    def affine(u):  # c + B u and A + sum_a u_a N_a at the inputs u (N, m)
        return (c + torch.bmm(Bop, u[:, :, None])[:, :, 0],
                A + torch.einsum("niaj,na->nij", Nop, u))

    def stage(u, q_base, hg, kk):
        c_u, A_u = affine(u)
        for _ in range(newton_iters):
            x = q_base + hg * kk
            J = A_u + torch.bmm(HT, x[:, :, None]).reshape(N, r, r)
            dk = _solve(eye - hg * J, kk - rhs(c_u, A_u, x))
            kk = kk - dk
            if float(dk.abs().max()) <= tol * max(1.0, float(kk.abs().max())):
                break
        return kk

    q = q0
    out = [q]
    g = SDIRK_GAMMA
    for i in range(len(t) - 1):
        h = float((t[i + 1] - t[i]) / substeps)
        for s in range(substeps):
            u = u_table[:, i, s]
            k1 = stage(u[:, 1], q, h * g, rhs(*affine(u[:, 0]), q))
            k2 = stage(u[:, 2], q + h * (1.0 - g) * k1, h * g, k1)
            q = torch.clamp(q + h * ((1.0 - g) * k1 + g * k2), -CLAMP, CLAMP)
        out.append(q)
    return torch.stack(out, dim=-1)


def margins(traj, shift, limits) -> np.ndarray:
    """(N,) the largest |q - shift| / limit over modes and times of each
    (N, r, k) trajectory, inf where it is not finite or has diverged; a
    trajectory is inside the envelope where this is at most 1. Without an
    envelope (``limits`` None) 0 or inf: finite or not."""
    traj = traj.double()
    bad = ~(torch.isfinite(traj) & (traj.abs() < DIVERGED)).flatten(1).all(dim=1)
    if limits is None:
        ratio = torch.zeros(traj.shape[0], dtype=torch.float64)
    else:
        dev = torch.amax(torch.abs(traj - shift[..., None]), dim=-1)
        ratio = torch.amax(dev / limits, dim=-1)
    return torch.where(bad | ~torch.isfinite(ratio), torch.inf, ratio).numpy()
