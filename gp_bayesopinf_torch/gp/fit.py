"""Batched multi-restart GP hyperparameter fitting
(counterpart of ``gp_bayesopinf_tpu/gp/fit.py``).

Four phases, all on the caller's device in float64:

1. **Screen**: Adam on the box-transformed NLML over every (mode,
   restart) start at once, on an evenly strided subsample of the
   training points. The population is one batch: one batched Cholesky
   per step over (r * (n_restarts + 1), m_s, m_s) Gram matrices.
2. **Re-rank** every screened candidate by its full-data NLML and keep
   each mode's best.
3. **Polish**: damped Newton from each mode's winner on a second, larger
   subsample, with gradients and 3x3 Hessians from ``torch.func``.
4. **Final re-rank** of the (winner, polished) pair on the full data.

Each phase is a span (``utils.timing.span``): ``gp.screen`` (the starts
drawn and the Adam descent), ``gp.rerank``, ``gp.polish``, ``gp.final``.

Restart 0 starts from the kernel default (sigma2 = ell = chi = 1
projected into the box); the others are log-uniform inside the box.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .nlml import BoxTransform, nlml_in_box
from ..utils.timing import span

# optax.adam's defaults; the screen matches optax's update exactly.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class FitResult(NamedTuple):
    """Fitted hyperparameters for a batch of GPs, each (r,)."""

    sigma2: torch.Tensor
    ell: torch.Tensor
    chi: torch.Tensor
    nlml: torch.Tensor


def initial_z(
    box: BoxTransform, r: int, n_restarts: int, generator: torch.Generator
) -> torch.Tensor:
    """(r, n_restarts + 1, 3) starting points in unconstrained coordinates."""
    default = box.from_log_params(torch.zeros_like(box.lo))
    u = torch.rand(
        (r, n_restarts, 3), generator=generator, dtype=box.lo.dtype,
        device=box.lo.device,
    )
    zs = box.from_log_params(box.lo + (box.hi - box.lo) * (0.02 + 0.96 * u))
    return torch.cat([default.expand(r, 1, 3), zs], dim=1)


def _adam_screen(z0, T, Y, box, steps: int, lr: float):
    """Fixed-length Adam descent on a (..., 3) population.

    Returns the better of (start, end) per instance and its NLML. An
    instance whose value or gradient is not finite gets a zero gradient
    into the moments and a zero update, as the JAX screen does.
    """
    z = z0
    mu = torch.zeros_like(z0)
    nu = torch.zeros_like(z0)
    for count in range(1, steps + 1):
        zg = z.detach().requires_grad_(True)
        val = nlml_in_box(zg, box, T, Y)
        (grad,) = torch.autograd.grad(val.sum(), zg)
        val = val.detach()
        bad = ~(torch.isfinite(val) & torch.isfinite(grad).all(-1))[..., None]
        grad = torch.where(bad, torch.zeros_like(grad), grad)
        mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * nu
        mu_hat = mu / (1 - ADAM_B1**count)
        nu_hat = nu / (1 - ADAM_B2**count)
        update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * -lr
        z = z + torch.where(bad, torch.zeros_like(update), update)
    with torch.no_grad():
        val = nlml_in_box(z, box, T, Y)
        val0 = nlml_in_box(z0, box, T, Y)
    better = val < val0
    return torch.where(better[..., None], z, z0), torch.where(better, val, val0)


def _newton_polish(z0, T, Y, box, maxiter: int):
    """Damped modified-Newton polish of each mode's 3-parameter NLML.

    Per iteration: gradient and Hessian at the iterate, a modified-Newton
    step with an eigenvalue floor for indefinite Hessians, three damped
    candidates (1, 1/2, 1/8 of the step), and the best-seen iterate kept,
    so the NLML never increases. ``z0`` is (r, 3), ``T`` and ``Y`` (r, m).
    """

    def f(z, t, y):
        return nlml_in_box(z, box, t, y)

    grad_f = torch.func.vmap(torch.func.grad(f))
    hess_f = torch.func.vmap(torch.func.hessian(f))
    rows = torch.arange(z0.shape[0], device=z0.device)
    eye = torch.eye(3, dtype=z0.dtype, device=z0.device)
    T3, Y3 = T[:, None].expand(-1, 3, -1), Y[:, None].expand(-1, 3, -1)

    z = z0
    with torch.no_grad():
        best_v = f(z0, T, Y)
    for _ in range(maxiter):
        g = grad_f(z, T, Y)
        H = hess_f(z, T, Y)
        ok = torch.isfinite(g).all(-1) & torch.isfinite(H).all((-2, -1))
        g = torch.where(ok[:, None], g, torch.zeros_like(g))
        H = torch.where(ok[:, None, None], H, eye)
        w, V = torch.linalg.eigh(H)
        wa = w.abs()
        w_safe = torch.maximum(wa, 1e-6 * wa.amax(-1, keepdim=True) + 1e-12)
        dz = -torch.einsum("rij,rj->ri", V, torch.einsum("rji,rj->ri", V, g) / w_safe)
        cands = z[:, None] + torch.tensor([1.0, 0.5, 0.125], dtype=z.dtype,
                                          device=z.device)[None, :, None] * dz[:, None]
        with torch.no_grad():
            vals = f(cands, T3, Y3)
        i = torch.argmin(vals, dim=1)
        v_i = vals[rows, i]
        z = torch.where((v_i < best_v)[:, None], cands[rows, i], z)
        best_v = torch.minimum(v_i, best_v)
    return z, best_v


def _strided(m: int, points: Optional[int]):
    """Evenly strided subsample indices through m sorted points, endpoints
    kept; None when no subsampling applies."""
    if points is None or m <= points:
        return None
    return np.unique(np.linspace(0, m - 1, points).round().astype(int))


def fit_gp_hyperparameters(
    t: torch.Tensor,
    Y: torch.Tensor,
    box: BoxTransform,
    generator: Optional[torch.Generator] = None,
    n_restarts: int = 50,
    adam_steps: int = 60,
    adam_lr: float = 0.1,
    polish_iters: int = 10,
    screen_points: Optional[int] = 32,
    polish_points: Optional[int] = 128,
    z0: Optional[torch.Tensor] = None,
) -> FitResult:
    """Fit RBF + white GP hyperparameters for every row of ``Y`` at once.

    Parameters
    ----------
    t : (m,) shared or (r, m) per-row training times.
    Y : (r, m) training targets, one row per POD mode.
    box : log-space hyperparameter bounds.
    generator : stream for the random restarts (ignored when ``z0`` is
        given).
    z0 : optional (r, n_restarts + 1, 3) starting points, replacing the
        ones drawn from ``generator`` (the parity tests replay the JAX
        package's starts through it).
    screen_points, polish_points : strided-subsample sizes for the Adam
        screen and the Newton polish; None uses all points.

    Returns
    -------
    FitResult of (r,) tensors on ``Y``'s device.
    """
    r, m = Y.shape
    T = t.expand(r, m) if t.ndim == 1 else t
    if z0 is None and generator is None:
        raise ValueError("pass a generator or explicit starts z0")
    rows = torch.arange(r, device=Y.device)

    # Phase 1: Adam screen of the whole (mode, restart) population.
    with span("gp.screen"):
        if z0 is None:
            z0 = initial_z(box, r, n_restarts, generator)
        idx = _strided(m, screen_points)
        T_s, Y_s = (T, Y) if idx is None else (T[:, idx], Y[:, idx])
        n_start = z0.shape[1]
        z_scr, v_scr = _adam_screen(
            z0,
            T_s[:, None].expand(-1, n_start, -1),
            Y_s[:, None].expand(-1, n_start, -1),
            box, adam_steps, adam_lr,
        )

    # Phase 2: full-data re-rank of every screened candidate.
    with span("gp.rerank"), torch.no_grad():
        if idx is not None:
            v_scr = nlml_in_box(
                z_scr, box,
                T[:, None].expand(-1, n_start, -1),
                Y[:, None].expand(-1, n_start, -1),
            )
        z_best = z_scr[rows, torch.argmin(v_scr, dim=1)]

    # Phase 3: Newton polish of each mode's winner.
    with span("gp.polish"):
        pidx = _strided(m, polish_points)
        T_p, Y_p = (T, Y) if pidx is None else (T[:, pidx], Y[:, pidx])
        z_pol, _ = _newton_polish(z_best, T_p, Y_p, box, polish_iters)

    # Phase 4: full-data re-rank of the (winner, polished) pair.
    with span("gp.final"), torch.no_grad():
        pair = torch.stack([z_best, z_pol], dim=1)  # (r, 2, 3)
        v_pair = nlml_in_box(
            pair, box, T[:, None].expand(-1, 2, -1), Y[:, None].expand(-1, 2, -1)
        )
        z_fin = pair[rows, torch.argmin(v_pair, dim=1)]
        params = torch.exp(box.to_log_params(z_fin))
    return FitResult(params[:, 0], params[:, 1], params[:, 2], v_pair.amin(dim=1))
