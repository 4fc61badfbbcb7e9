"""Fixed-step initial-value solvers and instability masks
(counterpart of ``gp_bayesopinf_tpu/solve/ivp.py``, explicit path).

``rk4_solve`` is classical RK4 with a fixed number of substeps per output
interval. ``lax.scan`` becomes a Python loop, and ``vmap`` over posterior
draws becomes a leading batch axis of the state. A diverging trajectory
is clamped at +-1e18 and runs to the end; ``stability_mask`` then marks
it invalid, the mask form of the reference's early termination.
"""

from typing import Callable

import torch

# Any |q| >= DIVERGED counts as blown up; the integrator clamps at a larger
# sentinel so diverging members stay finite yet detectable.
DIVERGED = 1e16
CLAMP = 1e18


def rk4_solve(
    rhs: Callable,
    q0: torch.Tensor,
    t_eval: torch.Tensor,
    substeps: int = 8,
) -> torch.Tensor:
    """Integrate dq/dt = rhs(t, q) with classical RK4.

    Parameters
    ----------
    rhs : callable (t, q) -> dq/dt, with q shaped like ``q0``.
    q0 : (..., n) initial state at ``t_eval[0]``; leading axes are a batch
        (for example posterior draws).
    t_eval : (k,) output times, possibly non-uniform.
    substeps : RK4 steps per output interval.

    Returns
    -------
    (..., n, k) states at ``t_eval``; the first column is ``q0``.
    """
    ts = t_eval.tolist()
    hs = ((t_eval[1:] - t_eval[:-1]) / substeps).tolist()
    q = q0
    out = [q0]
    for i, h in enumerate(hs):
        for s in range(substeps):
            t = ts[i] + s * h
            k1 = rhs(t, q)
            k2 = rhs(t + 0.5 * h, q + 0.5 * h * k1)
            k3 = rhs(t + 0.5 * h, q + 0.5 * h * k2)
            k4 = rhs(t + h, q + h * k3)
            q = torch.clamp(
                q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), -CLAMP, CLAMP
            )
        out.append(q)
    return torch.stack(out, dim=-1)


def stability_mask(
    solution: torch.Tensor, shift: torch.Tensor, limits: torch.Tensor
) -> torch.Tensor:
    """True where a trajectory is stable: finite, below the divergence
    sentinel, and inside the envelope |q_i(t) - shift_i| <= limits_i.

    ``solution`` is (..., n, k); ``shift`` and ``limits`` are (n,).
    Returns a (...) bool tensor.
    """
    dev = torch.amax(torch.abs(solution - shift[..., None]), dim=-1)  # (..., n)
    inside = torch.all(dev <= limits, dim=-1)
    return finite_mask(solution) & inside


def finite_mask(solution: torch.Tensor) -> torch.Tensor:
    """True where a (..., n, k) trajectory neither went non-finite nor hit
    the divergence clamp."""
    ok = torch.isfinite(solution) & (torch.abs(solution) < DIVERGED)
    return ok.flatten(-2).all(dim=-1)
