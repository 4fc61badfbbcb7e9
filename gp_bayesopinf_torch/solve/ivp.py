"""Fixed-step initial-value solvers and instability masks
(counterpart of ``gp_bayesopinf_tpu/solve/ivp.py``).

* ``rk4_solve``: classical RK4 with a fixed number of substeps per output
  interval.
* ``dirk2_solve``: the 2-stage L-stable SDIRK (gamma = 1 - sqrt(2)/2) with
  a fixed count of full Newton steps per stage, for the stiff ROM
  ensembles.
* ``dirk2_solve_np``: its NumPy twin with LAPACK ``dgtsv`` Newton solves,
  for the host truth solves of the tridiagonal heat model.
* ``rk4_solve_np``: the NumPy twin of ``rk4_solve`` for one trajectory,
  for the host truth solves of the SEIRD model.

``lax.scan`` becomes a Python loop, and ``vmap`` over posterior draws
becomes leading batch axes of the state. A diverging trajectory is
clamped at +-1e18 and runs to the end; ``stability_mask`` then marks it
invalid, the mask form of the reference's early termination.
"""

from typing import Callable

import numpy as np
import torch

# Any |q| >= DIVERGED counts as blown up; the integrator clamps at a larger
# sentinel so diverging members stay finite yet detectable.
DIVERGED = 1e16
CLAMP = 1e18
GAMMA = 1.0 - 0.5 * 2.0**0.5  # SDIRK2 (Alexander) stage coefficient


def rk4_stage_times(t_eval: torch.Tensor, substeps: int) -> torch.Tensor:
    """The (3 (k - 1) substeps,) times ``rk4_solve`` touches: for every
    step its start, its midpoint and its end, in the integrator's own
    arithmetic. An input function is tabulated on them once for a whole
    integration (``rk4_solve(..., stage_index=True)``)."""
    h = ((t_eval[1:] - t_eval[:-1]) / substeps)[:, None]
    s = torch.arange(substeps, dtype=t_eval.dtype, device=t_eval.device)
    t0 = t_eval[:-1, None] + s * h
    return torch.stack([t0, t0 + 0.5 * h, t0 + h], dim=-1).reshape(-1)


def rk4_solve(
    rhs: Callable,
    q0: torch.Tensor,
    t_eval: torch.Tensor,
    substeps: int = 8,
    stage_index: bool = False,
) -> torch.Tensor:
    """Integrate dq/dt = rhs(t, q) with classical RK4.

    Parameters
    ----------
    rhs : callable (t, q) -> dq/dt, with q shaped like ``q0``.
    q0 : (..., n) initial state at ``t_eval[0]``; leading axes are a batch
        (for example posterior draws).
    t_eval : (k,) output times, possibly non-uniform.
    substeps : RK4 steps per output interval.
    stage_index : call ``rhs(j, q)`` with the index j of the stage's time
        in ``rk4_stage_times(t_eval, substeps)`` in place of the time.

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
            if stage_index:
                j = 3 * (i * substeps + s)
                a, b, c = j, j + 1, j + 2
            else:
                t = ts[i] + s * h
                a, b, c = t, t + 0.5 * h, t + h
            k1 = rhs(a, q)
            k2 = rhs(b, q + 0.5 * h * k1)
            k3 = rhs(b, q + 0.5 * h * k2)
            k4 = rhs(c, q + h * k3)
            q = torch.clamp(
                q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), -CLAMP, CLAMP
            )
        out.append(q)
    return torch.stack(out, dim=-1)


def rk4_solve_np(rhs: Callable, q0, t_eval, substeps: int = 8) -> np.ndarray:
    """NumPy twin of ``rk4_solve`` for one trajectory on the host: the
    same stepping in the same operation order, float64. ``rhs(t, q)``
    takes and returns (n,) arrays. Returns (n, k) states at ``t_eval``."""
    q = np.asarray(q0, dtype=np.float64).copy()
    t = np.asarray(t_eval, dtype=np.float64)
    out = np.empty((t.size, q.size), dtype=np.float64)
    out[0] = q
    for i in range(t.size - 1):
        t0 = t[i]
        h = (t[i + 1] - t0) / substeps
        for s in range(substeps):
            ts = t0 + s * h
            k1 = rhs(ts, q)
            k2 = rhs(ts + 0.5 * h, q + 0.5 * h * k1)
            k3 = rhs(ts + 0.5 * h, q + 0.5 * h * k2)
            k4 = rhs(ts + h, q + h * k3)
            q = np.clip(q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), -CLAMP, CLAMP)
        out[i + 1] = q
    return out.T


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., n, n) A x = (..., n) b by unrolled Gaussian elimination
    without pivoting, in the reference's operation order.

    The intended inputs are SDIRK Newton matrices I - h gamma J, near the
    identity at the step sizes the integrators take, so no pivot
    degenerates; a NaN system gives a NaN solution.
    """
    n = b.shape[-1]
    rows = [A[..., i, :] for i in range(n)]
    rhs = [b[..., i] for i in range(n)]
    for k in range(n):
        inv = 1.0 / rows[k][..., k]
        for i in range(k + 1, n):
            f = rows[i][..., k] * inv
            rows[i] = rows[i] - f[..., None] * rows[k]
            rhs[i] = rhs[i] - f * rhs[k]
    x = [None] * n
    for i in reversed(range(n)):
        acc = rhs[i]
        for j in range(i + 1, n):
            acc = acc - rows[i][..., j] * x[j]
        x[i] = acc / rows[i][..., i]
    return torch.stack(x, dim=-1)


def dirk2_solve(
    rhs: Callable,
    q0: torch.Tensor,
    t_eval: torch.Tensor,
    jac: Callable,
    substeps: int = 2,
    newton_iters: int = 6,
) -> torch.Tensor:
    """Integrate a stiff system with 2-stage L-stable SDIRK and full Newton.

    Butcher tableau (gamma = 1 - sqrt(2)/2)::

        gamma | gamma      0
          1   | 1-gamma  gamma
        ------+----------------
              | 1-gamma  gamma

    Each stage solves k = rhs(q_base + h gamma k) with ``newton_iters``
    Newton steps, each on the Newton matrix I - h gamma J rebuilt at the
    iterate. The batched Newton systems go to one
    ``torch.linalg.solve_ex`` call (LU with partial pivoting, no error
    check, so no host synchronization): a few launches per step where the
    reference's unrolled elimination (``solve_small``) takes ~n^2. The
    two agree to roundoff on these near-identity matrices.

    Parameters
    ----------
    rhs, jac : callables (j, q) -> (..., n) and (..., n, n), the
        right-hand side and its state Jacobian at the j-th time of
        ``ops.cahbn_screen.input_stage_times(t_eval, substeps)``: for
        interval i and substep s, j = 3 (i substeps + s) + 0 is the
        substep start, + 1 the first stage abscissa t + gamma h and + 2
        the second, t + h. A time-independent system ignores j.
    q0 : (..., n) initial state; leading axes are a batch.
    t_eval : (k,) output times.

    Returns
    -------
    (..., n, k) states at ``t_eval``.
    """
    n = q0.shape[-1]
    eye = torch.eye(n, dtype=q0.dtype, device=q0.device)
    hs = ((t_eval[1:] - t_eval[:-1]) / substeps).tolist()

    def solve_stage(j, q_base, hg, k):
        for _ in range(newton_iters):
            x = q_base + hg * k
            F = k - rhs(j, x)
            dk, _ = torch.linalg.solve_ex(eye - hg * jac(j, x), F)
            k = k - dk
        return k

    q = q0
    out = [q0]
    for i, h in enumerate(hs):
        hg = h * GAMMA
        for s in range(substeps):
            j = 3 * (i * substeps + s)
            k1 = solve_stage(j + 1, q, hg, rhs(j, q))
            k2 = solve_stage(j + 2, q + h * (1.0 - GAMMA) * k1, hg, k1)
            q = torch.clamp(
                q + h * ((1.0 - GAMMA) * k1 + GAMMA * k2), -CLAMP, CLAMP
            )
        out.append(q)
    return torch.stack(out, dim=-1)


def dirk2_solve_np(
    rhs: Callable,
    q0,
    t_eval,
    jac_tridiag: Callable,
    substeps: int = 2,
    newton_iters: int = 6,
    newton_tol: float = 1e-9,
) -> np.ndarray:
    """NumPy twin of ``dirk2_solve`` for host truth solves whose Jacobian
    is tridiagonal (the heat model), Newton systems by LAPACK ``dgtsv``.

    ``rhs(t, q)`` and ``jac_tridiag(t, q) -> (dl, diag, du)`` (gtsv
    layout, dl[0] and du[-1] unused) take the time itself. ``newton_tol``
    > 0 stops a stage's Newton iteration once max|dk| <= newton_tol *
    max(1, max|k|), as the JAX package's host twin does; 0.0 runs every
    iteration. Returns (n, k) float64 states at ``t_eval``.
    """
    from scipy.linalg import lapack

    q = np.asarray(q0, np.float64).copy()
    t = np.asarray(t_eval, np.float64)
    out = np.empty((t.size, q.size))
    out[0] = q

    def newton_solve(t_s, x, h, F):
        dl, dg, du = jac_tridiag(t_s, x)
        hg = h * GAMMA
        # The scaled bands are fresh arrays and F is dead after the
        # solve, so dgtsv may overwrite all four.
        _, _, _, dk, info = lapack.dgtsv(
            -hg * dl[1:], 1.0 - hg * dg, -hg * du[:-1], F,
            overwrite_dl=1, overwrite_d=1, overwrite_du=1, overwrite_b=1,
        )
        if info != 0:
            raise np.linalg.LinAlgError(f"dgtsv failed (info={info})")
        return dk

    def solve_stage(t_s, q_base, h, k):
        for _ in range(newton_iters):
            x = q_base + h * GAMMA * k
            F = k - rhs(t_s, x)
            dk = newton_solve(t_s, x, h, F)
            k = k - dk
            if newton_tol and np.max(np.abs(dk)) <= newton_tol * max(
                1.0, np.max(np.abs(k))
            ):
                break
        return k

    for i in range(t.size - 1):
        t0 = t[i]
        h = (t[i + 1] - t0) / substeps
        for s in range(substeps):
            ts = t0 + s * h
            k1 = solve_stage(ts + GAMMA * h, q, h, rhs(ts, q))
            base2 = q + h * (1.0 - GAMMA) * k1
            k2 = solve_stage(ts + h, base2, h, k1)
            q = np.clip(q + h * ((1.0 - GAMMA) * k1 + GAMMA * k2), -CLAMP, CLAMP)
        out[i + 1] = q
    return out.T


def stability_mask(
    solution: torch.Tensor, shift: torch.Tensor, limits: torch.Tensor
) -> torch.Tensor:
    """True where a trajectory is stable: finite, below the divergence
    sentinel, and inside the envelope |q_i(t) - shift_i| <= limits_i.

    ``solution`` is (..., n, k); ``shift`` and ``limits`` are (n,) or
    carry leading axes that broadcast against ``solution``'s batch.
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
