"""GP estimation and weighting of every (window, mode) row problem
(counterpart of ``gp_bayesopinf_tpu/pipeline/scaled.py``,
``_gp_estimate_windows``, ``_gp_estimate_windows_local`` and
``_weight_windows``).

Everything here is float64 on the device of the tensors given: what the
JAX package computes in NumPy float64 on its host.
"""

from typing import Tuple

import torch

from ...gp.estimates import batched_gp_estimates
from ...gp.lowrank import batched_lowrank_gp_estimates

ETA = 1e-8  # the eta I added to the derivative covariance


def gp_estimate_windows(ts, Y, sigma2, ell, chi, tw, weight_method: str):
    """(W, r, mw) GP state and derivative estimates and the weights.

    The GP is global: the hyperparameters (r,) were fitted once on the
    full-span samples ``ts`` (m,), ``Y`` (r, m), and every window's
    estimates on its grid ``tw[w]`` condition on all of them. Returns
    ``(state_est, ddt_est, weight_ctx)`` with ``weight_ctx`` either
    ``("chol", (W, r, mw, mw))``, the lower Cholesky factors of C + eta I,
    or ``("lowrank", roots)``, ``roots[w][i]`` a ``LowRankWeightRoot``.
    """
    W = tw.shape[0]
    return gp_estimate_windows_local(
        ts.expand(W, -1), Y.expand(W, -1, -1), *(x.expand(W, -1) for x in (sigma2, ell, chi)),
        tw, weight_method,
    )


def gp_estimate_windows_local(ts_w, Yw, sigma2, ell, chi, tw, weight_method: str):
    """(W, r, mw) GP estimates for local window bases (counterpart of
    ``_gp_estimate_windows_local``): window w's modes condition only on
    window w's own samples ``ts_w[w]`` (W, m_w), ``Yw[w]`` (W, r, m_w) and
    hyperparameters (W, r). Same returns as ``gp_estimate_windows``."""
    if weight_method not in ("chol", "lowrank"):
        raise ValueError(f"weight_method must be 'chol' or 'lowrank', got '{weight_method}'")
    f64 = torch.float64
    Yw, tw = Yw.to(f64), tw.to(f64)
    hyper = [x.to(f64) for x in (sigma2, ell, chi)]
    states, ddts, ctx = [], [], []
    for w, t_w in enumerate(tw):
        T = ts_w[w].to(f64).expand(Yw[w].shape)
        hyp = [x[w] for x in hyper]
        if weight_method == "lowrank":
            ests = batched_lowrank_gp_estimates(T, Yw[w], t_w, *hyp, eta=ETA)
            states.append(torch.stack([e.state_estimate for e in ests]))
            ddts.append(torch.stack([e.ddt_estimate for e in ests]))
            ctx.append([e.root for e in ests])
        else:
            est = batched_gp_estimates(T, Yw[w], t_w, *hyp, ETA, method="chol")
            if not bool(est.ok.all()):
                bad = torch.nonzero(~est.ok).flatten().tolist()
                raise ValueError(
                    f"inverse covariance not positive definite for modes {bad}, increase eta"
                )
            states.append(est.state_estimate)
            ddts.append(est.ddt_estimate)
            ctx.append(est.weight_root)
    if weight_method == "chol":
        ctx = torch.stack(ctx)
    return torch.stack(states), torch.stack(ddts), (weight_method, ctx)


def weight_windows(rom, state_est, ddt_est, weight_ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted regression blocks of every (window, mode) row problem:
    ``(Dt (W, r, mw, d), zt (W, r, mw))`` = sqrtW_i D_w and sqrtW_i z_i,
    with no block-diagonal stack."""
    W = state_est.shape[0]
    D = torch.stack([rom.data_matrix(state_est[w]) for w in range(W)])  # (W, mw, d)
    mw, d = D.shape[1:]
    if mw < d:
        raise ValueError(
            f"underdetermined regression: num_regression_points/W={mw} < d={d} "
            "unknowns; raise num_regression_points or lower time_windows"
        )
    kind, ctx = weight_ctx
    if kind == "lowrank":
        # Factored symmetric roots, two thin products a row problem: no
        # (mw, mw) matrix.
        Dt = torch.stack([torch.stack([root.apply(D[w]) for root in ctx[w]]) for w in range(W)])
        zt = torch.stack([
            torch.stack([root.apply(ddt_est[w, i]) for i, root in enumerate(ctx[w])])
            for w in range(W)
        ])
        return Dt, zt
    # Cholesky factors of C + eta I, applied as L^{-1}: the weighted
    # regression of the symmetric root without an eigendecomposition.
    Dt = torch.linalg.solve_triangular(ctx, D[:, None], upper=False)
    zt = torch.linalg.solve_triangular(ctx, ddt_est[..., None], upper=False)[..., 0]
    return Dt, zt
