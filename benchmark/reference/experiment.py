"""The stages of one experiment that the Euler and heat references share,
from the compressed snapshots on: GP estimation at the fitted
hyperparameters, the weighted regression, the regularization search's
objective at a sample of candidates, and a sample of the posterior
ensemble's draws. L trajectories throughout (L = 1 for Euler).

The reference follows the measured run's own state where the method
leaves a choice that cannot be redone: the GP hyperparameters (a
multi-start optimisation), the chosen regularizer (a search over random
draws) and the signs of singular vectors. Each followed choice is also
checked: each GP's NLML at the measured run's hyperparameters against
where L-BFGS-B descends to from them and against the least at the
method's own starts, drawn again from the "fit" stream, so that a fit
that stops short reads high (``fit_gaps``); and the refinement's
objective at the grid's best candidate, which the chosen regularizer has
to match or beat. ``follow`` carries them:

* ``theta`` (L, r, 3): sigma2, ell, chi of each GP;
* ``covariance``, ``roots`` (L, r, m', m'): each GP's derivative
  covariance C and its weight root (C + eta I)^{-1/2}. The root's small
  eigenvalues are of C's roundoff, which differs between two float64
  computations of C by more than eta: the reference works the root out
  again from the measured run's C (judged against its own C), and
  regresses with the measured run's roots (judged against that);
* ``lam``, ``refined``, ``best``: the chosen regularizer, whether the
  bounded refinement found it (else it is the grid's best), and the
  grid's best candidate by the measured run's grid errors;
* ``mean``, ``factor`` (r, d), (r, d, d): the posterior means and
  covariance factors at ``lam``; the factors fix the signs of the right
  singular vectors, and the ensemble's draws are mean + factor xi of the
  measured run's posterior, which the posterior's own number judges, so
  that the ensemble's number judges the integration alone;
* ``candidates``: indices of the grid candidates to screen;
* ``draws``: indices of the ensemble draws to integrate.
"""

import numpy as np
import torch

from . import common

MAXOPTVAL = 1e12  # the objective of a rejected candidate
SCREEN_DRAWS = 20  # posterior draws per candidate in the search


def estimates(t_sampled, compressed, t_est, theta, eta, covariance, dtype):
    """(state (L, r, m'), ddt (L, r, m'), ddt covariances C (L, r, m',
    m'), weight roots (L, r, m', m') of the measured run's covariances
    ``covariance``, nlml (L, r))."""
    L, r, _ = compressed.shape
    state, ddt, cov, roots, nlml = [], [], [], [], []
    for ell in range(L):
        for i in range(r):
            s2, ln, chi = theta[ell, i]
            y = compressed[ell, i]
            s, d, C = common.gp_estimates(t_sampled, y, t_est, s2, ln, chi, dtype)
            state.append(s)
            ddt.append(d)
            cov.append(C)
            roots.append(common.weight_root(covariance[ell, i], eta, dtype))
            nlml.append(common.gp_nlml(t_sampled, y, s2, ln, chi, dtype))
    shape = (L, r, len(t_est))
    square = shape + (len(t_est),)
    return (np.reshape(state, shape), np.reshape(ddt, shape), np.reshape(cov, square),
            np.reshape(roots, square), np.reshape(nlml, (L, r)))


def fit_gaps(t_sampled, compressed, bounds, theta, starts) -> np.ndarray:
    """(L, r) how far each GP's float64 NLML at hyperparameters ``theta``
    lies above the lesser of where L-BFGS-B descends to from them and
    the least at the method's ``starts`` (L, r, K, 3) log points, over
    max(1, |the descent's end|); 0 where it is not above."""
    L, r, _ = compressed.shape
    box = [bounds[k] for k in ("constant", "length_scale", "noise_level")]
    out = np.zeros((L, r))
    for ell in range(L):
        for i in range(r):
            t, y = t_sampled, compressed[ell, i]
            at = common.nlml_and_grad(t, y, np.log(theta[ell, i]), np.float64)[0]
            local = common.descend(t, y, box, np.log(theta[ell, i]), np.float64)[0]
            least = min(common.nlml_and_grad(t, y, p, np.float64)[0] for p in starts[ell, i])
            out[ell, i] = max(0.0, (at - min(local, least)) / max(1.0, abs(local)))
    return out


def control_fit(t_sampled, compressed, bounds, starts, dtype) -> np.ndarray:
    """(L, r, 3) hyperparameters of a fit in ``dtype``: L-BFGS-B from the
    best of the method's ``starts``."""
    L, r, _ = compressed.shape
    box = [bounds[k] for k in ("constant", "length_scale", "noise_level")]
    out = np.zeros((L, r, 3))
    for ell in range(L):
        for i in range(r):
            t, y = t_sampled, compressed[ell, i]
            values = [common.nlml_and_grad(t, y, p, dtype)[0] for p in starts[ell, i]]
            out[ell, i] = np.exp(common.descend(t, y, box, starts[ell, i][np.argmin(values)],
                                                dtype)[1])
    return out


def regression(state, ddt, roots, inputs_est, structure, dtype, signs_from):
    """The row problems stacked over trajectories: Dt_i = [sqrtW_(i, ell)
    D_ell]_ell and z_i likewise."""
    L, r, _ = state.shape
    D = [common.features(state[ell].T, None if inputs_est is None else inputs_est[ell].T,
                         structure) for ell in range(L)]
    Dt = [np.concatenate([roots[ell, i] @ D[ell] for ell in range(L)]) for i in range(r)]
    zt = [np.concatenate([roots[ell, i] @ ddt[ell, i] for ell in range(L)]) for i in range(r)]
    return common.Regression(Dt, zt, dtype, signs_from)


def envelope(series):
    """(shift, limits), each (L, r): the time mean and five times the
    largest deviation from it."""
    shift = series.mean(axis=2)
    return shift, 5.0 * np.max(np.abs(series - shift[..., None]), axis=2)


class Integrator:
    """Integrates batches of operator draws through the ROM: RK4 for an
    autonomous "cAH" ROM, SDIRK2 with inputs for "cAHBN"."""

    def __init__(self, structure, substeps, input_funcs=None):
        self.structure, self.substeps, self.input_funcs = structure, substeps, input_funcs

    def __call__(self, O, q0, t, which, dtype):
        """``O`` (N, r, d), ``q0`` (N, r) and ``which`` (N,) the trajectory
        (input history) of each row; returns (N, r, k) float64."""
        O = torch.as_tensor(O).to(dtype)
        q0 = torch.as_tensor(q0).to(dtype)
        if self.structure == "cAH":
            out = common.rk4_rom(O, q0, t, self.substeps)
        else:
            times = common.stage_times(t, self.substeps)
            tables = np.stack([f(times) for f in self.input_funcs])  # (L', ..., m)
            u = torch.as_tensor(tables[np.asarray(which)]).to(dtype)
            out = common.sdirk2_rom(O, q0, t, self.substeps, u)
        return out.double()


def screen(reg, lams, xis, q0, t_pred, t_est, state, integrate, dtype, extra=None):
    """The search objective at candidates ``lams`` with their normals
    ``xis`` (C, nd, r, d): (errors (C,), margins (C,), trajectories of
    ``extra``). A candidate whose draws leave the envelope, on either
    grid, in any trajectory, reads MAXOPTVAL; its margin is the largest
    ratio to the envelope. ``extra`` (operators, initial states, which),
    rows of the same dtype on the prediction grid, is integrated in the
    same batch."""
    C, nd = len(lams), xis.shape[1]
    L = state.shape[0]
    shift, limits = envelope(state)
    ops = np.concatenate([reg.draws(lam, xi) for lam, xi in zip(lams, xis)])  # (C nd, r, d)
    N = L * C * nd
    O = np.tile(ops, (L, 1, 1))
    which = np.repeat(np.arange(L), C * nd)
    q = q0[which]
    est = integrate(O, q, t_est, which, dtype)
    if extra is not None:
        O, q, which_all = (np.concatenate([a, b]) for a, b in zip((O, q, which), extra))
    else:
        which_all = which
    pred = integrate(O, q, t_pred, which_all, dtype)
    pred, extra_traj = pred[:N], pred[N:]
    sh, lim = torch.as_tensor(shift[which]), torch.as_tensor(limits[which])
    marg = np.maximum(common.margins(pred, sh, lim), common.margins(est, sh, lim))
    marg = marg.reshape(L, C, nd).max(axis=(0, 2))
    est = est.reshape(L, C, nd, *est.shape[1:]).mean(dim=2).numpy()  # (L, C, r, m')
    err = np.zeros(C)
    for ell in range(L):
        miss = np.sqrt(np.sum((est[ell] - state[ell][None]) ** 2, axis=(1, 2)))
        err += miss / np.sqrt(np.sum(state[ell] ** 2))
    err /= L
    return np.where((marg <= 1.0) & np.isfinite(err), err, MAXOPTVAL), marg, extra_traj


def rom_stages(*, t_sampled, compressed, t_est, cfg, follow, streams, device, precision,
               ensemble_ic, ensemble_env, inputs_est=None, input_funcs=None, newparam=None,
               upstream=None):
    """GP estimates, regression, the sampled search and the sampled
    ensemble of one experiment. ``ensemble_ic`` and ``ensemble_env`` map
    (state estimates, compressed snapshots) to the ensemble's initial
    states (L, r) and to its envelope ((L, r), (L, r)).
    ``newparam`` (initial state (r,), stream name) adds the ensemble at
    unseen inputs, the last of ``input_funcs``, without an envelope.

    With ``upstream``, the float64 reference's outputs of the same
    experiment, each stage takes its inputs from it and computes in
    ``precision`` (the control, stage by stage): the estimates from its
    compressed snapshots, the regression from its estimates and roots,
    the screen and the ensemble from its posterior's draws."""
    dtype = precision["float"]
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    L, r, _ = compressed.shape
    lam = follow["lam"]
    state, ddt, cov, roots, nlml = estimates(t_sampled, compressed, t_est, follow["theta"],
                                             cfg["gp_regularizer"], follow["covariance"], dtype)
    src = upstream or {"state_est": state, "ddt_est": ddt, "compressed": compressed}
    reg = regression(*(x.astype(dtype) for x in (src["state_est"], src["ddt_est"],
                                                 follow["roots"])),
                     inputs_est, cfg["structure"], dtype, follow["factor"])
    # How far the fitted hyperparameters lie above a minimum: the measured
    # run's, or, for the control in its place, the control's own fit's.
    b = cfg["gp_bounds"]
    starts = common.fit_starts(streams["fit"], L * r, b["n_restarts"],
                               [b[k] for k in ("constant", "length_scale", "noise_level")],
                               device).reshape(L, r, -1, 3)
    fit_in = compressed if upstream is None else upstream["compressed"]
    fitted = follow["theta"] if upstream is None else control_fit(t_sampled, fit_in, b, starts,
                                                                  dtype)
    out = dict(nlml=nlml, fit_gap=fit_gaps(t_sampled, fit_in, b, fitted, starts),
               state_est=state, ddt_est=ddt, covariance=cov,
               roots=roots, reg=reg, post_mean=reg.mean(lam), post_cov=reg.covariance(lam),
               reg_grid=np.asarray(cfg["reg_grid"]))
    # The screen integrates the float64 reference's draws where it is
    # given, in the screen's precision.
    state, compressed = src["state_est"], src["compressed"]
    draws_from = reg if upstream is None else upstream["reg"]
    d = reg.S.shape[1]
    integrate = Integrator(cfg["structure"], cfg["rom_substeps"], input_funcs)

    # The search's normals: one set per grid candidate, then one frozen set
    # for the refinement, drawn in this order from the "search" stream.
    G = len(cfg["reg_grid"])
    xi_grid = common.normals(streams["search"], (G, SCREEN_DRAWS, r, d), device).numpy()
    xi_refine = common.normals(streams["search"], (SCREEN_DRAWS, r, d), device).numpy()
    cands = list(follow["candidates"])
    lams = [cfg["reg_grid"][c] for c in cands]
    xis = [xi_grid[c] for c in cands]
    if follow["refined"]:  # the chosen point, and the grid's best on the same draws
        lams += [lam, cfg["reg_grid"][follow["best"]]]
        xis += [xi_refine, xi_refine]

    # The ensemble's draws at the chosen regularizer: the normals of all
    # ndraws are drawn, the sampled ones integrated.
    J = np.asarray(follow["draws"])
    ndraws = cfg["ndraws"]
    shape = ((L,) if L > 1 else ()) + (ndraws, r, d)
    xi = common.normals(streams["draws"], shape, device).numpy().reshape(L, ndraws, r, d)
    mean, factor = follow["mean"], follow["factor"]
    draw = lambda x: mean + np.einsum("rij,...nrj->...nri", factor, x)
    ops = draw(xi[:, J]).reshape(-1, r, d)  # (L nJ, r, d)
    which = np.repeat(np.arange(L), len(J))
    q0 = ensemble_ic(state, compressed)[which]
    if newparam is not None:
        xi_new = common.normals(streams[newparam[1]], (ndraws, r, d), device).numpy()
        ops = np.concatenate([ops, draw(xi_new[J])])
        q0 = np.concatenate([q0, np.tile(newparam[0], (len(J), 1))])
        which = np.concatenate([which, np.full(len(J), L)])
    rows = (ops, q0, which)

    together = precision["screen"] == tdtype
    err, marg, traj = screen(draws_from, lams, np.stack(xis), state[:, :, 0], cfg["t_pred"],
                             t_est, state, integrate, precision["screen"],
                             rows if together else None)
    out["grid_err"] = dict(zip(cands, err[:len(cands)]))
    out["grid_margin"] = dict(zip(cands, marg[:len(cands)]))
    out["refine_margin"] = float(marg[len(cands)]) if follow["refined"] else None
    out["refine_err"] = tuple(err[len(cands):len(cands) + 2]) if follow["refined"] else None
    if not together:
        traj = integrate(*rows[:2], cfg["t_pred"], rows[2], tdtype)
    shift, limits = ensemble_env(state, compressed)
    n = L * len(J)
    m = common.margins(traj[:n], torch.as_tensor(shift[which[:n]]),
                       torch.as_tensor(limits[which[:n]]))
    out["draws"] = traj[:n].numpy().reshape(L, len(J), r, -1)
    out["draw_margin"] = m.reshape(L, len(J))
    if newparam is not None:
        out["newparam_draws"] = traj[n:].numpy()
        out["newparam_margin"] = common.margins(traj[n:], None, None)
    return out
