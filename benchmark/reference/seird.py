"""Plain reference of the SEIRD parameter-estimation experiment (the
paper's ODE experiment, upstream ``ODEs/step1-4``): the truth solves,
each variable's noisy samples at integer days of its own, GP estimates at
each variable's own sample times, the five-block weighted regression of
the four rates, a sample of the regularization search's objective and of
both posterior ensembles.

Truth model, in the four rates p = (beta / N, delta, (1 - alpha) gamma,
alpha rho) of the six of the configuration:

    S' = -p1 S I,  E' = p1 S I - p2 E,  I' = p2 E - (p3 + p4) I,
    R' = p3 I,     D' = p4 I,

classical RK4 with ``substeps`` steps an output interval. The
experiment's seed spawns five streams (``STREAMS``): a NumPy generator of
the first draws, for each variable in turn, that variable's sample times
(integers below the span's end without replacement, sorted, the span's
ends set) and then uniforms for the truncated-normal noise of the whole
state at those times, of which the variable's row is kept; torch
generators of the others draw the GP fit's starts, the search's normals,
and the normals of the ensemble from the fitted initial state and of the
one from the unseen initial state. Noise: a normal of standard deviation
the noise level times the state, truncated to [0, 1] and drawn by CDF
inversion; exact zeros stay zero.

Departures from upstream ``ODEs/step1-4``, all the port's own: the
streams above in place of one NumPy seed; the GP hyperparameters of the
measured run are followed (a multi-start fit, checked by ``fit_gaps``);
the regression is one SVD of the stacked weighted blocks with Tikhonov
regularizer lambda^2, not scikit-learn's solver; the search screens 20
draws a candidate on the prediction and the estimation grids against a
5x envelope of the state estimates (upstream: its own stability test),
and the reference integrates the model's own equations there, where the
program integrates "cAH" operator rows; the ensemble from the unseen
initial state has no envelope, only finiteness.

``compute`` returns what ``judge`` compares. The snapshots the GPs are fit
to stand where a POD's compressed snapshots would (``compressed``); the
ensemble from the unseen initial state stands in the ``newparam`` slots
of a test-parameter ensemble, with its truth as ``newparam_truth``.
"""

import numpy as np
import scipy.special
import torch

from . import common, experiment

#: The experiment's streams, in the order its seed spawns them.
STREAMS = ("sample", "fit", "search", "draws", "newic")
VARIABLES = 5


def rates(params6) -> np.ndarray:
    """(p1, p2, p3, p4) of (N, beta, delta, gamma, alpha, rho)."""
    N, beta, delta, gamma, alpha, rho = (float(v) for v in params6)
    return np.array([beta / N, delta, (1.0 - alpha) * gamma, alpha * rho])


def rhs(p, q, stack):
    """The right-hand side at states ``q`` (..., 5) for rates ``p`` (...,
    4); ``stack`` joins the five parts on a new last axis."""
    S, E, I = q[..., 0], q[..., 1], q[..., 2]
    infect = p[..., 0] * S * I
    return stack([-infect, infect - p[..., 1] * E, p[..., 1] * E - (p[..., 2] + p[..., 3]) * I,
                  p[..., 2] * I, p[..., 3] * I])


def rk4(f, q, t, substeps: int, clip) -> list:
    """The states at times ``t`` from ``q`` by classical RK4 of ``f``,
    ``clip`` applied after each step; NumPy arrays or tensors alike."""
    out = [q]
    for i in range(len(t) - 1):
        h = float((t[i + 1] - t[i]) / substeps)
        for _ in range(substeps):
            k1 = f(q)
            k2 = f(q + 0.5 * h * k1)
            k3 = f(q + 0.5 * h * k2)
            k4 = f(q + h * k3)
            q = clip(q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))
        out.append(q)
    return out


def truth(p, q0, t, substeps: int, dtype) -> np.ndarray:
    """(5, k) states at times ``t`` from ``q0``, in ``dtype``."""
    p = np.asarray(p, dtype)
    f = lambda q: rhs(p, q, lambda parts: np.stack(parts, axis=-1))
    clip = lambda q: np.clip(q, -common.CLAMP, common.CLAMP)
    return np.stack(rk4(f, np.asarray(q0, dtype), t, substeps, clip), axis=1)


def truncnorm_noise(states, level: float, u, dtype) -> np.ndarray:
    """States with noise of standard deviation ``level`` times the state,
    truncated to [0, 1], from uniforms ``u`` by CDF inversion."""
    x = np.asarray(states, dtype)
    iszero = np.abs(x) < 5e-16
    std = np.where(iszero, dtype(1e-3), np.abs(dtype(level) * x)).astype(dtype)
    a = np.minimum(0.0, -x / std)
    b = np.maximum(0.0, (1.0 - x) / std)
    cdf_a = scipy.special.ndtr(a)
    z = scipy.special.ndtri(cdf_a + np.asarray(u, dtype) * (scipy.special.ndtr(b) - cdf_a))
    return np.where(iszero, 0.0, x + std * z).astype(dtype)


def samples(rng, p, q0, span, m: int, level: float, substeps: int, dtype, clean_in=None):
    """(times (5, m), clean (5, m), noisy (5, m)): each variable's sample
    times and its row of the truth and of the noisy state at them. With
    ``clean_in`` the noise is added to its rows in place of this side's."""
    times, clean, noisy = [], [], []
    for i in range(VARIABLES):
        t = np.sort(rng.choice(int(span[1]), size=m, replace=False)).astype(np.float64)
        t[0], t[-1] = span
        states = truth(p, q0, t, substeps, dtype)
        u = rng.uniform(size=states.shape)
        row = states[i] if clean_in is None else np.asarray(clean_in[i], dtype)
        times.append(t)
        clean.append(states[i])
        noisy.append(truncnorm_noise(row, level, u[i], dtype))
    return np.stack(times), np.stack(clean), np.stack(noisy)


def estimates(t_sampled, y, t_est, theta, dtype):
    """(state (1, 5, m'), ddt (1, 5, m'), C (1, 5, m', m'), nlml (1, 5)):
    each GP at its own sample times."""
    state, ddt, cov, nlml = [], [], [], []
    for i in range(VARIABLES):
        s2, ell, chi = theta[0, i]
        s, d, C = common.gp_estimates(t_sampled[i], y[i], t_est, s2, ell, chi, dtype)
        state.append(s)
        ddt.append(d)
        cov.append(C)
        nlml.append(common.gp_nlml(t_sampled[i], y[i], s2, ell, chi, dtype))
    return (np.stack(state)[None], np.stack(ddt)[None], np.stack(cov)[None],
            np.asarray(nlml)[None])


def fit_gaps(t_sampled, y, bounds, theta, starts) -> np.ndarray:
    """(1, 5) ``experiment.fit_gaps`` of each GP at its own times."""
    return np.concatenate([
        experiment.fit_gaps(t_sampled[i], y[None, None, i], bounds, theta[:, i:i + 1],
                            starts[:, i:i + 1]) for i in range(VARIABLES)], axis=1)


def control_fit(t_sampled, y, bounds, starts, dtype) -> np.ndarray:
    """(1, 5, 3) ``experiment.control_fit`` of each GP at its own times."""
    return np.concatenate([
        experiment.control_fit(t_sampled[i], y[None, None, i], bounds, starts[:, i:i + 1], dtype)
        for i in range(VARIABLES)], axis=1)


def blocks(state):
    """The five (m', 4) blocks of the regression, one for each equation, in
    the rates' columns, from the (5, m') state estimates."""
    S, E, I = state[0], state[1], state[2]
    SI, Z = S * I, np.zeros_like(S)
    return [np.stack(cols, axis=1) for cols in (
        (-SI, Z, Z, Z), (SI, -E, Z, Z), (Z, E, -I, -I), (Z, Z, I, Z), (Z, Z, Z, I))]


def regression(state, ddt, roots, dtype, signs_from):
    """The one row problem of the four rates: the blocks and the
    derivative estimates, each weighted by its variable's root, stacked."""
    D = blocks(state[0])
    Dt = np.concatenate([roots[0][k](D[k]) for k in range(VARIABLES)])
    zt = np.concatenate([roots[0][k](ddt[0, k]) for k in range(VARIABLES)])
    return common.Regression([Dt], [zt], dtype, signs_from)


def integrate(P, q0, t, substeps: int, dtype) -> torch.Tensor:
    """(N, 5, k) float64 trajectories for rates ``P`` (N, 1, 4) from states
    ``q0`` (N, 5), integrated in torch ``dtype``."""
    p = torch.as_tensor(np.asarray(P)[:, 0]).to(dtype)
    f = lambda q: rhs(p, q, lambda parts: torch.stack(parts, dim=-1))
    clip = lambda q: torch.clamp(q, -common.CLAMP, common.CLAMP)
    q = torch.as_tensor(np.asarray(q0)).to(dtype)
    return torch.stack(rk4(f, q, t, substeps, clip), dim=-1).double()


def compute(cfg, args, seed, device, follow, precision, cache, upstream=None):
    """The reference's outputs of one experiment (see ``judge``).
    ``cache`` keeps the truths on the prediction grid between experiments:
    every experiment starts from the same initial states. With
    ``upstream`` (the float64 outputs), each stage takes its inputs from
    it, as ``experiment.rom_stages`` does."""
    dtype = precision["float"]
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    streams = common.stage_streams(seed, STREAMS, device)
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(len(STREAMS))[0])
    p = rates(cfg["true_parameters6"])
    substeps, t_pred = cfg["substeps"], cfg["t_pred"]
    q0 = np.asarray(cfg["initial_conditions"], np.float64)
    q0_new = np.asarray(cfg["test_initial_conditions"], np.float64)
    key = ("truth", np.dtype(dtype).name)
    if key not in cache:
        cache[key] = (truth(p, q0, t_pred, substeps, dtype),
                      truth(p, q0_new, t_pred, substeps, dtype))
    true_states, truth_new = cache[key]

    span, m = args["training_span"], args["num_samples"]
    t_sampled, clean, snapshots = samples(
        rng, p, q0, span, m, args["noiselevel"], substeps, dtype,
        None if upstream is None else upstream["clean"])
    fit_in = snapshots if upstream is None else upstream["snapshots"][0].astype(dtype)

    t_est = np.linspace(span[0], span[1], args["num_regression_points"])
    lam, eta = follow["lam"], cfg["gp_regularizer"]
    state, ddt, cov, nlml = estimates(t_sampled, fit_in, t_est, follow["theta"], dtype)
    src = upstream or {"state_est": state, "ddt_est": ddt}
    reg = regression(src["state_est"].astype(dtype), src["ddt_est"].astype(dtype),
                     experiment.weight_appliers(follow, eta, dtype), dtype, follow["factor"])
    b = cfg["gp_bounds"]
    starts = common.fit_starts(streams["fit"], VARIABLES, b["n_restarts"],
                               [b[k] for k in ("constant", "length_scale", "noise_level")],
                               device).reshape(1, VARIABLES, -1, 3)
    fitted = follow["theta"] if upstream is None else control_fit(t_sampled, fit_in, b, starts,
                                                                  dtype)
    out = dict(clean=clean, truth=true_states[None],
               newparam_truth=truth_new, snapshots=snapshots[None], compressed=snapshots[None],
               nlml=nlml, fit_gap=fit_gaps(t_sampled, fit_in, b, fitted, starts),
               state_est=state, ddt_est=ddt, covariance=cov, eta=eta, reg=reg,
               post_mean=reg.mean(lam), post_cov=reg.covariance(lam),
               reg_grid=np.asarray(cfg["reg_grid"]),
               roots=np.stack([[common.weight_root(C, eta, dtype) for C in row]
                               for row in follow["covariance"]]))

    # The search's normals: one set a grid candidate, then the refinement's.
    state = src["state_est"]
    draws_from = reg if upstream is None else upstream["reg"]
    G, d = len(cfg["reg_grid"]), reg.S.shape[1]
    xi_grid = common.normals(streams["search"], (G, experiment.SCREEN_DRAWS, 1, d), device).numpy()
    xi_refine = common.normals(streams["search"], (experiment.SCREEN_DRAWS, 1, d), device).numpy()
    cands = list(follow["candidates"])
    lams = [cfg["reg_grid"][c] for c in cands]
    xis = [xi_grid[c] for c in cands]
    if follow["refined"]:
        lams += [lam, cfg["reg_grid"][follow["best"]]]
        xis += [xi_refine, xi_refine]

    # Both ensembles' sampled draws: all normals drawn, the sampled ones
    # integrated; the first from the fitted model's initial state inside the
    # envelope, the second from the unseen one.
    J = np.asarray(follow["draws"])
    ndraws = args["ndraws"]
    mean, factor = follow["mean"], follow["factor"]
    draw = lambda x: mean + np.einsum("rij,...nrj->...nri", factor, x)
    xi = common.normals(streams["draws"], (ndraws, 1, d), device).numpy()
    xi_new = common.normals(streams["newic"], (ndraws, 1, d), device).numpy()
    n = len(J)
    rows = (np.concatenate([draw(xi[J]), draw(xi_new[J])]),
            np.concatenate([np.tile(q0, (n, 1)), np.tile(q0_new, (n, 1))]),
            np.zeros(2 * n, dtype=int))

    step = lambda P, q, t, which, dt: integrate(P, q, t, substeps, dt)
    together = precision["screen"] == tdtype
    err, marg, traj = experiment.screen(draws_from, lams, np.stack(xis), state[:, :, 0], t_pred,
                                        t_est, state, step, precision["screen"],
                                        rows if together else None)
    out["grid_err"] = dict(zip(cands, err[:len(cands)]))
    out["grid_margin"] = dict(zip(cands, marg[:len(cands)]))
    out["refine_margin"] = float(marg[len(cands)]) if follow["refined"] else None
    out["refine_err"] = tuple(err[len(cands):len(cands) + 2]) if follow["refined"] else None
    if not together:
        traj = integrate(rows[0], rows[1], t_pred, substeps, tdtype)
    shift, limits = experiment.envelope(state)
    out["draws"] = traj[:n].numpy()[None]
    out["draw_margin"] = common.margins(traj[:n], torch.as_tensor(shift[[0] * n]),
                                        torch.as_tensor(limits[[0] * n]))[None]
    out["newparam_draws"] = traj[n:].numpy()
    out["newparam_margin"] = common.margins(traj[n:], None, None)
    return out
