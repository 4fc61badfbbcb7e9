"""Plain reference of the heat experiment (the paper's cubic heat equation
with bimodal forcing, several training trajectories): the truth solves
and noisy snapshots, the POD of the lifted state, and the shared stages
of ``experiment``, with the ensemble at the test parameters.

Truth model: q_t = kappa q_xx - q^3 + a sin(2 pi t) / (1 + 100 (x -
1/4)^2) + b sin(4 pi t) / (1 + 100 (x - 3/4)^2), Dirichlet boundary
values, second-order differences on the interior, SDIRK2 (gamma = 1 -
sqrt(2)/2) with up to six Newton steps a stage on the tridiagonal
Jacobian, stopped once the step is below 1e-9 of the stage value. Noise:
relative Gaussian on the interior, the first column clean. POD: of the
lifted state (q, q^2) over all training trajectories at once.
"""

import math

import numpy as np
import scipy.linalg as la

from . import common, experiment

NEWTON_ITERS, NEWTON_TOL = 6, 1e-9


def initial_state(x, left, right) -> np.ndarray:
    L = x[-1] - x[0]
    h1 = 6.0 * np.exp(-x) * x * (L - x) ** 3
    h2 = 10.0 * np.exp(x) * x * (L - x) * np.sin(x / (L * 6.0))
    return h1 - h2 + left + (right - left) / L * (x - x[0])


def inputs(t, a, b) -> np.ndarray:
    """(..., 2) forcing inputs at times ``t`` (...)."""
    t = np.asarray(t, np.float64)
    return np.stack([a * np.sin(2.0 * math.pi * t), b * np.sin(4.0 * math.pi * t)], axis=-1)


def truth(cfg, params, t, dtype) -> np.ndarray:
    """(P, n, k) states on the full grid at times ``t``, one trajectory per
    forcing amplitude pair (a, b) of ``params``, solved as one stacked
    system whose Newton iteration stops on all of them at once."""
    x = cfg["spatial_domain"]
    left, right = cfg["left_bc"], cfg["right_bc"]
    xi = x[1:-1]
    n, P = xi.size, len(params)
    c2 = cfg["diffusion"] / float(x[1] - x[0]) ** 2
    const = np.zeros(n)
    const[0], const[-1] = left * c2, right * c2
    B = np.column_stack([1.0 / (1.0 + 100.0 * (xi - 0.25) ** 2),
                         1.0 / (1.0 + 100.0 * (xi - 0.75) ** 2)]).astype(dtype)
    const = const.astype(dtype)
    amps = np.asarray(params, np.float64)

    def rhs(s, q):  # q (P, n)
        lap = -2.0 * q
        lap[:, :-1] += q[:, 1:]
        lap[:, 1:] += q[:, :-1]
        u = inputs(s, amps[:, 0], amps[:, 1]).astype(dtype)  # (P, 2)
        return const + c2 * lap + u @ B.T - q**3

    def newton(s, base, hg, k):
        off = np.full((P, n), -hg * c2, dtype)
        upper, lower = off.copy(), off.copy()
        upper[:, 0] = 0.0  # no coupling between the stacked trajectories
        lower[:, -1] = 0.0
        for _ in range(NEWTON_ITERS):
            x_ = base + hg * k
            ab = np.stack([upper.ravel(), (1.0 - hg * (-2.0 * c2 - 3.0 * x_ * x_)).ravel(),
                           lower.ravel()]).astype(dtype)
            dk = la.solve_banded((1, 1), ab, (k - rhs(s, x_)).ravel()).reshape(P, n)
            k = (k - dk).astype(dtype)
            if np.max(np.abs(dk)) <= NEWTON_TOL * max(1.0, np.max(np.abs(k))):
                break
        return k

    g = common.SDIRK_GAMMA
    q = np.tile(initial_state(x, left, right)[1:-1], (P, 1)).astype(dtype)
    out = [q]
    substeps = cfg["fom_substeps"]
    for i in range(len(t) - 1):
        h = (t[i + 1] - t[i]) / substeps
        for s in range(substeps):
            ts = t[i] + s * h
            k1 = newton(ts + g * h, q, h * g, rhs(ts, q))
            k2 = newton(ts + h, q + h * (1.0 - g) * k1, h * g, k1)
            q = np.clip(q + h * ((1.0 - g) * k1 + g * k2), -common.CLAMP,
                        common.CLAMP).astype(dtype)
        out.append(q)
    body = np.stack(out, axis=2)
    k = len(t)
    return np.concatenate([np.full((P, 1, k), left, dtype), body,
                           np.full((P, 1, k), right, dtype)], axis=1)


def lifted(states):
    return np.concatenate([states, states * states])


def compute(cfg, args, seed, device, follow, precision, cache, upstream=None):
    """The reference's outputs of one experiment (see ``judge``).
    ``cache`` keeps the truth on the prediction grid between experiments.
    With ``upstream`` (the float64 outputs), each stage takes its inputs
    from it (``experiment.rom_stages``)."""
    dtype = precision["float"]
    streams = common.stage_streams(seed, common.MULTI_STREAMS, device)
    t_pred = cfg["t_pred"]
    params = [tuple(p) for p in cfg["input_parameters"]]
    test = tuple(cfg["test_parameters"])
    key = ("truth", np.dtype(dtype).name)
    if key not in cache:
        cache[key] = truth(cfg, params + [test], t_pred, dtype)
    true_states, truth_new = cache[key][:-1], cache[key][-1]
    span, m = args["training_span"], args["num_samples"]
    t_sampled = common.sample_times(streams["sample"], m, span, device)
    level = args["noiselevel"]
    cleans = truth(cfg, params, t_sampled, dtype)
    snapshots = []
    for ell, clean in enumerate(cleans):
        normals = common.normals(streams["noise"], (clean.shape[0] - 2, m - 1), device).numpy()
        if upstream is not None:
            clean = upstream["clean"][ell].astype(dtype)
        interior = clean[1:-1, 1:]
        noisy = clean.copy()
        noisy[1:-1, 1:] = interior + (level * interior) * normals.astype(dtype)
        snapshots.append(noisy)
    snapshots = np.stack(snapshots)

    r = args["num_pod_modes"]
    pod_in = snapshots if upstream is None else upstream["snapshots"].astype(dtype)
    entries, mean = common.pod(lifted(np.concatenate(list(pod_in), axis=1)), r, dtype)
    compress = lambda s: entries.T @ (lifted(s) - mean[:, None])
    compressed = np.stack([compress(s) for s in pod_in])
    signs = common.align_columns(np.swapaxes(compressed, 0, 1),
                                 np.swapaxes(follow["compressed"], 0, 1)).astype(dtype)
    entries = entries * signs
    compressed = compressed * signs[:, None]

    t_est = np.linspace(span[0], span[1], args["num_regression_points"])
    funcs = [lambda s, p=p: inputs(s, *p) for p in params + [test]]
    q0_new = compress(truth_new)[:, 0] if upstream is None else upstream["q0_new"]
    out = experiment.rom_stages(
        t_sampled=t_sampled, compressed=compressed, t_est=t_est,
        cfg=dict(cfg, ndraws=args["ndraws"]), follow=follow, streams=streams, device=device,
        precision=precision,
        ensemble_ic=lambda state, comp: state[:, :, 0],
        ensemble_env=lambda state, comp: experiment.envelope(state),
        inputs_est=np.stack([f(t_est).T for f in funcs[:-1]]), input_funcs=funcs,
        newparam=(q0_new, "newparam") if args.get("generalization_test", True) else None,
        upstream=upstream,
    )
    out.update(t_sampled=t_sampled, truth=true_states, clean=cleans,
               snapshots=snapshots, compressed=compressed, newparam_truth=truth_new,
               q0_new=q0_new)
    return out
