"""Plain reference of the Euler experiment (the paper's 1-D compressible
Euler ROM): the truth solve and noisy snapshots, the scaled POD, and the
shared stages of ``experiment``.

Truth model: conservative (rho, rho v, rho e) on a periodic grid, ideal
gas (gamma 1.4), first-order upwind differences, classical RK4 with the
substeps an output interval raised to meet CFL 0.4 at the initial
condition; the learning variables are (v, p, 1/rho). Initial condition:
periodic cubic splines through three density and three velocity knots,
pressure 1e5. Noise: Gaussian in the conservative variables, scaled by
the noise level times each variable's range over the samples; the first
column stays clean.
"""

import numpy as np
import scipy.interpolate

from . import common, experiment

GAMMA = 1.4
CFL = 0.4


def initial_state(x, knots) -> np.ndarray:
    """(3 nx,) lifted (v, p, 1/rho) initial condition."""
    L = x[-1] - x[0]
    nodes = np.array([0.0, L / 3.0, 2.0 * L / 3.0, L]) + x[0]
    knots = np.asarray(knots, dtype=np.float64)
    rho = scipy.interpolate.CubicSpline(nodes, np.append(knots[:3], knots[0]),
                                        bc_type="periodic")(x)
    v = scipy.interpolate.CubicSpline(nodes, np.append(knots[3:], knots[3]),
                                      bc_type="periodic")(x)
    return np.concatenate([v, 1e5 * np.ones_like(v), 1.0 / rho])


def lift(c):
    rho, rho_v, rho_e = np.split(c, 3)
    v = rho_v / rho
    p = (GAMMA - 1.0) * (rho_e - 0.5 * rho * v * v)
    return np.concatenate([v, p, 1.0 / rho])


def unlift(w):
    v, p, zeta = np.split(w, 3)
    rho = 1.0 / zeta
    return np.concatenate([rho, rho * v, p / (GAMMA - 1.0) + 0.5 * rho * v * v])


def truth(x, w0, t, min_substeps: int, dtype) -> np.ndarray:
    """Lifted states (3 nx, k) at times ``t`` from the lifted ``w0``."""
    dx = float(x[1] - x[0])
    v, p, zeta = np.split(w0, 3)
    speed = float(np.max(np.abs(v) + np.sqrt(GAMMA * np.abs(p) / (1.0 / zeta))))
    substeps = max(min_substeps, int(np.ceil(np.max(np.diff(t)) / (CFL * dx / speed))))

    def rhs(q):
        rho, rho_v, rho_e = np.split(q, 3)
        vel = rho_v / rho
        pr = (GAMMA - 1.0) * (rho_e - 0.5 * rho_v * vel)

        def ddx(f):
            return (f - np.roll(f, 1)) / dx

        return -np.concatenate([ddx(rho_v), ddx(rho_v * vel + pr), ddx((rho_e + pr) * vel)])

    q = unlift(w0).astype(dtype)
    out = [q]
    for i in range(len(t) - 1):
        h = (t[i + 1] - t[i]) / substeps
        for _ in range(substeps):
            k1 = rhs(q)
            k2 = rhs(q + 0.5 * h * k1)
            k3 = rhs(q + 0.5 * h * k2)
            k4 = rhs(q + h * k3)
            q = np.clip(q + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), -common.CLAMP,
                        common.CLAMP).astype(dtype)
        out.append(q)
    return lift(np.stack(out, axis=1))


def add_noise(states, level, normals, dtype):
    cons = unlift(states[:, 1:])
    blocks = np.split(cons, 3)
    scale = np.concatenate([np.full_like(b, level * float(b.max() - b.min())) for b in blocks])
    noised = lift((cons + scale * normals.astype(dtype)).astype(dtype))
    return np.concatenate([states[:, :1], noised], axis=1)


def scale_vec(cfg, n):
    v_ref, rho_ref = cfg["v_ref"], cfg["rho_ref"]
    return np.repeat([v_ref, rho_ref * v_ref**2, 1.0 / rho_ref], n // 3)


def compute(cfg, args, seed, device, follow, precision, cache, upstream=None):
    """The reference's outputs of one experiment (see ``judge``).
    ``cache`` keeps the truth on the prediction grid between experiments:
    every experiment starts from the same initial condition. With
    ``upstream`` (the float64 outputs), each stage takes its inputs from
    it (``experiment.rom_stages``)."""
    dtype = precision["float"]
    streams = common.stage_streams(seed, common.STREAMS, device)
    x, t_pred = cfg["spatial_domain"], cfg["t_pred"]
    w0 = initial_state(x, cfg["init_params"]).astype(dtype)
    key = ("truth", np.dtype(dtype).name)
    if key not in cache:
        cache[key] = truth(x, w0, t_pred, cfg["fom_substeps"], dtype)
    true_states = cache[key]
    span, m = args["training_span"], args["num_samples"]
    t_sampled = common.sample_times(streams["sample"], m, span, device)
    clean = truth(x, w0, t_sampled, cfg["fom_substeps"], dtype)
    noise = common.normals(streams["noise"], (len(w0), m - 1), device).numpy()
    clean_in = clean if upstream is None else upstream["clean"].astype(dtype)
    snapshots = add_noise(clean_in, args["noiselevel"], noise, dtype)

    r = args["num_pod_modes"]
    scale = scale_vec(cfg, len(w0)).astype(dtype)
    pod_in = snapshots if upstream is None else upstream["snapshots"][0].astype(dtype)
    entries, mean = common.pod(pod_in / scale[:, None], r, dtype)
    compressed = entries.T @ (pod_in / scale[:, None] - mean[:, None])
    signs = common.align_columns(compressed, follow["compressed"][0]).astype(dtype)
    entries, compressed = entries * signs, compressed * signs[:, None]

    t_est = np.linspace(span[0], span[1], args["num_regression_points"])
    out = experiment.rom_stages(
        t_sampled=t_sampled, compressed=compressed[None], t_est=t_est,
        cfg=dict(cfg, ndraws=args["ndraws"]), follow=follow, streams=streams, device=device,
        precision=precision,
        ensemble_ic=lambda state, comp: comp[:, :, 0],
        ensemble_env=lambda state, comp: experiment.envelope(comp), upstream=upstream,
    )
    out.update(t_sampled=t_sampled, truth=true_states[None], clean=clean,
               snapshots=snapshots[None], compressed=compressed[None],
               decompress=lambda draws: (entries @ draws + mean[:, None]) * scale[:, None])
    return out
