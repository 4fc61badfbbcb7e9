"""The paper's named workloads (counterpart of
``gp_bayesopinf_tpu/pipeline/experiments.py``).

Each entry is the argument tuple of its pipeline's runner; the paper runs
all of them with 600 draws.
"""

from typing import Dict, Tuple

from ..utils.device import DeviceLike

# (t_max, num_samples, noiselevel, num_regression_points, num_pod_modes)
EULER_WORKLOADS: Dict[str, Tuple] = {
    # Sweeps of noise, regression points and modes.
    "ex1a": (0.06, 200, 0.03, 400, 6),
    "ex1b": (0.06, 200, 0.03, 50, 6),
    "ex1c": (0.06, 200, 0.03, 3200, 6),
    "ex1d": (0.06, 200, 0.01, 400, 6),
    "ex1e": (0.06, 200, 0.05, 400, 6),
    "ex1r8": (0.06, 200, 0.03, 400, 8),
    # Sparse data.
    "ex2a": (0.06, 50, 0.01, 400, 6),
    "ex2b": (0.06, 50, 0.01, 50, 6),
    "ex2c": (0.06, 50, 0.01, 3200, 6),
    "ex2d": (0.06, 20, 0.01, 400, 6),
    "ex2e": (0.06, 80, 0.01, 400, 6),
}

# (t_max, num_samples, noiselevel, num_regression_points)
SEIRD_WORKLOADS: Dict[str, Tuple] = {
    "ex1a": (90, 90, 0.10, 360),
    "ex1c": (60, 60, 0.10, 240),
    "ex1d": (120, 120, 0.10, 480),
    "ex2a": (120, 10, 0.05, 480),
    "ex2c": (60, 10, 0.05, 240),
    "ex2d": (90, 10, 0.05, 360),
}

# (t_max, num_samples, noiselevel, num_regression_points, num_pod_modes)
HEAT_WORKLOADS: Dict[str, Tuple] = {
    "ex3": (1.0, 20, 0.05, 80, 5),
}

NDRAWS_PAPER = 600


def run_workload(pipeline: str, name: str, ndraws: int = NDRAWS_PAPER, *, device: DeviceLike, **kw):
    """Run one named workload of the paper on ``device``."""
    if pipeline == "euler":
        from .pdes import run_euler

        t, n, nz, m, r = EULER_WORKLOADS[name]
        return run_euler((0.0, t), n, nz, m, r, ndraws=ndraws, device=device, **kw)
    if pipeline == "seird":
        from .odes import run_seird

        t, n, nz, m = SEIRD_WORKLOADS[name]
        return run_seird((0.0, t), n, nz, m, ndraws=ndraws, device=device, **kw)
    if pipeline == "heat":
        from .pdes_multi import run_heat_multi

        t, n, nz, m, r = HEAT_WORKLOADS[name]
        return run_heat_multi((0.0, t), n, nz, m, r, ndraws=ndraws, device=device, **kw)
    raise ValueError(f"unknown pipeline '{pipeline}'")
