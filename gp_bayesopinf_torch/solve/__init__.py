"""Integrators and least squares (counterpart of ``gp_bayesopinf_tpu/solve/``)."""

from .ivp import finite_mask, rk4_solve, rk4_solve_np, rk4_stage_times, stability_mask
from .lstsq import MatrixTikhonovLSTSQ, TikhonovLSTSQ, WeightedLSTSQ, weighted_lstsq_fit

__all__ = [
    "finite_mask", "rk4_solve", "rk4_solve_np", "rk4_stage_times", "stability_mask",
    "MatrixTikhonovLSTSQ", "TikhonovLSTSQ", "WeightedLSTSQ", "weighted_lstsq_fit",
]
