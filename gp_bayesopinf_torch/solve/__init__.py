"""Integrators and least squares (counterpart of ``gp_bayesopinf_tpu/solve/``)."""

from .ivp import (
    dirk2_solve, finite_mask, rk4_solve, rk4_solve_np, rk4_stage_times, stability_mask,
    thomas_solve,
)
from .lstsq import MatrixTikhonovLSTSQ, TikhonovLSTSQ, WeightedLSTSQ, weighted_lstsq_fit

__all__ = [
    "dirk2_solve", "finite_mask", "rk4_solve", "rk4_solve_np", "rk4_stage_times",
    "stability_mask", "thomas_solve",
    "MatrixTikhonovLSTSQ", "TikhonovLSTSQ", "WeightedLSTSQ", "weighted_lstsq_fit",
]
