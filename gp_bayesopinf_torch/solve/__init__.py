"""Integrators and least squares (counterpart of ``gp_bayesopinf_tpu/solve/``)."""

from .ivp import finite_mask, rk4_solve, rk4_solve_np, stability_mask
from .lstsq import WeightedLSTSQ, weighted_lstsq_fit

__all__ = [
    "finite_mask", "rk4_solve", "rk4_solve_np", "stability_mask",
    "WeightedLSTSQ", "weighted_lstsq_fit",
]
