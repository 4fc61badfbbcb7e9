"""Gaussian processes: NLML, batched fitting, estimation
(counterpart of ``gp_bayesopinf_tpu/gp/``)."""

from .nlml import BoxTransform, nlml, nlml_in_box
from .fit import FitResult, fit_gp_hyperparameters, initial_z
from .estimates import (
    GPEstimates, batched_gp_estimates, gp_estimates, gp_predict, spd_cholesky, spd_inverse_sqrt,
)
from .lowrank import (
    DEFAULT_TOL_FACTOR, LowRankEstimates, LowRankWeightRoot, batched_lowrank_gp_estimates,
    lowrank_gp_estimates,
)
from .gp import GaussianProcess, fit_gaussian_processes, regression_weights

__all__ = [
    "BoxTransform", "nlml", "nlml_in_box",
    "FitResult", "fit_gp_hyperparameters", "initial_z",
    "GPEstimates", "batched_gp_estimates", "gp_estimates", "gp_predict", "spd_cholesky",
    "spd_inverse_sqrt",
    "DEFAULT_TOL_FACTOR", "LowRankEstimates", "LowRankWeightRoot",
    "batched_lowrank_gp_estimates", "lowrank_gp_estimates",
    "GaussianProcess", "fit_gaussian_processes", "regression_weights",
]
