"""Gaussian processes: NLML, batched fitting, estimation
(counterpart of ``gp_bayesopinf_tpu/gp/``)."""

from .nlml import BoxTransform, nlml, nlml_in_box
from .fit import FitResult, fit_gp_hyperparameters, initial_z
from .estimates import (
    GPEstimates, batched_gp_estimates, gp_predict, spd_cholesky, spd_inverse_sqrt,
)
from .gp import GaussianProcess, fit_gaussian_processes

__all__ = [
    "BoxTransform", "nlml", "nlml_in_box",
    "FitResult", "fit_gp_hyperparameters", "initial_z",
    "GPEstimates", "batched_gp_estimates", "gp_predict", "spd_cholesky",
    "spd_inverse_sqrt",
    "GaussianProcess", "fit_gaussian_processes",
]
