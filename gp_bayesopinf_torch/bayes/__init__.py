"""Bayesian operator posteriors and the regularization search
(counterpart of ``gp_bayesopinf_tpu/bayes/``)."""

from .posterior import BayesianODE, BayesianROM, OperatorPosterior
from .regsearch import (
    DEFAULT_GRID_ODE, DEFAULT_GRID_PDE, MAXOPTVAL, KernelScreenSpec, RegSearchResult,
    auto_regularize,
)

__all__ = [
    "BayesianODE", "BayesianROM", "OperatorPosterior",
    "DEFAULT_GRID_ODE", "DEFAULT_GRID_PDE", "MAXOPTVAL", "KernelScreenSpec",
    "RegSearchResult", "auto_regularize",
]
