"""Bayesian operator posteriors and the regularization search
(counterpart of ``gp_bayesopinf_tpu/bayes/``)."""

from .posterior import BayesianROM, OperatorPosterior
from .regsearch import MAXOPTVAL, RegSearchResult, auto_regularize

__all__ = [
    "BayesianROM", "OperatorPosterior",
    "MAXOPTVAL", "RegSearchResult", "auto_regularize",
]
