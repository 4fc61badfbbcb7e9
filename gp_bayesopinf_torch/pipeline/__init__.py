"""Experiment pipelines (counterpart of ``gp_bayesopinf_tpu/pipeline/``;
the Euler and heat-multi pipelines)."""

from .configs import EulerConfig, GPBounds, HeatMultiConfig
from .pdes import EulerResult, ensemble_error, run_euler
from .pdes_multi import HeatMultiResult, ensemble_errors, run_heat_multi

__all__ = [
    "EulerConfig", "GPBounds", "HeatMultiConfig", "EulerResult", "ensemble_error",
    "run_euler", "HeatMultiResult", "ensemble_errors", "run_heat_multi",
]
