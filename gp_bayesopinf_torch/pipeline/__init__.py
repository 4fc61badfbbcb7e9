"""Experiment pipelines (counterpart of ``gp_bayesopinf_tpu/pipeline/``;
the SEIRD, Euler and heat-multi pipelines). The SEIRD pipeline's accuracy
metric is ``pipeline.odes.ensemble_error``."""

from .configs import EulerConfig, GPBounds, HeatMultiConfig, SEIRDConfig
from .odes import SEIRDResult, run_seird, sample_trajectory
from .pdes import EulerResult, derivative_comparison_data, ensemble_error, run_euler
from .pdes_multi import HeatMultiResult, ensemble_errors, run_heat_multi

__all__ = [
    "EulerConfig", "GPBounds", "HeatMultiConfig", "SEIRDConfig",
    "SEIRDResult", "run_seird", "sample_trajectory",
    "EulerResult", "derivative_comparison_data", "ensemble_error", "run_euler",
    "HeatMultiResult", "ensemble_errors", "run_heat_multi",
]
