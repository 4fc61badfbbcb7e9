"""Experiment pipelines (counterpart of ``gp_bayesopinf_tpu/pipeline/``;
the SEIRD, Euler, heat-multi and production-scale pipelines and the
paper's named workloads). The SEIRD pipeline's accuracy metric is
``pipeline.odes.ensemble_error``."""

from .configs import EulerConfig, GPBounds, HeatMultiConfig, SEIRDConfig
from .odes import SEIRDResult, run_seird, sample_trajectory
from .pdes import EulerResult, derivative_comparison_data, ensemble_error, run_euler
from .pdes_multi import HeatMultiResult, ensemble_errors, run_heat_multi
from .scaled import ScaledNormals, ScaledResult, run_scaled
from .experiments import run_workload

__all__ = [
    "EulerConfig", "GPBounds", "HeatMultiConfig", "SEIRDConfig",
    "SEIRDResult", "run_seird", "sample_trajectory",
    "EulerResult", "derivative_comparison_data", "ensemble_error", "run_euler",
    "HeatMultiResult", "ensemble_errors", "run_heat_multi",
    "ScaledNormals", "ScaledResult", "run_scaled", "run_workload",
]
