"""Experiment pipelines (counterpart of ``gp_bayesopinf_tpu/pipeline/``;
the Euler pipeline of this slice)."""

from .configs import EulerConfig, GPBounds
from .pdes import EulerResult, ensemble_error, run_euler

__all__ = ["EulerConfig", "GPBounds", "EulerResult", "ensemble_error", "run_euler"]
