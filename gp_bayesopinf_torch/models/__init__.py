"""Truth models (counterpart of ``gp_bayesopinf_tpu/models/``)."""

from .euler import Euler
from .heat import CubicHeatBimodal, HeatBimodal, solve_host_stacked

__all__ = ["Euler", "CubicHeatBimodal", "HeatBimodal", "solve_host_stacked"]
