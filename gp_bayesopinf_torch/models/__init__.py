"""Truth models (counterpart of ``gp_bayesopinf_tpu/models/``)."""

from .euler import Euler

__all__ = ["Euler"]
