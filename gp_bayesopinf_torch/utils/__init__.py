"""Device policy, named random streams, stage timing and logging
(counterpart of ``gp_bayesopinf_tpu/utils/``)."""

from .device import resolve_device
from .keys import MULTI_STAGES, ODE_STAGES, STAGES, host_rng, stage_generators
from .logging import setup_logging
from .timing import StageTimer, TimedBlock, profile_trace

__all__ = [
    "resolve_device", "MULTI_STAGES", "ODE_STAGES", "STAGES", "host_rng",
    "stage_generators", "setup_logging", "StageTimer", "TimedBlock", "profile_trace",
]
