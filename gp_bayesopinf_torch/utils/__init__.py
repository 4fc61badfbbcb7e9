"""Device policy, named random streams and stage timing
(counterpart of ``gp_bayesopinf_tpu/utils/``)."""

from .device import resolve_device
from .keys import MULTI_STAGES, STAGES, stage_generators
from .timing import TimedBlock

__all__ = [
    "resolve_device", "MULTI_STAGES", "STAGES", "stage_generators", "TimedBlock",
]
