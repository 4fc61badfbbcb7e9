"""Device policy, named random streams and stage timing
(counterpart of ``gp_bayesopinf_tpu/utils/``)."""

from .device import resolve_device
from .keys import STAGES, stage_generators
from .timing import TimedBlock

__all__ = ["resolve_device", "STAGES", "stage_generators", "TimedBlock"]
