"""Stage timing (counterpart of ``gp_bayesopinf_tpu/utils/timing.py``).

PyTorch returns from CUDA calls before the card has finished, so a stage
timed on a CUDA device synchronizes before it reads the clock. Each block
is also a ``torch.profiler.record_function`` range, so a profiler trace
of a pipeline run shows its stages (``scripts/torch_stage_profile.py``);
without a profiler the range costs one dispatcher call.
"""

import logging
import time
from typing import Optional

import torch


class TimedBlock:
    """Context manager printing the wall-clock time of a stage.

    Parameters
    ----------
    message : stage label.
    device : optional device; for a CUDA device the block synchronizes it
        before reading the clock, so the time includes the queued work.
    silent : do not print (``elapsed`` is still recorded).
    name : the profiler range's name (default: the message).
    """

    def __init__(
        self,
        message: str,
        device: Optional[torch.device] = None,
        silent: bool = False,
        name: Optional[str] = None,
    ):
        self.message = message
        self.device = device
        self.silent = silent
        self.elapsed = None
        self._range = torch.profiler.record_function(name or message.strip())

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if not self.silent:
            print(self.message, end="" if self.message.endswith("\n") else "...",
                  flush=True)
        self._sync()
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._sync()
        self.elapsed = time.perf_counter() - self._t0
        self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            if not self.silent:
                print(f"done in {self.elapsed:.2f} s.", flush=True)
            logging.info(f"{self.message.strip()}: {self.elapsed:.6f} s")
        return False
