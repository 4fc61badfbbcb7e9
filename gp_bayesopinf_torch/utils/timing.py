"""Stage timing and profiler traces (counterpart of
``gp_bayesopinf_tpu/utils/timing.py``).

PyTorch returns from CUDA calls before the card has finished, so a stage
timed on a CUDA device synchronizes before it reads the clock. Each block
is also a ``torch.profiler.record_function`` range, so a profiler trace
of a pipeline run shows its stages (``profile_trace``,
``scripts/torch_stage_profile.py``); without a profiler the range costs
one dispatcher call.
"""

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

from .device import DeviceLike


class TimedBlock:
    """Context manager printing the wall-clock time of a stage.

    Parameters
    ----------
    message : stage label.
    timelimit : optional seconds; a block that took longer raises
        TimeoutError after it has ended (a soft watchdog: the block is not
        interrupted).
    silent : do not print (``elapsed`` is still recorded).
    device : optional device; for a CUDA device the block synchronizes it
        before reading the clock, so the time includes the queued work.
    name : the profiler range's name (default: the message).
    """

    def __init__(
        self,
        message: str,
        timelimit: Optional[float] = None,
        silent: bool = False,
        *,
        device: Optional[DeviceLike] = None,
        name: Optional[str] = None,
    ):
        self.message = message
        self.timelimit = timelimit
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
            if self.timelimit is not None and self.elapsed > self.timelimit:
                raise TimeoutError(
                    f"'{self.message.strip()}' exceeded {self.timelimit} s "
                    f"({self.elapsed:.2f} s)"
                )
        return False


class StageTimer:
    """Accumulates the wall-clock seconds of named stages; ``device`` as
    in ``TimedBlock``."""

    def __init__(self, device: Optional[DeviceLike] = None):
        self.device = device
        self.times: Dict[str, float] = {}

    def block(self, name: str, timelimit: Optional[float] = None) -> TimedBlock:
        """A ``TimedBlock`` that adds its time to ``times[name]``, also when
        its time limit is exceeded."""
        timer = self

        class _Block(TimedBlock):
            def __exit__(self, exc_type, exc, tb):
                try:
                    return TimedBlock.__exit__(self, exc_type, exc, tb)
                finally:
                    timer.times[name] = timer.times.get(name, 0.0) + self.elapsed

        return _Block(name, timelimit, device=self.device)

    def report(self) -> str:
        lines = [f"{k}: {v:.4f} s" for k, v in self.times.items()]
        lines.append(f"TOTAL: {sum(self.times.values()):.4f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(logdir: str, device: DeviceLike):
    """Record a ``torch.profiler`` trace of the enclosed block into a
    Chrome trace file (``chrome://tracing``, Perfetto) in ``logdir``.

    The trace holds the host operations and the ``TimedBlock`` stage
    ranges, and for a CUDA ``device`` the kernels run on the card. The
    block's queued work is waited for before the profiler stops. Yields
    the profiler; its file is ``<logdir>/trace-<time>-<pid>.json``, whose
    path is logged and printed.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    path = os.path.join(
        logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    )
    prof.export_chrome_trace(path)
    logging.info(f"torch profiler trace written to {path}")
    print(f"profiler trace written to {path}", flush=True)
