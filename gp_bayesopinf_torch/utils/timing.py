"""Stage timing, spans, work counters and profiler traces (counterpart of
``gp_bayesopinf_tpu/utils/timing.py``, which has the stage timers only).

PyTorch returns from CUDA calls before the card has finished, so a stage
timed on a CUDA device synchronizes before it reads the clock. Each block
is also a ``torch.profiler.record_function`` range, so a profiler trace
of a pipeline run shows its stages (``profile_trace``,
``scripts/torch_stage_profile.py``); without a profiler the range costs
one dispatcher call.

The span recorder
-----------------
Every ``TimedBlock`` and every ``span(name)`` is recorded as a ``Span``
``(id, parent, request, name, start_ns, end_ns, counters)``, stamped with
``time.time_ns()``: the clock on which ``torch.profiler`` puts its
events, so device operations can be matched to the spans that launched
them. A ``span`` synchronizes nothing and reads nothing off the device;
it is also a ``record_function`` range, so the Chrome trace of
``--profile`` shows it. ``count(name, n)`` adds ``n`` to the innermost
open span's ``counters``; the counts come from host-known quantities,
once a call. A span opened while none is open is a root and takes a
fresh request id, which its descendants share: each runner call
(``run_euler``, ``run_heat_multi``, ``run_seird``, ``run_scaled``) is
one root named ``experiment``; a fit outside a runner (a warm-up) is a
root of its own. The open spans are a per-thread stack. Closed spans are
kept in memory only, the last ``MAX_SPANS`` of them (``spans()``,
``clear()``); nothing is written out. The recorder is always on.

Spans (parent in brackets):

* ``experiment`` (root): one runner call;
* the runners' stages (``experiment``), ``TimedBlock`` names: ``data``,
  ``pod``, ``gp_fit``, ``regression``, ``ensemble``, ``decompress``,
  ``newparam``, ``ddtdata`` (and the SEIRD and scaled runners' own);
* ``data.truth``, ``data.samples`` (``data``): the truth solves at the
  prediction grid; the solves at the sample times with the noise;
* ``gp.fit`` (``gp_fit``, or a root): ``fit_gaussian_processes``, with
  ``gp.screen``, ``gp.rerank``, ``gp.polish`` and ``gp.final``, the four
  phases of ``gp/fit.py``, and ``gp.estimates``, the estimates and the
  weight roots;
* ``search.grid``, ``search.refine`` (``regression``): the
  regularization search's grid and bounded refinement, and inside them
  ``search.operator_map``, a parametric model's draws made operator rows
  (SEIRD);
* ``posterior.integrate`` (``ensemble``, ``newparam``, ``newic``): the
  posterior draws' integration in ``solution_posterior``;
* ``ops.load_library``: a kernel library's first load.

Counters (on the innermost open span):

* ``rk4_steps``: (k - 1) substeps a ``rk4_solve`` or ``rk4_solve_np``,
  and a fused Euler truth solve (``Euler.solve`` on the card);
* ``rk4_fused_steps``: the same steps of a fused Euler truth solve
  (``ops/euler_truth.py``);
* ``dirk2_steps``: (k - 1) substeps a ``dirk2_solve``, and a fused SDIRK2
  integration (``GalerkinROM.predict`` of a dirk2 "cAHBN" ROM on the card);
* ``dirk2_fused_steps``: the same steps of a fused SDIRK2 integration
  (``ops/cahbn_dirk2.py``);
* ``search_slots``, ``search_candidates``: per objective call of the
  search, the candidates screened (padding included) and the distinct
  real ones among them.

Each counter feeds a benchmark metric (``benchmark/counts/spans.py``):
the steps ``truth_ops_per_step`` and ``ensemble_ops_per_step``, the
fused steps ``truth_fused_share`` and ``ensemble_fused_share``, the
search's two ``search_useful_share``.
"""

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from .device import DeviceLike

#: Closed spans kept, the newest.
MAX_SPANS = 65_536


class Span(NamedTuple):
    """A closed span; times are ``time.time_ns()``."""

    id: int
    parent: Optional[int]  # None for a root
    request: int  # shared by a root and its descendants
    name: str
    start_ns: int
    end_ns: int
    counters: Dict[str, int]


class _Open:
    __slots__ = ("id", "parent", "request", "name", "start_ns", "counters")


_closed = collections.deque(maxlen=MAX_SPANS)
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(name: str) -> _Open:
    stack = _stack()
    sp = _Open()
    sp.id, sp.name, sp.counters = next(_span_ids), name, {}
    if stack:
        sp.parent, sp.request = stack[-1].id, stack[-1].request
    else:
        sp.parent, sp.request = None, next(_request_ids)
    stack.append(sp)
    sp.start_ns = time.time_ns()
    return sp


def _close(sp: _Open) -> None:
    end = time.time_ns()
    _stack().remove(sp)
    _closed.append(Span(sp.id, sp.parent, sp.request, sp.name, sp.start_ns, end, sp.counters))


@contextlib.contextmanager
def span(name: str):
    """A span around the block (or, as a decorator, each call): a child
    of the innermost open span, or a root. No device synchronization."""
    with torch.profiler.record_function(name):
        sp = _open(name)
        try:
            yield
        finally:
            _close(sp)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of this
    thread; nothing where none is open."""
    stack = _stack()
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def spans() -> List[Span]:
    """The closed spans kept, in the order they closed."""
    return list(_closed)


def clear() -> None:
    """Forget the closed spans."""
    _closed.clear()


class TimedBlock:
    """Context manager printing the wall-clock time of a stage, recorded
    as a span named after its profiler range.

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
        self._span = _open(self._range.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._sync()
        self.elapsed = time.perf_counter() - self._t0
        _close(self._span)
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
