"""The traced run's profiler: CUDA activity only, kept in memory.

Only the device's activity is recorded (kernels, copies, sets): no host
operator events, so the program's ~10^6 small host calls an experiment do
not each pay for a record. The events are read from the profiler's raw
results and never exported as a Chrome trace. Their timestamps are on the
host's ``time.time_ns()`` clock, on which the harness records the
program's stages.
"""

import time

import torch

from ..counts.device_time import busy_ns, idle_gaps, stage_device_time


class DeviceTrace:
    """Start with ``start()``; ``stop()`` waits for the device, ends the
    profiler and keeps (name, start_ns, end_ns) of every device
    operation."""

    def __init__(self):
        self.ops = []
        self.window_ns = (0, 0)
        self._prof = None

    def start(self):
        from torch.autograd import profiler as tap

        self._prof = tap.profile(use_cpu=False, use_device="cuda", use_kineto=True)
        self._prof._prepare_trace()
        self._prof._start_trace()
        self.window_ns = (time.time_ns(), 0)

    def stop(self):
        from torch.autograd import profiler as tap

        torch.cuda.synchronize()
        self.window_ns = (self.window_ns[0], time.time_ns())
        results = tap._disable_profiler()
        self._prof = None
        cuda = torch.autograd.DeviceType.CUDA
        self.ops = sorted(
            (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in results.events() if e.device_type() == cuda
        )
        self.ops.sort(key=lambda op: op[1])

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return busy_ns([(a, b) for _, a, b in self.ops]) / 1e9

    def breakdown(self, stages, top: int = 10):
        """{"device_ops": [[name, seconds]], "idle_gaps": [[label,
        seconds]]}: the device operations with the most time, by name, and
        the longest idle gaps, each labelled by the stage whose host range
        encloses it (or "between stages")."""
        by_name = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle_gaps([(a, b) for _, a, b in self.ops]), key=lambda g: g[0] - g[1])[:top]

        def label(gap):
            for name, lo, hi in stages:
                if lo <= gap[0] and gap[1] <= hi:
                    return name
            return "between stages"

        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[label(g), (g[1] - g[0]) / 1e9] for g in gaps]}

    def stage_busy(self, stages):
        """{stage: (device operations, busy ms, screen launches, screen ms)}
        summed over the experiments, by ``counts.device_time.
        stage_device_time`` over the host ranges of the stages."""
        tagged = [(f"{name}#{i}", lo, hi) for i, (name, lo, hi) in enumerate(stages)]
        per_range = stage_device_time(_EventsView(self.ops, tagged), [t[0] for t in tagged])
        total = {}
        for key, vals in per_range.items():
            name = key.rsplit("#", 1)[0]
            old = total.get(name, (0, 0.0, 0, 0.0))
            total[name] = tuple(x + y for x, y in zip(old, vals))
        return total


class _Event:
    def __init__(self, name, device, lo, hi):
        self._v = (name, device, lo, hi)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


class _EventsView:
    """What ``stage_device_time`` reads of a profiler
    (``prof.profiler.kineto_results.events()``): the device operations and
    the stages' host ranges as host events."""

    def __init__(self, ops, stages):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        events = [_Event(n, cuda, a, b) for n, a, b in ops]
        events += [_Event(n, cpu, a, b) for n, a, b in stages]
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events
