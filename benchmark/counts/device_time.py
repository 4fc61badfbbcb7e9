"""Device time from the profiler's events.

``stage_device_time`` is a frozen copy of
``scripts/torch_stage_profile.py`` at commit d674a25 (lines 73-99),
unchanged: the kernels and copies that start inside each stage's range,
and their busy time as the union of their intervals. ``busy_ns`` is the
same union over any list of intervals.
"""

import torch


def stage_device_time(prof, stages):
    """{stage: (device operations, device-busy ms, screen-kernel launches,
    screen-kernel ms)} from the profiler's raw events: the kernels and
    copies that start inside the stage's range, their busy time the union
    of their intervals (overlaps count once). The stage ranges' own
    projections onto the device timeline (events named after the stage)
    are not operations and are left out."""
    events = prof.profiler.kineto_results.events()
    device = sorted(
        (d.start_ns(), d.start_ns() + d.duration_ns(), "screen_kernel" in d.name())
        for d in events
        if d.device_type() == torch.autograd.DeviceType.CUDA and d.name() not in stages
    )
    out = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in stages:
            lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
            inside = [iv for iv in device if lo <= iv[0] < hi]
            screens = [b - a for a, b, is_screen in inside if is_screen]
            busy, end = 0, None
            for a, b, _ in inside:
                if end is None or a > end:
                    busy, end = busy + (b - a), b
                elif b > end:
                    busy, end = busy + (b - end), b
            out[e.name()] = (len(inside), busy / 1e6, len(screens), sum(screens) / 1e6)
    return out


def busy_ns(intervals):
    """The union's length of (start, end) intervals, sorted by start, as
    ``stage_device_time`` adds them up."""
    busy, end = 0, None
    for a, b in intervals:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return busy


def idle_gaps(intervals):
    """(start, end) of each gap between the union's pieces, intervals
    sorted by start."""
    gaps, end = [], None
    for a, b in intervals:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps
