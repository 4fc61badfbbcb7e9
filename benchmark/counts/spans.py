"""The program's spans joined with the traced run's device operations.

The spans are the records of ``gp_bayesopinf_torch.utils.timing``
(``id, parent, request, name, start_ns, end_ns, counters``), kept in the
process's memory and stamped with ``time.time_ns()``; the operations are
``harness.trace.DeviceTrace.ops`` (name, start_ns, end_ns), on the same
clock. An operation belongs to a span when it starts inside the span's
host range, the rule of ``device_time.stage_device_time``. A recorder
without ``spans`` (a program before it had one) gives None throughout.
"""

import bisect

from .device_time import idle_gaps


def recorded(recorder):
    """The recorder's closed spans, or None where it keeps none."""
    spans = getattr(recorder, "spans", None)
    return spans() if callable(spans) else None


def in_window(recorder, trace):
    """The closed spans wholly inside the traced window; None without a
    trace or a recorder."""
    spans = recorded(recorder) if trace is not None else None
    if spans is None:
        return None
    lo, hi = trace.window_ns
    return [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]


def first_fit_phase_s(recorder, trace, phase: str):
    """Seconds of the child span ``phase`` of the process's first
    ``gp.fit``, among the spans that ended before the traced window (the
    set-up's warm-up fit); None where there is none."""
    spans = recorded(recorder) if trace is not None else None
    if not spans:
        return None
    fits = [s for s in spans if s.name == "gp.fit" and s.end_ns <= trace.window_ns[0]]
    if not fits:
        return None
    first = min(fits, key=lambda s: s.start_ns)
    parts = [s for s in spans if s.parent == first.id and s.name == phase]
    return sum(s.end_ns - s.start_ns for s in parts) / 1e9 if parts else None


def subtree_counter(spans, tops, name: str) -> int:
    """Counter ``name`` summed over the spans ``tops`` and all their
    descendants."""
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    total, todo = 0, list(tops)
    while todo:
        s = todo.pop()
        total += s.counters.get(name, 0)
        todo += children.get(s.id, [])
    return total


def ops_inside(ops, spans) -> int:
    """Device operations that start inside the host range of one of
    ``spans`` (spans that do not overlap: each operation counts once),
    ``ops`` sorted by start."""
    starts = [op[1] for op in ops]
    return sum(bisect.bisect_left(starts, s.end_ns) - bisect.bisect_left(starts, s.start_ns)
               for s in spans)


def ops_per_step(recorder, trace, stages, counters):
    """Device operations in the window's spans named in ``stages`` over
    the sum of ``counters`` in them and their descendants; None where
    nothing was counted."""
    spans = in_window(recorder, trace)
    if spans is None:
        return None
    tops = [s for s in spans if s.name in stages]
    steps = sum(subtree_counter(spans, tops, c) for c in counters)
    return ops_inside(trace.ops, tops) / steps if steps else None


def innermost(spans, lo: int, hi: int):
    """The deepest span whose host range encloses [lo, hi], or None."""
    by_id = {s.id: s for s in spans}

    def depth(s):
        d = 0
        while s.parent in by_id:
            s, d = by_id[s.parent], d + 1
        return d

    around = [s for s in spans if s.start_ns <= lo and hi <= s.end_ns]
    return max(around, key=depth) if around else None


def label_gaps(ops, spans, top: int = 10):
    """[[label, seconds]] of the ``top`` longest idle gaps between the
    operations, each labelled by the innermost span around it ("outside
    spans" where none is)."""
    gaps = sorted(idle_gaps([(a, b) for _, a, b in ops]), key=lambda g: g[0] - g[1])[:top]
    out = []
    for lo, hi in gaps:
        s = innermost(spans, lo, hi)
        out.append([s.name if s else "outside spans", (hi - lo) / 1e9])
    return out
