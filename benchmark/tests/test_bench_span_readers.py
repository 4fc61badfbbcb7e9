"""The readers of the program's spans and counters (``counts/spans.py``
and the six span metrics) on synthetic spans and device operations, and
their silence where the program keeps no spans or the run no trace."""

import types
from unittest import mock

import pytest

from benchmark.counts import spans as S
from benchmark.harness import spec
from benchmark.harness.trace import DeviceTrace
from benchmark.tests import _tiny
from gp_bayesopinf_torch.utils.timing import Span

ROOT = _tiny.ROOT
MS = 1_000_000
READERS = ("first_fit_screen_s", "first_fit_polish_s", "first_fit_estimates_s",
           "truth_ops_per_step", "ensemble_ops_per_step", "search_useful_share")


def _readers():
    s = spec.load(ROOT)
    entries = {m["name"]: m for m in s["per_layer"]}
    return {n: spec.load_reader(ROOT / "benchmark" / "metrics" / f"{n}.py", entries[n])
            for n in READERS}


def _trace(ops, window):
    t = DeviceTrace()
    t.ops = sorted(ops, key=lambda op: op[1])
    t.window_ns = window
    return t


def _spans():
    """A warm-up fit before the window (0-100 ms), then one experiment
    in it (200-900 ms): data, a fit, a regression and an ensemble."""
    sp = []

    def add(i, parent, request, name, lo, hi, **counters):
        sp.append(Span(i, parent, request, name, lo * MS, hi * MS, counters))

    add(1, None, 1, "gp.fit", 0, 100)
    add(2, 1, 1, "gp.screen", 1, 60)
    add(3, 1, 1, "gp.rerank", 60, 62)
    add(4, 1, 1, "gp.polish", 62, 90)
    add(5, 1, 1, "gp.final", 90, 91)
    add(6, 1, 1, "gp.estimates", 91, 99)
    add(10, None, 2, "experiment", 200, 900)
    add(11, 10, 2, "data", 200, 400)
    add(12, 11, 2, "data.truth", 200, 300, rk4_steps=4)
    add(13, 11, 2, "data.samples", 300, 400, rk4_steps=1)
    add(14, 10, 2, "gp_fit", 400, 500)
    add(15, 14, 2, "gp.fit", 400, 500)
    add(16, 15, 2, "gp.screen", 400, 450)
    add(17, 10, 2, "regression", 500, 600)
    add(18, 17, 2, "search.grid", 500, 550, search_slots=96, search_candidates=81)
    add(19, 17, 2, "search.refine", 550, 600, search_slots=320, search_candidates=20)
    add(20, 10, 2, "ensemble", 600, 900)
    add(21, 20, 2, "posterior.integrate", 610, 890, rk4_steps=3, dirk2_steps=1)
    return sorted(sp, key=lambda s: s.end_ns)


def _ops():
    ops = [("warm", 5 * MS, 6 * MS)]  # before the window: no span of it counts
    ops += [("truth", (200 + 10 * i) * MS, (205 + 10 * i) * MS) for i in range(20)]  # data
    ops += [("fit", 410 * MS, 420 * MS), ("screen", 505 * MS, 506 * MS)]
    ops += [("rk", (620 + 20 * i) * MS, (621 + 20 * i) * MS) for i in range(12)]  # ensemble
    return ops


def _run(trace, spans=None):
    recorder = types.SimpleNamespace(spans=lambda: list(spans if spans is not None else _spans()))
    return {"trace": trace, "experiments": [], "warmup": {}, "screens": [], "stages": [],
            "window_s": 1.0}, recorder


def _read(reader, run, recorder):
    with mock.patch.object(reader, "timing", recorder):
        return reader.read(run)


def test_first_fit_phases_come_from_the_fit_before_the_window():
    r = _readers()
    run, rec = _run(_trace(_ops(), (150 * MS, 950 * MS)))
    assert _read(r["first_fit_screen_s"], run, rec) == pytest.approx(0.059)
    assert _read(r["first_fit_polish_s"], run, rec) == pytest.approx(0.028)
    assert _read(r["first_fit_estimates_s"], run, rec) == pytest.approx(0.008)
    # no fit before the window: nothing to read
    run, rec = _run(_trace(_ops(), (0, 950 * MS)))
    assert _read(r["first_fit_screen_s"], run, rec) is None


def test_ops_per_step_and_useful_share_from_the_window():
    r = _readers()
    run, rec = _run(_trace(_ops(), (150 * MS, 950 * MS)))
    assert _read(r["truth_ops_per_step"], run, rec) == pytest.approx(20 / 5)
    assert _read(r["ensemble_ops_per_step"], run, rec) == pytest.approx(12 / 4)
    assert _read(r["search_useful_share"], run, rec) == pytest.approx(100 * 101 / 416)


def test_the_readers_are_silent_without_spans_trace_or_counts():
    r = _readers()
    trace = _trace(_ops(), (150 * MS, 950 * MS))
    run, _ = _run(trace)
    parent = types.SimpleNamespace()  # a program without the recorder
    empty = types.SimpleNamespace(spans=lambda: [])
    no_trace, rec = _run(None)
    for name in READERS:
        assert _read(r[name], run, parent) is None
        assert _read(r[name], run, empty) is None
        assert _read(r[name], no_trace, rec) is None
    # a window without RK4 steps in its data spans (heat's host solves)
    bare = [s._replace(counters={}) if s.name.startswith("data") else s for s in _spans()]
    run, rec = _run(trace, bare)
    assert _read(r["truth_ops_per_step"], run, rec) is None


def test_ops_inside_takes_the_start_rule_and_innermost_labels_gaps():
    sp = _spans()
    ops = _ops()
    tops = [s for s in sp if s.name in ("data", "ensemble")]
    assert S.ops_inside(ops, tops) == 32
    # an operation starting at a span's end belongs to the next range
    assert S.ops_inside([("x", 400 * MS, 401 * MS)], [s for s in sp if s.name == "data"]) == 0
    assert S.innermost(sp, 612 * MS, 615 * MS).name == "posterior.integrate"
    assert S.innermost(sp, 150 * MS, 160 * MS) is None
    gaps = S.label_gaps(ops, sp, top=4)
    assert gaps[0] == ["outside spans", pytest.approx(0.194)]  # 6 ms to 200 ms
    assert gaps[1] == ["experiment", pytest.approx(0.114)]  # 506 to 620 ms: across stages
    assert [g[0] for g in gaps[2:]] == ["experiment", "posterior.integrate"]
    assert S.subtree_counter(sp, [s for s in sp if s.name == "experiment"], "rk4_steps") == 8
