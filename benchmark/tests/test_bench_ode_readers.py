"""The readers of the ODE ensembles' two metrics, ``ode_ensemble_s`` and
``ode_ensemble_ops_per_step``, on synthetic stage seconds, spans and
device operations of two SEIRD experiments, and their silence where the
program keeps no spans, the run has no trace or nothing was counted."""

import types
from unittest import mock

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import DeviceTrace
from benchmark.tests import _tiny
from gp_bayesopinf_torch.utils.timing import Span

MS = 1_000_000
READERS = ("ode_ensemble_s", "ode_ensemble_ops_per_step")


def _readers():
    s = spec.load(_tiny.ROOT)
    entries = {m["name"]: m for m in s["per_layer"]}
    return {n: spec.load_reader(_tiny.ROOT / "benchmark" / "metrics" / f"{n}.py", entries[n])
            for n in READERS}


def _spans():
    """Two experiments in the window (100-500 and 500-900 ms), each with a
    data stage whose host solves count steps, a search, and the two
    ensembles; a third experiment's ensemble ends after the window."""
    sp = []

    def add(i, parent, request, name, lo, hi, **counters):
        sp.append(Span(i, parent, request, name, lo * MS, hi * MS, counters))

    for e, base in enumerate((100, 500)):
        i, req = 10 * (e + 1), e + 1
        add(i, None, req, "experiment", base, base + 400)
        add(i + 1, i, req, "data", base, base + 50)
        add(i + 2, i + 1, req, "data.truth", base, base + 30, rk4_steps=7984)
        add(i + 3, i, req, "regression", base + 50, base + 150)
        add(i + 4, i + 3, req, "search.grid", base + 50, base + 100)
        add(i + 5, i + 4, req, "search.operator_map", base + 50, base + 51)
        add(i + 6, i, req, "ensemble", base + 150, base + 300)
        add(i + 7, i + 6, req, "posterior.integrate", base + 160, base + 290, rk4_steps=10)
        add(i + 8, i, req, "newic", base + 300, base + 400)
        add(i + 9, i + 8, req, "posterior.integrate", base + 310, base + 390, rk4_steps=10)
    add(40, None, 3, "newic", 880, 990, rk4_steps=10)
    return sorted(sp, key=lambda s: s.end_ns)


def _ops():
    ops = []
    for base in (100, 500):
        ops += [("truth", (base + i) * MS, (base + i) * MS + 10) for i in range(20)]  # data
        ops += [("screen", (base + 60) * MS, (base + 61) * MS)]
        ops += [("rk", (base + 160 + i) * MS, (base + 160 + i) * MS + 10) for i in range(30)]
        ops += [("rk", (base + 310 + i) * MS, (base + 310 + i) * MS + 10) for i in range(50)]
    return ops


def _trace(window=(50 * MS, 950 * MS)):
    t = DeviceTrace()
    t.ops = sorted(_ops(), key=lambda op: op[1])
    t.window_ns = window
    return t


def _read(reader, run, spans):
    recorder = types.SimpleNamespace(spans=lambda: list(spans))
    with mock.patch.object(reader, "timing", recorder):
        return reader.read(run)


def _run(trace, experiments=()):
    return {"trace": trace, "experiments": list(experiments), "warmup": {}, "screens": [],
            "stages": [], "window_s": 0.9}


def test_ode_ensemble_s_is_the_mean_of_both_ensembles_stages():
    r = _readers()["ode_ensemble_s"]
    experiments = [{"stage_seconds": {"data": 0.05, "ensemble": 2.0, "newic": 2.25}},
                   {"stage_seconds": {"data": 0.05, "ensemble": 1.5, "newparam": 9.0}}]
    assert r.read(_run(None, experiments)) == pytest.approx((4.25 + 1.5) / 2)
    assert r.read(_run(None)) is None


def test_ode_ensemble_ops_per_step_counts_both_ensembles_in_the_window():
    """The 160 operations that start in the window's ``ensemble`` and
    ``newic`` spans over their 40 steps; the data stage's operations and
    steps, and a span that ends after the window, are not counted."""
    r = _readers()["ode_ensemble_ops_per_step"]
    assert _read(r, _run(_trace()), _spans()) == pytest.approx(160 / 40)


def test_ode_readers_are_silent_without_spans_trace_or_steps():
    r = _readers()["ode_ensemble_ops_per_step"]
    run = _run(_trace())
    parent = types.SimpleNamespace()  # a program without the recorder
    with mock.patch.object(r, "timing", parent):
        assert r.read(run) is None
    assert _read(r, run, []) is None
    assert _read(r, _run(None), _spans()) is None
    bare = [s._replace(counters={}) for s in _spans()]
    assert _read(r, run, bare) is None
