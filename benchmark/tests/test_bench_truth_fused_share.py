"""The ``truth_fused_share`` reader on synthetic spans: the share of the
data stage's RK4 steps that the fused truth-solve kernel took, and its
silence where the program keeps no spans, the run no trace or the window
no steps."""

import types

import pytest

from benchmark.harness import spec
from benchmark.tests import _tiny
from benchmark.tests.test_bench_span_readers import MS, _ops, _read, _run, _spans, _trace

NAME = "truth_fused_share"


def _reader():
    s = spec.load(_tiny.ROOT)
    entry = next(m for m in s["per_layer"] if m["name"] == NAME)
    return spec.load_reader(_tiny.ROOT / "benchmark" / "metrics" / f"{NAME}.py", entry)


def test_truth_fused_share_from_the_data_spans():
    """100 where the data spans' steps all ran fused, 0 where the loop ran
    them; the ensemble's steps are not the truth's."""
    r = _reader()
    trace = _trace(_ops(), (150 * MS, 950 * MS))
    fused = [s._replace(counters=dict(s.counters, rk4_fused_steps=s.counters["rk4_steps"]))
             if s.name.startswith("data.") else s for s in _spans()]
    run, rec = _run(trace, fused)
    assert _read(r, run, rec) == pytest.approx(100.0)
    part = [s._replace(counters=dict(s.counters, rk4_fused_steps=1)) if s.name == "data.samples"
            else s for s in _spans()]
    run, rec = _run(trace, part)
    assert _read(r, run, rec) == pytest.approx(100 * 1 / 5)
    run, rec = _run(trace)  # the loop took every step: none fused
    assert _read(r, run, rec) == 0.0


def test_truth_fused_share_is_silent_without_spans_trace_or_steps():
    r = _reader()
    trace = _trace(_ops(), (150 * MS, 950 * MS))
    run, _ = _run(trace)
    no_trace, rec = _run(None)
    assert _read(r, run, types.SimpleNamespace()) is None  # a program without the recorder
    assert _read(r, run, types.SimpleNamespace(spans=lambda: [])) is None
    assert _read(r, no_trace, rec) is None
    # a window without RK4 steps in its data spans (heat's host solves)
    bare = [s._replace(counters={}) if s.name.startswith("data") else s for s in _spans()]
    run, rec = _run(trace, bare)
    assert _read(r, run, rec) is None
