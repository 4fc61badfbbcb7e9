"""The ``ensemble_fused_share`` reader on synthetic spans: the share of the
posterior ensembles' SDIRK2 steps that the fused kernel took, and its
silence where the program keeps no spans, the run no trace or the window
no SDIRK2 steps."""

import types

import pytest

from benchmark.harness import spec
from benchmark.tests import _tiny
from benchmark.tests.test_bench_span_readers import MS, _ops, _read, _run, _spans, _trace
from gp_bayesopinf_torch.utils.timing import Span

NAME = "ensemble_fused_share"


def _reader():
    s = spec.load(_tiny.ROOT)
    entry = next(m for m in s["per_layer"] if m["name"] == NAME)
    return spec.load_reader(_tiny.ROOT / "benchmark" / "metrics" / f"{NAME}.py", entry)


def _heat_spans(fused_ensemble=0, fused_newparam=0):
    """The synthetic experiment with a heat run's second ensemble: the
    ensemble's integration counts 3 SDIRK2 steps, the newparam stage's 2."""
    out = []
    for s in _spans():
        if s.name == "experiment":
            s = s._replace(end_ns=990 * MS)
        if s.name == "posterior.integrate":
            s = s._replace(counters={"dirk2_steps": 3, "dirk2_fused_steps": fused_ensemble})
        out.append(s)
    out.append(Span(30, 10, 2, "newparam", 900 * MS, 980 * MS, {}))
    out.append(Span(31, 30, 2, "posterior.integrate", 905 * MS, 975 * MS,
                    {"dirk2_steps": 2, "dirk2_fused_steps": fused_newparam}))
    return sorted(out, key=lambda s: s.end_ns)


def test_ensemble_fused_share_from_the_ensemble_spans():
    """100 where both ensembles ran fused, a part where one did, 0 where
    the loop ran every step; the data stage's steps are not the ensemble's."""
    r = _reader()
    trace = _trace(_ops(), (150 * MS, 995 * MS))
    run, rec = _run(trace, _heat_spans(3, 2))
    assert _read(r, run, rec) == pytest.approx(100.0)
    run, rec = _run(trace, _heat_spans(3, 0))
    assert _read(r, run, rec) == pytest.approx(100 * 3 / 5)
    run, rec = _run(trace, _heat_spans(0, 0))
    assert _read(r, run, rec) == 0.0
    # counters outside the two stages are not read
    stray = [s._replace(counters=dict(s.counters, dirk2_fused_steps=7))
             if s.name == "data.truth" else s for s in _heat_spans(0, 2)]
    run, rec = _run(trace, stray)
    assert _read(r, run, rec) == pytest.approx(100 * 2 / 5)


def test_ensemble_fused_share_is_silent_without_spans_trace_or_steps():
    r = _reader()
    trace = _trace(_ops(), (150 * MS, 995 * MS))
    run, _ = _run(trace)
    no_trace, rec = _run(None, _heat_spans(3, 2))
    assert _read(r, run, types.SimpleNamespace()) is None  # a program without the recorder
    assert _read(r, run, types.SimpleNamespace(spans=lambda: [])) is None
    assert _read(r, no_trace, rec) is None
    # a window whose ensembles take no SDIRK2 step (the RK4 ROMs and ODEs)
    rk4 = [s._replace(counters={"rk4_steps": 3}) if s.name == "posterior.integrate" else s
           for s in _spans()]
    run, rec = _run(trace, rk4)
    assert _read(r, run, rec) is None
