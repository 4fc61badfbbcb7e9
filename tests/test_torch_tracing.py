"""The span recorder of ``gp_bayesopinf_torch.utils.timing``: nesting,
request ids, the profiler's clock, the bound on kept spans, the work
counters of the integrators and the search, a kernel library's load, the
span tree of small CPU runs of the Euler, heat and SEIRD runners, a patched
``TimedBlock`` as the benchmark harness patches it, and no device
synchronization in a span."""

import gc
import time
from unittest import mock

import numpy as np
import pytest
import scipy.optimize
import torch

from gp_bayesopinf_torch.bayes import auto_regularize, regsearch
from gp_bayesopinf_torch.gp import fit_gaussian_processes
from gp_bayesopinf_torch.ops import build
from gp_bayesopinf_torch.pipeline import EulerConfig, GPBounds, HeatMultiConfig, SEIRDConfig
from gp_bayesopinf_torch.pipeline import odes, pdes, pdes_multi
from gp_bayesopinf_torch.rom import GalerkinROM
from gp_bayesopinf_torch.solve import ivp, weighted_lstsq_fit
from gp_bayesopinf_torch.utils import TimedBlock, timing

F64 = torch.float64
BOUNDS = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))


def _mine(request):
    """The closed spans of one request, by id."""
    return {s.id: s for s in timing.spans() if s.request == request}


def _root_request(name):
    return max(s.request for s in timing.spans() if s.name == name and s.parent is None)


def _children(spans, parent):
    return [s for s in spans.values() if s.parent == parent.id]


def _subtree_counter(spans, top, name):
    total, todo = 0, [top]
    while todo:
        s = todo.pop()
        total += s.counters.get(name, 0)
        todo += _children(spans, s)
    return total


def test_spans_nest_with_parent_and_request():
    with timing.span("a.root"):
        with timing.span("a.child"):
            timing.count("n", 2)
            timing.count("n")
            with TimedBlock("a stage", silent=True, device="cpu", name="a.stage"):
                timing.count("m", 5)
        with timing.span("a.second"):
            pass
    with timing.span("b.root"):
        pass
    timing.count("nowhere")  # no open span: dropped
    spans = {s.name: s for s in timing.spans()[-5:]}
    root, child, stage = spans["a.root"], spans["a.child"], spans["a.stage"]
    assert root.parent is None and spans["b.root"].parent is None
    assert child.parent == root.id and spans["a.second"].parent == root.id
    assert stage.parent == child.id
    assert {s.request for s in (root, child, stage, spans["a.second"])} == {root.request}
    assert spans["b.root"].request > root.request
    assert child.counters == {"n": 3} and stage.counters == {"m": 5} and root.counters == {}
    assert root.start_ns <= child.start_ns <= stage.start_ns <= stage.end_ns <= child.end_ns
    assert child.end_ns <= spans["a.second"].start_ns <= root.end_ns


def test_a_span_closes_on_a_raise_and_as_a_decorator():
    @timing.span("deco")
    def work(x):
        timing.count("calls")
        if x:
            raise KeyError(x)
        return 7

    assert work(0) == 7
    with pytest.raises(KeyError):
        work(1)
    last = timing.spans()[-2:]
    assert [s.name for s in last] == ["deco", "deco"]
    assert all(s.parent is None and s.counters == {"calls": 1} for s in last)
    assert last[0].request != last[1].request
    with timing.span("after"):
        pass
    assert timing.spans()[-1].parent is None  # the raise left nothing open


def test_span_starts_on_the_profilers_clock():
    """A span and its profiler range start and end within 1 ms of each
    other in one of three tries (a try may meet a descheduled thread; a
    clock of its own would be off by far more)."""
    with timing.span("clock.warm"):  # the first range's set-up is not the clock's
        pass
    offsets = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with timing.span("clock.outer"):
                with timing.span("clock.inner"):
                    torch.ones(4).sum()
        mine = {s.name: s for s in timing.spans()[-2:]}
        events = {e.name(): e for e in prof.profiler.kineto_results.events()
                  if e.name() in mine}
        assert set(events) == set(mine)
        offsets.append(max(max(abs(e.start_ns() - mine[n].start_ns),
                               abs(e.start_ns() + e.duration_ns() - mine[n].end_ns))
                           for n, e in events.items()))
    assert min(offsets) < 1_000_000, offsets


def test_the_recorder_keeps_the_last_max_spans():
    timing.clear()
    assert timing.spans() == []
    for i in range(timing.MAX_SPANS + 10):
        with timing.span("bound"):
            timing.count("i", i)
    kept = timing.spans()
    assert len(kept) == timing.MAX_SPANS
    assert kept[0].counters == {"i": 10} and kept[-1].counters == {"i": timing.MAX_SPANS + 9}
    timing.clear()
    assert timing.spans() == []


def test_a_span_never_synchronizes_the_device():
    def forbidden(*a, **kw):
        raise AssertionError("span synchronized the device")

    with mock.patch.object(torch.cuda, "synchronize", forbidden):
        with timing.span("nosync"):
            timing.count("k")
        with TimedBlock("cpu block", silent=True, device="cpu"):
            pass
    assert timing.spans()[-2].counters == {"k": 1}


def _counted(fn, *a, **kw):
    with timing.span("count.here"):
        out = fn(*a, **kw)
    return out, timing.spans()[-1].counters


@pytest.mark.parametrize("substeps", [1, 3])
def test_integrator_step_counters(substeps):
    t = torch.tensor([0.0, 0.1, 0.25, 0.3, 0.5], dtype=F64)
    q0 = torch.ones((2, 3), dtype=F64)
    _, c = _counted(ivp.rk4_solve, lambda t, q: -q, q0, t, substeps=substeps)
    assert c == {"rk4_steps": 4 * substeps}
    _, c = _counted(ivp.rk4_solve_np, lambda t, q: -q, np.ones(3), t.numpy(), substeps=substeps)
    assert c == {"rk4_steps": 4 * substeps}
    eye = torch.eye(3, dtype=F64)
    _, c = _counted(ivp.dirk2_solve, lambda j, q: -q, q0, t, jac=lambda j, q: -eye.expand(2, 3, 3),
                    substeps=substeps, newton_iters=3)
    assert c == {"dirk2_steps": 4 * substeps}


def test_a_library_load_is_a_span(tmp_path):
    """``ops.load_library`` opens ``ops.load_library`` around the build and
    the load, and the load runs inside it."""
    inside = []

    def cdll(path):
        inside.append(timing._stack()[-1].name)
        return path

    info = build.BuildInfo(tmp_path / "libx.so", "", 0.0)
    with mock.patch.object(build, "build", lambda name: info), \
            mock.patch.object(build.ctypes, "CDLL", cdll):
        with timing.span("load.here"):
            assert build.load_library.__wrapped__("x") == str(info.path)
    here, load = timing.spans()[-1], timing.spans()[-2]
    assert inside == ["ops.load_library"]
    assert load.name == "ops.load_library" and load.parent == here.id and load.counters == {}


def _search_problem():
    gen = torch.Generator().manual_seed(0)
    t = torch.linspace(0, 1, 20, dtype=F64)
    Y = torch.stack([torch.sin(6 * t), torch.cos(4 * t)])
    t_est = torch.linspace(0, 1, 12, dtype=F64)
    gps = fit_gaussian_processes(t_est, t, Y, n_restarts_optimizer=2, generator=gen,
                                 adam_steps=5, polish_iters=2)
    rom = GalerkinROM("cAH", 2, substeps=2)
    st = torch.stack([g.state_estimate for g in gps])
    fac = weighted_lstsq_fit(rom.data_matrix(st)[None],
                             torch.stack([g.sqrtW for g in gps])[:, None],
                             torch.stack([g.ddt_estimate for g in gps])[:, None])
    return fac, rom, st, t_est, gen


@pytest.mark.parametrize("kernel", [True, False], ids=["screen", "generic"])
def test_search_counts_slots_and_candidates(kernel):
    fac, rom, st, t_est, gen = _search_problem()
    results = []
    real = scipy.optimize.minimize_scalar

    def minimize(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    with mock.patch.object(regsearch.scipy.optimize, "minimize_scalar", minimize):
        with timing.span("search.here"):
            auto_regularize(fac, rom, st[:, 0], t_est, t_est, st, generator=gen,
                            grid=np.logspace(-16, 4, 81), ndraws=2, verbose=False,
                            use_kernel=kernel)
    spans = {s.name: s for s in timing.spans()[-3:]}
    # the generic objective's integrations add their steps beside these
    grid, refine = ({k: v for k, v in spans[name].counters.items() if k.startswith("search_")}
                    for name in ("search.grid", "search.refine"))
    assert spans["search.grid"].parent == spans["search.here"].id
    assert grid == {"search_slots": 96, "search_candidates": 81}  # 6 calls of 16
    nfev = results[0].nfev
    assert refine == {"search_slots": 16 * nfev, "search_candidates": nfev}


def _euler_run():
    cfg = EulerConfig(spatial_domain=np.linspace(0, 2, 41)[:-1],
                      time_domain=np.linspace(0, 0.09, 61),
                      gp_bounds=GPBounds(*BOUNDS, 8), reg_grid=np.logspace(-10, 4, 9))
    return pdes.run_euler((0.0, 0.06), 40, 0.01, 60, 3, ndraws=12, config=cfg, device="cpu",
                          verbose=False)


def _heat_run():
    cfg = HeatMultiConfig(spatial_domain=np.linspace(0, 1, 32), time_domain=np.linspace(0, 2, 11),
                          input_parameters=((-2, 0), (2, 2)), test_parameters=(1.5, 0.5),
                          gp_bounds=GPBounds(*BOUNDS, 8), reg_grid=np.logspace(-1, 3, 5),
                          fom_substeps=2, rom_substeps=2)
    return pdes_multi.run_heat_multi((0.0, 1.0), 12, 0.05, 16, 3, ndraws=12, config=cfg,
                                     device="cpu", verbose=False)


def _seird_run():
    cfg = SEIRDConfig(time_domain=np.linspace(0, 200, 11),
                      gp_bounds=GPBounds((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5), 8),
                      reg_grid=np.logspace(-16, 5, 8))
    return odes.run_seird((0.0, 90.0), 20, 0.10, 10, ndraws=12, config=cfg, device="cpu",
                          verbose=False)


RUNS = {"euler": (pdes, _euler_run), "heat": (pdes_multi, _heat_run), "seird": (odes, _seird_run)}
GRID = {"euler": 9, "heat": 5, "seird": 8}
TREE = {
    "euler": {"data": ["data.truth", "data.samples"], "pod": [], "gp_fit": ["gp.fit"],
              "regression": ["search.grid", "search.refine"],
              "ensemble": ["posterior.integrate"], "decompress": []},
    "heat": {"data": ["data.truth", "data.samples"], "pod": [], "gp_fit": ["gp.fit"],
             "regression": ["search.grid", "search.refine"],
             "ensemble": ["posterior.integrate"], "newparam": ["posterior.integrate"]},
    "seird": {"data": ["data.truth", "data.samples"], "gp_fit": ["gp.fit"],
              "regression": ["search.grid", "search.refine"],
              "ensemble": ["posterior.integrate"], "newic": ["posterior.integrate"]},
}


@pytest.fixture(scope="module", params=list(RUNS))
def traced_run(request):
    """A small run with the runner module's ``TimedBlock`` patched as the
    benchmark's instruments patch it: a subclass that stamps each stage
    and reads ``self._range.name``."""
    module, run = RUNS[request.param]
    seen = []
    base = module.TimedBlock

    class Recorded(base):
        def __enter__(self):
            out = base.__enter__(self)
            self._ns0 = time.time_ns()
            return out

        def __exit__(self, *exc):
            out = base.__exit__(self, *exc)
            seen.append((self._range.name, self._ns0, time.time_ns()))
            return out

    torch.set_num_threads(1)
    # A garbage collection between a span's close and the subclass's stamp
    # (~2 ms at generation 1 in a test process) would read as skew.
    gc.disable()
    try:
        with mock.patch.object(module, "TimedBlock", Recorded):
            res = run()
    finally:
        gc.enable()
    req = _root_request("experiment")
    return request.param, res, _mine(req), seen


def test_a_run_gives_the_span_tree(traced_run):
    which, res, spans, _ = traced_run
    (root,) = [s for s in spans.values() if s.parent is None]
    assert root.name == "experiment"
    stages = {s.name: s for s in _children(spans, root)}
    assert set(stages) == set(TREE[which])
    for stage, kids in TREE[which].items():
        assert sorted(s.name for s in _children(spans, stages[stage])) == sorted(kids)
    (fit,) = _children(spans, stages["gp_fit"])
    assert [s.name for s in sorted(_children(spans, fit), key=lambda s: s.start_ns)] == [
        "gp.screen", "gp.rerank", "gp.polish", "gp.final", "gp.estimates"]
    substeps = (res.model if which == "seird" else res.rom).substeps
    steps = substeps * (len(res.time_domain) - 1)
    key = "dirk2_steps" if which == "heat" else "rk4_steps"
    second = {"euler": (), "heat": ("newparam",), "seird": ("newic",)}[which]
    for stage in ("ensemble",) + second:
        (integrate,) = _children(spans, stages[stage])
        assert integrate.counters[key] == steps
    grid = next(s for s in _children(spans, stages["regression"]) if s.name == "search.grid")
    assert grid.counters["search_candidates"] == GRID[which]
    if which == "euler":
        assert _subtree_counter(spans, stages["data"], "rk4_steps") > 0
    elif which == "heat":  # the host truth solves add no device steps to a stage
        assert _subtree_counter(spans, stages["data"], "dirk2_steps") == 0
        assert stages["newparam"].counters == {}
    else:  # SEIRD's host solves count their steps: two truths, five sample solves
        truth, samples = (next(s for s in _children(spans, stages["data"]) if s.name == n)
                          for n in ("data.truth", "data.samples"))
        assert truth.counters["rk4_steps"] == 2 * steps
        assert samples.counters["rk4_steps"] == 5 * substeps * (res.sample_times.shape[1] - 1)


def test_only_a_parametric_search_maps_operators_in_a_span(traced_run):
    """SEIRD's search opens ``search.operator_map`` once an objective call,
    inside the grid's and the refinement's spans; its two ensembles count
    2 (k - 1) 8 RK4 steps. The ROM searches open none."""
    which, res, spans, _ = traced_run
    maps = [s for s in spans.values() if s.name == "search.operator_map"]
    if which != "seird":
        assert maps == []
        return
    (root,) = [s for s in spans.values() if s.parent is None]
    stages = {s.name: s for s in _children(spans, root)}
    phases = {s.name: s for s in _children(spans, stages["regression"])}
    by_parent = {name: sum(s.parent == p.id for s in maps) for name, p in phases.items()}
    assert by_parent == {"search.grid": 1,
                         "search.refine": phases["search.refine"].counters["search_candidates"]}
    assert all(s.counters == {} for s in maps)
    steps = sum(_subtree_counter(spans, stages[n], "rk4_steps") for n in ("ensemble", "newic"))
    assert steps == 2 * (len(res.time_domain) - 1) * 8


def test_stage_seconds_equal_their_stage_spans(traced_run):
    _, res, spans, _ = traced_run
    by_name = {s.name: s for s in spans.values() if s.name in res.stage_seconds}
    assert set(by_name) == set(res.stage_seconds)
    for name, seconds in res.stage_seconds.items():
        s = by_name[name]
        assert abs((s.end_ns - s.start_ns) / 1e9 - seconds) < 1e-3


def test_a_harness_style_patch_still_sees_every_stage(traced_run):
    """Every stage reaches the patched subclass, and each stage span lies
    within 1 ms of the subclass's own stamps."""
    which, _, spans, seen = traced_run
    assert [name for name, _, _ in seen] == list(TREE[which])
    for name, lo, hi in seen:
        (s,) = [s for s in spans.values() if s.name == name]
        assert abs(s.start_ns - lo) < 1_000_000 and abs(s.end_ns - hi) < 1_000_000
