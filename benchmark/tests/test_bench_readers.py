"""The per-layer readers and the trace's arithmetic on synthetic profiler
events, and the frozen counts against hand counts at small r."""

import pytest
import torch

from benchmark.counts import device_time, screens
from benchmark.harness import drive, spec
from benchmark.harness.trace import DeviceTrace, _EventsView
from benchmark.tests import _tiny

ROOT = _tiny.ROOT


def _readers():
    s = spec.load(ROOT)
    return {m["name"]: spec.load_reader(ROOT / "benchmark" / "metrics" / f"{m['name']}.py", m)
            for m in s["per_layer"]}


def _trace(ops, window):
    t = DeviceTrace()
    t.ops = sorted(ops, key=lambda op: op[1])
    t.window_ns = window
    return t


def _state(trace=None):
    return {
        "experiments": [
            {"stage_seconds": {"data": 2.0, "gp_fit": 0.5, "regression": 0.25,
                               "ensemble": 1.0, "decompress": 0.5}, "launches": 60},
            {"stage_seconds": {"data": 4.0, "gp_fit": 1.5, "regression": 0.75,
                               "ensemble": 2.0, "newparam": 3.0}, "launches": 58},
        ],
        "warmup": {"fit_s": 7.5, "screen_s": 0.1},
        "screens": [{"kernel": "quadratic", "bound_ms": 0.5},
                    {"kernel": "quadratic", "bound_ms": 0.25}],
        "stages": [], "trace": trace, "window_s": 10.0,
    }


def test_stage_readers_average_the_experiments():
    r = _readers()
    state = _state()
    assert r["data_s"].read(state) == pytest.approx(3.0)
    assert r["gp_fit_s"].read(state) == pytest.approx(1.0)
    assert r["regression_s"].read(state) == pytest.approx(0.5)
    assert r["ensemble_s"].read(state) == pytest.approx((1.5 + 5.0) / 2)
    assert r["objective_evals"].read(state) == pytest.approx(29.5)
    assert r["first_fit_s"].read(state) == 7.5


def test_readers_find_nothing_without_experiments_or_trace():
    r = _readers()
    empty = dict(_state(), experiments=[], screens=[])
    for name in ("data_s", "gp_fit_s", "regression_s", "ensemble_s", "objective_evals"):
        assert r[name].read(empty) is None
    for name in ("quadratic_screen_roofline", "cahbn_screen_roofline", "device_idle"):
        assert r[name].read(_state()) is None


def test_roofline_and_idle_from_synthetic_events():
    r = _readers()
    ms = 1_000_000
    ops = [
        ("void (anonymous namespace)::quadratic_screen_kernel<6>(...)", 0, 3 * ms),
        ("mean_error_kernel(...)", 3 * ms, 4 * ms),
        ("elementwise_kernel", 2 * ms, 6 * ms),  # overlaps the first two
        ("elementwise_kernel", 8 * ms, 9 * ms),
    ]
    state = _state(_trace(ops, (0, 10 * ms)))
    # 0.75 ms of bound over 4 ms of the kernels' device time
    assert r["quadratic_screen_roofline"].read(state) == pytest.approx(100 * 0.75 / 4)
    assert r["cahbn_screen_roofline"].read(state) is None  # no kernel B launch
    # busy: [0, 6] and [8, 9] ms of 10 ms
    assert r["device_idle"].read(state) == pytest.approx(30.0)


def test_breakdown_labels_gaps_by_the_enclosing_stage():
    ms = 1_000_000
    t = _trace([("a", 0, ms), ("b", 3 * ms, 4 * ms), ("a", 4 * ms, 5 * ms),
                ("c", 9 * ms, 10 * ms)], (0, 10 * ms))
    stages = [("data", 0, 5 * ms), ("ensemble", 5 * ms, 10 * ms)]
    out = t.breakdown(stages)
    assert out["device_ops"][0] == ["a", 0.002]
    assert out["idle_gaps"] == [["ensemble", 0.004], ["data", 0.002]]
    assert t.busy_s == pytest.approx(0.004)
    busy = t.stage_busy(stages)
    assert busy["data"][:2] == (3, pytest.approx(3.0))
    assert busy["ensemble"][:2] == (1, pytest.approx(1.0))


def test_stage_device_time_is_the_frozen_union():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    view = _EventsView([("screen_kernel<5>", 0, 10), ("x", 5, 20), ("y", 30, 40)],
                       [("s", 0, 35)])
    out = device_time.stage_device_time(view, ["s"])
    assert out["s"] == (3, 30 / 1e6, 1, 10 / 1e6)
    assert device_time.busy_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert device_time.idle_gaps([(0, 10), (5, 20), (30, 40)]) == [(20, 30)]
    assert cuda != cpu


def test_counts_match_hand_counts_at_small_r():
    # r = 1: one product, rhs 1 + 2 (1 + 1) = 5; an RK4 step 4 * 5 + 13 = 33
    assert screens.quadratic_flops(1, 1, 2, 1) == 33
    # r = 2: 3 products, rhs 3 + 4 (2 + 3) = 23; a step 92 + 26 = 118
    assert screens.quadratic_flops(1, 2, 2, 1) == 118
    assert screens.quadratic_flops(20, 2, 11, 4) == 20 * 10 * 4 * 118
    # r = nu = 1, one Newton step: rhs 10, Newton matrix 8, elimination
    # and back substitution 2, update 4: 24; substep 10 + 2 * 24 + 7 = 65
    assert screens.cahbn_flops(1, 1, 1, 2, 1, 1) == 65
    a = torch.zeros(3, 4)
    assert screens.screen_bytes([a, None, torch.zeros(2, dtype=torch.float64)], 5, 2) == \
        48 + 16 + 5 + 8
    assert screens.bound_ms(67e12, 1.0) == (1000.0, "operations")
    assert screens.bound_ms(1.0, 3.35e12) == (1000.0, "bytes")


def test_launch_bound_counts_every_problem():
    f32 = torch.float32
    L, N, r, k = 5, 40, 5, 9
    a = {"Ohat": torch.zeros(N, r, 33, dtype=f32), "q0": torch.zeros(L, r, dtype=f32),
         "t_eval": torch.zeros(k, dtype=f32), "shift": torch.zeros(L, r, dtype=f32),
         "limits": torch.zeros(L, r, dtype=f32), "u_stages": torch.zeros(L, 96, 2, dtype=f32),
         "snapshots": None, "nd": 20, "substeps": 4, "newton_iters": 6, "track_error": True}
    out = drive.launch_bound("cahbn", a)
    assert out["flops"] == L * screens.cahbn_flops(N, r, 2, k, 4, 6)
    inputs = sum(a[x].numel() * 4 for x in ("Ohat", "q0", "t_eval", "shift", "limits",
                                               "u_stages"))
    assert out["bytes"] == inputs + L * N + 4 * L * 2
    assert out["bound_ms"] == screens.bound_ms(out["flops"], out["bytes"])[0]
    assert out["bound_by"] in ("operations", "bytes")
