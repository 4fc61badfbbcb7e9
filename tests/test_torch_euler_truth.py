"""The Euler truth solve's two paths on the CPU: ``Euler.solve`` takes the
``rk4_solve`` loop here (the fused kernel of ``ops/euler_truth.py`` runs
only on a card; ``tests/test_torch_euler_truth_cuda.py`` holds it against
the loop there), counts its steps, and the kernel's wrapper refuses what
the kernel does not take before it builds anything. No JAX, no card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.models import Euler
from gp_bayesopinf_torch.ops import build
from gp_bayesopinf_torch.ops import euler_truth as et
from gp_bayesopinf_torch.solve.ivp import rk4_solve
from gp_bayesopinf_torch.utils import timing

CSRC = Path(__file__).resolve().parents[1] / "gp_bayesopinf_torch" / "csrc"
KNOTS = (22.0, 20.0, 24.0, 95.0, 105.0, 100.0)


def _model(nx):
    return Euler(np.linspace(0.0, 2.0, nx + 1)[:-1])


@pytest.mark.parametrize("nx,times", [
    (40, np.linspace(0.0, 0.015, 11)),  # uniform, as the prediction grid
    (60, np.array([0.0, 0.001, 0.0013, 0.004, 0.006])),  # sorted samples: the CFL count
])
def test_cpu_solve_is_the_rk4_loop(nx, times):
    """On the CPU ``Euler.solve`` is ``rk4_solve`` on ``Euler.derivative``
    with the CFL substep count, bit for bit."""
    model = _model(nx)
    ics = model.initial_conditions(KNOTS, device="cpu")
    used = {}

    def spy(rhs, q0, t, substeps):
        used["substeps"] = substeps
        return rk4_solve(rhs, q0, t, substeps=substeps)

    out = model.solve(ics, times)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("gp_bayesopinf_torch.models.euler.rk4_solve", spy)
        model.solve(ics, times)
    direct = model.lift(rk4_solve(model.derivative, model.unlift(ics),
                                  torch.as_tensor(times), substeps=used["substeps"]))
    assert used["substeps"] >= model.substeps
    assert out.shape == (3 * nx, len(times))
    assert torch.equal(out, direct)


def test_cpu_solve_counts_loop_steps_only():
    model = _model(30)
    ics = model.initial_conditions(KNOTS, device="cpu")
    times = np.linspace(0.0, 0.01, 6)
    with timing.span("probe.euler_truth"):
        model.solve(ics, times)
    sp = [s for s in timing.spans() if s.name == "probe.euler_truth"][-1]
    assert sp.counters["rk4_steps"] % 5 == 0 and sp.counters["rk4_steps"] >= 5 * model.substeps
    assert "rk4_fused_steps" not in sp.counters


def _no_build(*_):
    raise AssertionError("the wrapper reached the build")


def _q0(nx=8, dtype=torch.float64):
    return torch.ones(3 * nx, dtype=dtype)


@pytest.mark.parametrize("q0,t,substeps,match", [
    (_q0(), torch.linspace(0, 1, 3, dtype=torch.float64), 2, "CUDA"),  # a CPU tensor
    (_q0(dtype=torch.float32), torch.linspace(0, 1, 3, dtype=torch.float64), 2, "float64"),
    (_q0(), torch.linspace(0, 1, 3), 2, "t_eval must be float64"),
    (torch.ones(3 * 8, 2, dtype=torch.float64)[:, 0], torch.linspace(0, 1, 3, dtype=torch.float64),
     2, "contiguous"),
    (torch.ones(2, 24, dtype=torch.float64), torch.linspace(0, 1, 3, dtype=torch.float64), 2,
     "one-dimensional"),
    (torch.ones(25, dtype=torch.float64), torch.linspace(0, 1, 3, dtype=torch.float64), 2, "3 nx"),
    (_q0(1), torch.linspace(0, 1, 3, dtype=torch.float64), 2, "nx >= 2"),
    (_q0(), torch.linspace(0, 1, 3, dtype=torch.float64), 0, "substeps"),
])
def test_wrapper_refuses_before_building(monkeypatch, q0, t, substeps, match):
    monkeypatch.setattr(build, "build", _no_build)
    monkeypatch.setattr(build, "load_library", _no_build)
    before = et.launches
    with pytest.raises(ValueError, match=match):
        et.euler_rk4_cuda(q0, t, substeps, 0.01, 0.4)
    assert et.launches == before


def test_max_nx_is_the_sources():
    """The wrapper's ``MAX_NX`` (past it the kernel needs a scratch) and
    ``WIDE_SCRATCH`` (that scratch's doubles a cell) are the C entry's,
    read from the source."""
    src = (CSRC / "euler_truth.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["MAX_THREADS"] * consts["MAX_CPT"] == et.MAX_NX == 2048
    assert "MAX_NX = MAX_THREADS * MAX_CPT" in src
    assert consts["WIDE_SCRATCH"] == et.WIDE_SCRATCH == 15
    assert "nx > MAX_NX && scratch == nullptr" in src
