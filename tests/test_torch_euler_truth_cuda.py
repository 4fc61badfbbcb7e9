"""The fused Euler truth solve (``csrc/euler_truth.cu`` through
``ops/euler_truth.py``) against the ``rk4_solve`` loop on the card, bit for
bit. Every test here needs a CUDA device and skips without one.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_euler_truth_cuda.py
"""

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.models import Euler
from gp_bayesopinf_torch.models import euler as euler_module
from gp_bayesopinf_torch.ops import euler_truth as et
from gp_bayesopinf_torch.pipeline.configs import EulerConfig
from gp_bayesopinf_torch.solve.ivp import CLAMP, rk4_solve
from gp_bayesopinf_torch.utils import timing
from gp_bayesopinf_torch.utils.keys import stage_generators

KNOTS = (22.0, 20.0, 24.0, 95.0, 105.0, 100.0)
#: The first data seed of the benchmark's ex1a pool.
POOL_SEED = 1216390044


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def same(a, b):
    """Equal to the bit where not NaN, and NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def solve_both(model, ics, times):
    """``model.solve`` through the kernel, then through the loop (the
    kernel's wrapper swapped for ``rk4_solve`` at the substeps it gets);
    returns both, the kernel launches of the first and the counters of a
    span around it."""
    before = et.launches
    with timing.span("probe.euler_truth_cuda"):
        fused = model.solve(ics, times)
    torch.cuda.synchronize()
    launched = et.launches - before
    counters = [s for s in timing.spans() if s.name == "probe.euler_truth_cuda"][-1].counters

    def loop(q0, t, substeps, dx, gamma_minus_1):
        return rk4_solve(model.derivative, q0, t, substeps=substeps)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(euler_module, "euler_rk4_cuda", loop)
        looped = model.solve(ics, times)
    return fused, looped, launched, counters


def ex1a_sample_times(seed):
    """``run_euler``'s 200 sorted sample times over [0, 0.06] at data seed
    ``seed``."""
    gen = stage_generators(seed, "cuda")["sample"]
    u = torch.rand(200, generator=gen, dtype=torch.float64, device="cuda")
    t = np.sort((0.06 * u).cpu().numpy())
    t[0], t[-1] = 0.0, 0.06
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["prediction", "samples"])
def test_ex1a_solves_equal_the_loop(cuda, grid):
    """ex1a's two solves (nx 200): the 401 prediction times and one pool
    seed's 200 sorted sample times."""
    cfg = EulerConfig()
    model = Euler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    ics = model.initial_conditions(cfg.init_params, device=cuda)
    times = np.asarray(cfg.time_domain) if grid == "prediction" else ex1a_sample_times(POOL_SEED)
    fused, looped, launched, counters = solve_both(model, ics, times)
    assert launched == 1
    assert fused.shape == (600, len(times))
    assert torch.equal(fused, looped)
    assert counters["rk4_fused_steps"] == counters["rk4_steps"] > 0
    assert counters["rk4_steps"] % (len(times) - 1) == 0


@pytest.mark.gpu
def test_nx_2000_equals_the_loop(cuda):
    """``scaled``'s Euler source width (n_space 6000): two cells a thread."""
    model = Euler(np.linspace(0.0, 2.0, 2001)[:-1])
    ics = model.initial_conditions(KNOTS, device=cuda)
    fused, looped, launched, _ = solve_both(model, ics, np.linspace(0.0, 0.004, 21))
    assert launched == 1
    assert torch.equal(fused, looped)


@pytest.mark.gpu
@pytest.mark.parametrize("nx", [2049, 3000])
def test_past_the_registers_equals_the_loop(cuda, nx):
    """Wider than ``MAX_NX`` (n_space 9000 at nx 3000): the kernel that
    keeps the state in a global scratch."""
    model = Euler(np.linspace(0.0, 2.0, nx + 1)[:-1])
    ics = model.initial_conditions(KNOTS, device=cuda)
    fused, looped, launched, counters = solve_both(model, ics, np.linspace(0.0, 0.003, 13))
    assert launched == 1
    assert torch.equal(fused, looped)
    assert counters["rk4_fused_steps"] == counters["rk4_steps"] > 0


@pytest.mark.gpu
def test_a_float32_state_on_the_card_is_refused(cuda):
    """On the card ``Euler.solve`` takes the kernel for every dtype: a
    float32 initial condition raises, and the loop does not run it."""
    cfg = EulerConfig()
    model = Euler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    ics = model.initial_conditions(cfg.init_params, device=cuda, dtype=torch.float32)
    before = et.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(euler_module, "rk4_solve", lambda *a, **kw: pytest.fail("the loop ran"))
        with pytest.raises(ValueError, match="float64"):
            model.solve(ics, np.asarray(cfg.time_domain))
    assert et.launches == before


def _conservative(nx, device):
    model = Euler(np.linspace(0.0, 2.0, nx + 1)[:-1])
    q0 = model.unlift(model.initial_conditions(KNOTS, device=device))
    return model, q0.clone()


@pytest.mark.gpu
@pytest.mark.parametrize("nx", [200, 3000])
def test_blow_up_is_clamped_as_the_loop_clamps(cuda, nx):
    """Two substeps where the CFL rule asks for many, and a momentum spike:
    the state diverges to the clamp in both."""
    model, q0 = _conservative(nx, cuda)
    q0[nx + 3] = 1e9
    t = torch.linspace(0.0, 0.05, 30, dtype=torch.float64, device=cuda)
    fused = et.euler_rk4_cuda(q0, t, 2, model.dx, model.gamma - 1.0)
    looped = rk4_solve(model.derivative, q0, t, substeps=2)
    assert bool((fused.abs() == CLAMP).any())
    assert same(fused, looped)


@pytest.mark.gpu
@pytest.mark.parametrize("nx", [200, 2000, 3000])
def test_a_nan_cell_spreads_as_in_the_loop(cuda, nx):
    model, q0 = _conservative(nx, cuda)
    q0[2 * nx + 7] = float("nan")
    t = torch.linspace(0.0, 0.002, 11, dtype=torch.float64, device=cuda)
    fused = et.euler_rk4_cuda(q0, t, 12, model.dx, model.gamma - 1.0)
    looped = rk4_solve(model.derivative, q0, t, substeps=12)
    assert int(torch.isnan(fused[:, -1]).sum()) > 3  # it spread
    assert same(fused, looped)


@pytest.mark.gpu
def test_launches_count_and_refusals(cuda):
    model, q0 = _conservative(200, cuda)
    t = torch.linspace(0.0, 0.002, 5, dtype=torch.float64, device=cuda)
    before = et.launches
    for _ in range(3):
        et.euler_rk4_cuda(q0, t, 12, model.dx, model.gamma - 1.0)
    torch.cuda.synchronize()
    assert et.launches == before + 3
    refused = [
        (q0.cpu(), t),  # not on the card
        (q0.float(), t),
        (q0, t.float()),
        (torch.stack([q0, q0], dim=1)[:, 0], t),  # not contiguous
        (q0[:-1].contiguous(), t),  # not 3 nx
        (torch.ones(3, dtype=torch.float64, device=cuda), t),  # nx 1
        (q0, t.cpu()),  # t_eval on another device
    ]
    for a, b in refused:
        with pytest.raises(ValueError):
            et.euler_rk4_cuda(a, b, 12, model.dx, model.gamma - 1.0)
    with pytest.raises(ValueError):
        et.euler_rk4_cuda(q0, t, 0, model.dx, model.gamma - 1.0)
    assert et.launches == before + 3
