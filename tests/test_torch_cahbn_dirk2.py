"""The fused SDIRK2 integration of "cAHBN" ROM draws (``csrc/cahbn_screen.cu::
cahbn_dirk2_kernel`` through ``ops/cahbn_dirk2.py``) and its route in
``GalerkinROM.predict`` (``rom.model.fused_dirk2``).

On a card the kernel is held against ``dirk2_solve`` there: every stable
draw to 1e-12 of its largest state (the loop solves its Newton systems by a
pivoted LU, the kernel without pivoting, so the two agree to roundoff, not
to the bit), with identical ``finite_mask`` and ``stability_mask``. Draws
that the envelope rejects are held by the masks alone: a state grown far
past its envelope leaves Newton unconverged, and the two roundings part
there. On the CPU ``predict`` keeps ``dirk2_solve``, reached through
``rom.model``'s own name, and counts no fused steps.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cahbn_dirk2.py
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.ops import build
from gp_bayesopinf_torch.ops import cahbn_dirk2 as cd
from gp_bayesopinf_torch.ops.cahbn_screen import input_stage_times
from gp_bayesopinf_torch.pipeline.configs import HeatMultiConfig
from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory, stacked_input_func
from gp_bayesopinf_torch.rom import model as rom_model
from gp_bayesopinf_torch.rom.model import GalerkinROM, fused_dirk2, input_problems
from gp_bayesopinf_torch.solve.ivp import CLAMP, dirk2_solve, finite_mask, stability_mask
from gp_bayesopinf_torch.utils import timing

CSRC = Path(__file__).resolve().parents[1] / "gp_bayesopinf_torch" / "csrc"
F64 = torch.float64
#: The envelope of the synthetic draws: shift 0, limit 10 on every mode.
LIMIT = 10.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def ex3_like(rng, L, nd, r=5, nu=2, plant=True):
    """(L, nd, r, d) operators as ``chip_smoke.py::cahbn_case`` builds them,
    a set for each trajectory: decaying draws well inside the envelope and,
    with ``plant``, in trajectory 0 a block driven to the clamp (+60 I)
    and one past the envelope (+26 I), and a NaN operator in the last
    trajectory's draw 3. The two planted blocks grow linearly (their
    quadratic and input terms zero): a draw that its quadratic term blows up
    in finite time leaves Newton unconverged near the blow-up, where any two
    roundings part (the loop on the CPU and on the card too), so whether it
    stays under the divergence sentinel is not reproducible."""
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    O = 0.3 * rng.standard_normal((L, nd, r, d))
    O[..., 1 : 1 + r] += -20.0 * np.eye(r)
    O[..., 1 + r :] *= 0.1
    if plant:
        O[0, -4:, :, 1 : 1 + r] += 60.0 * np.eye(r)
        O[0, -8:-4, :, 1 : 1 + r] += 26.0 * np.eye(r)
        O[0, -8:, :, 1 + r :] = 0.0
        O[-1, 3, 0, 0] = np.nan
    q0 = 0.5 * rng.standard_normal((L, 1, r))
    return torch.as_tensor(O), torch.as_tensor(q0)


def inputs(L, nu, device):
    """The ex3 training inputs of L trajectories, (L, 1, nu, n) a call;
    at nu 1 the first channel."""
    params = HeatMultiConfig().input_parameters[:L]
    both = stacked_input_func(params, device)
    return lambda t: both(t)[..., :nu, :]


def both_ways(rom, O, q0, t, input_func):
    """``predict`` on the card (the kernel) and ``dirk2_solve`` on the
    same tensors, with the kernel launches and the counters of a span
    around the first."""
    before = cd.launches
    with timing.span("probe.dirk2_fused"):
        fused = rom.predict(O, q0, t, input_func)
    torch.cuda.synchronize()
    launched = cd.launches - before
    counters = [s for s in timing.spans() if s.name == "probe.dirk2_fused"][-1].counters
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rom_model, "fused_dirk2", lambda *a: False)
        looped = rom.predict(O, q0, t, input_func)
    return fused, looped, launched, counters


def held(fused, looped):
    """Masks identical; the largest gap of a stable draw over its largest
    state. Returns (gap, stable draws, finite draws)."""
    assert torch.equal(torch.isnan(fused), torch.isnan(looped))
    assert torch.equal(finite_mask(fused), finite_mask(looped))
    shift = torch.zeros(fused.shape[-2], dtype=F64, device=fused.device)
    limits = torch.full_like(shift, LIMIT)
    keep = stability_mask(fused, shift, limits)
    assert torch.equal(keep, stability_mask(looped, shift, limits))
    gap = ((fused - looped).abs().amax((-2, -1)) / looped.abs().amax((-2, -1)))[keep]
    return float(gap.max()) if gap.numel() else 0.0, int(keep.sum()), int(finite_mask(fused).sum())


@pytest.mark.gpu
def test_ex3_ensemble_agrees_with_dirk2_solve(cuda):
    """Heat ex3's ensemble shape: 5 trajectories x 600 draws, r 5, nu 2,
    500 output times over [0, 2], 4 substeps, one launch."""
    O, q0 = (x.to(cuda) for x in ex3_like(np.random.default_rng(19), 5, 600))
    t = torch.as_tensor(HeatMultiConfig().time_domain, device=cuda)
    rom = GalerkinROM("cAHBN", 5, 2, ivp_method="dirk2", substeps=4)
    fused, looped, launched, counters = both_ways(rom, O, q0, t, inputs(5, 2, cuda))
    assert launched == 1
    assert fused.shape == looped.shape == (5, 600, 5, 500)
    assert torch.equal(fused[..., 0], q0.expand(5, 600, 5))
    gap, stable, finite = held(fused, looped)
    assert gap <= 1e-12
    assert stable >= 5 * 600 - 9 and finite < 5 * 600  # the planted draws fall out
    assert counters["dirk2_steps"] == counters["dirk2_fused_steps"] == 499 * 4


@pytest.mark.gpu
def test_ex3_newparam_shape_agrees_with_dirk2_solve(cuda):
    """The generalization ensemble: 600 draws at one input pair, (r,) q0."""
    O, q0 = (x.to(cuda) for x in ex3_like(np.random.default_rng(20), 1, 600, plant=False))
    t = torch.as_tensor(HeatMultiConfig().time_domain, device=cuda)
    rom = GalerkinROM("cAHBN", 5, 2, ivp_method="dirk2", substeps=4)
    u = input_func_factory(HeatMultiConfig().test_parameters)
    fused, looped, launched, _ = both_ways(rom, O[0], q0[0, 0], t, u)
    assert launched == 1 and fused.shape == (600, 5, 500)
    gap, stable, _ = held(fused, looped)
    assert gap <= 1e-12 and stable == 600


@pytest.mark.gpu
@pytest.mark.parametrize("nu", [1, 2])
@pytest.mark.parametrize("r", range(1, 9))
def test_every_instance_agrees_with_dirk2_solve(cuda, r, nu):
    O, q0 = (x.to(cuda) for x in ex3_like(np.random.default_rng(100 * r + nu), 2, 9, r, nu))
    t = torch.linspace(0.0, 1.0, 21, dtype=F64, device=cuda)
    rom = GalerkinROM("cAHBN", r, nu, ivp_method="dirk2", substeps=2)
    fused, looped, launched, _ = both_ways(rom, O, q0, t, inputs(2, nu, cuda))
    assert launched == 1
    gap, stable, _ = held(fused, looped)
    assert gap <= 1e-12 and stable >= 18 - 9


@pytest.mark.gpu
def test_a_nan_draw_stays_nan_and_leaves_the_others(cuda):
    O, q0 = (x.to(cuda) for x in ex3_like(np.random.default_rng(3), 2, 40, plant=False))
    t = torch.linspace(0.0, 2.0, 60, dtype=F64, device=cuda)
    rom = GalerkinROM("cAHBN", 5, 2, ivp_method="dirk2", substeps=4)
    u = inputs(2, 2, cuda)
    clean = rom.predict(O, q0, t, u)
    bad = O.clone()
    bad[1, 7, 2, 9] = float("nan")
    fused, looped, _, _ = both_ways(rom, bad, q0, t, u)
    assert bool(torch.isnan(fused[1, 7, :, 1:]).all()) and not bool(torch.isnan(fused[..., 0]).any())
    others = torch.ones(2, 40, dtype=torch.bool, device=cuda)
    others[1, 7] = False
    assert torch.equal(fused[others], clean[others])  # bit for bit
    assert torch.equal(torch.isnan(fused), torch.isnan(looped))


@pytest.mark.gpu
def test_a_blow_up_is_clamped_as_dirk2_solve_clamps_it(cuda):
    """A linear draw with a growth rate of 60 passes 1e18 and sits at the
    clamp; the loop gives the same states to roundoff."""
    O, q0 = (x.to(cuda) for x in ex3_like(np.random.default_rng(4), 1, 8, plant=False))
    O[0, 5, :, 1 + 5 :] = 0.0  # no quadratic or input terms: linear, not chaotic
    O[0, 5, :, 1 : 1 + 5] = 60.0 * torch.eye(5, dtype=F64, device=cuda)
    t = torch.linspace(0.0, 1.0, 101, dtype=F64, device=cuda)
    rom = GalerkinROM("cAHBN", 5, 2, ivp_method="dirk2", substeps=4)
    fused, looped, _, _ = both_ways(rom, O, q0, t, inputs(1, 2, cuda))
    at_clamp = fused.abs() == CLAMP
    assert bool(at_clamp[0, 5, :, -1].all()) and not bool(at_clamp[0, :5].any())
    assert torch.equal(at_clamp, looped.abs() == CLAMP)
    assert float(((fused - looped).abs() / looped.abs().clamp_min(1e-300)).max()) <= 1e-12


@pytest.mark.gpu
def test_float32_and_unsupported_shapes_take_dirk2_solve(cuda, monkeypatch):
    """On the card a float32 draw, r 9, nu 3 and a "cAH" ROM reach
    ``rom.model.dirk2_solve``; the wrapper itself refuses them."""
    seen = []

    def spy(*a, **kw):
        seen.append(1)
        return dirk2_solve(*a, **kw)

    monkeypatch.setattr(rom_model, "dirk2_solve", spy)
    t = torch.linspace(0.0, 0.5, 5, dtype=F64, device=cuda)
    before = cd.launches
    for r, nu, dtype in [(5, 2, torch.float32), (9, 2, F64), (3, 3, F64)]:
        O, q0 = (x.to(cuda, dtype) for x in ex3_like(np.random.default_rng(r), 1, 4, r, nu, False))
        u = lambda times, nu=nu: torch.sin(times).expand(1, 1, nu, -1)
        rom = GalerkinROM("cAHBN", r, nu, ivp_method="dirk2", substeps=2)
        rom.predict(O, q0, t.to(dtype), u)
        with pytest.raises(ValueError):
            cd.cahbn_dirk2_cuda(O[0].contiguous(), q0.expand(1, 4, r)[0].contiguous(), t,
                                torch.zeros(1, 4 * 2 * 3, nu, dtype=dtype, device=cuda), 2)
    cah = GalerkinROM("cAH", 2, 0, ivp_method="dirk2", substeps=2)
    O = 0.1 * torch.randn(4, 2, 6, dtype=F64, device=cuda)
    O[..., 1:3] -= torch.eye(2, dtype=F64, device=cuda)
    cah.predict(O, torch.ones(2, dtype=F64, device=cuda), t)
    torch.cuda.synchronize()
    assert len(seen) == 4 and cd.launches == before


@pytest.mark.gpu
def test_steps_are_counted_once_a_call(cuda):
    O, q0 = (x.to(cuda) for x in ex3_like(np.random.default_rng(5), 2, 6, plant=False))
    t = torch.linspace(0.0, 1.0, 7, dtype=F64, device=cuda)
    table = input_problems(inputs(2, 2, cuda)(input_stage_times(t, 3)).movedim(-1, 0),
                           O.shape[:-2])[0]
    before = cd.launches
    with timing.span("probe.dirk2_count"):
        cd.cahbn_dirk2_cuda(O.reshape(12, 5, 33).contiguous(),
                            q0.expand(2, 6, 5).reshape(12, 5).contiguous(), t, table, 3)
    c = [s for s in timing.spans() if s.name == "probe.dirk2_count"][-1].counters
    assert c == {"dirk2_steps": 18, "dirk2_fused_steps": 18}
    assert cd.launches == before + 1


# -- the CPU ---------------------------------------------------------------


def _cpu_case(L=2, nd=3, r=3, nu=2, k=5):
    O, q0 = ex3_like(np.random.default_rng(7), L, nd, r, nu, plant=False)
    t = torch.linspace(0.0, 0.4, k, dtype=F64)
    return GalerkinROM("cAHBN", r, nu, ivp_method="dirk2", substeps=2), O, q0, t, inputs(L, nu, "cpu")


def test_cpu_tensors_reach_rom_model_dirk2_solve(monkeypatch):
    """A mock planted at ``gp_bayesopinf_torch.rom.model:dirk2_solve`` (where
    the benchmark's check plants its faults) sees every CPU call."""
    rom, O, q0, t, u = _cpu_case()
    want = rom.predict(O, q0, t, u)
    calls = []

    def frozen(rhs, q0, t_eval, *args, **kwargs):
        calls.append(q0.shape)
        return q0[..., None].expand(*q0.shape, t_eval.shape[0]).clone()

    monkeypatch.setattr("gp_bayesopinf_torch.rom.model.dirk2_solve", frozen)
    got = rom.predict(O, q0, t, u)
    rom.predict(O[0], q0[0, 0], t, input_func_factory((1.0, -1.0)))
    assert calls == [(2, 3, 3), (3, 3)]
    assert torch.equal(got[..., -1], q0.expand(2, 3, 3)) and not torch.equal(want, got)


def test_cpu_counts_no_fused_steps():
    rom, O, q0, t, u = _cpu_case()
    before = cd.launches
    with timing.span("probe.dirk2_cpu"):
        rom.predict(O, q0, t, u)
    c = [s for s in timing.spans() if s.name == "probe.dirk2_cpu"][-1].counters
    assert c == {"dirk2_steps": 4 * 2}
    assert cd.launches == before


def _like(device="cuda", dtype=F64, shape=(5, 600, 5, 33)):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=torch.Size(shape))


@pytest.mark.parametrize("structure,device,dtype,r,nu,q_device,q_dtype,u_device,taken", [
    ("cAHBN", "cuda", F64, 5, 2, "cuda", F64, "cuda", True),  # heat ex3
    ("cAHBN", "cuda", F64, 1, 1, "cuda", F64, "cuda", True),
    ("cAHBN", "cuda", F64, 8, 2, "cuda", F64, "cuda", True),
    ("cAHBN", "cpu", F64, 5, 2, "cpu", F64, "cpu", False),  # every CPU tensor
    ("cAHBN", "cuda", torch.float32, 5, 2, "cuda", torch.float32, "cuda", False),
    ("cAHBN", "cuda", F64, 5, 2, "cuda", torch.float32, "cuda", False),
    ("cAHBN", "cuda", F64, 9, 2, "cuda", F64, "cuda", False),  # no instance
    ("cAHBN", "cuda", F64, 5, 3, "cuda", F64, "cuda", False),
    ("cAHBN", "cuda", F64, 5, 2, "cpu", F64, "cuda", False),  # tensors on two devices
    ("cAHBN", "cuda", F64, 5, 2, "cuda", F64, "cpu", False),
    ("cAHB", "cuda", F64, 5, 2, "cuda", F64, "cuda", False),  # other structures
    ("cAHN", "cuda", F64, 5, 2, "cuda", F64, "cuda", False),
    ("cAH", "cuda", F64, 5, 2, "cuda", F64, "cuda", False),
])
def test_route_decisions(structure, device, dtype, r, nu, q_device, q_dtype, u_device, taken):
    O = _like(device, dtype, (5, 600, r, 1 + r + r * (r + 1) // 2 + nu + nu * r))
    q0 = _like(q_device, q_dtype, (5, 600, r))
    u = _like(u_device, F64, (1996 * 3, 5, 1, nu))
    assert fused_dirk2(structure, O, q0, u) is taken


def test_route_needs_a_draw():
    assert not fused_dirk2("cAHBN", _like(shape=(0, 5, 33)), _like(shape=(0, 5)),
                           _like(shape=(12, 2)))


@pytest.mark.parametrize("u_shape,batch,P,D", [
    ((12, 5, 1, 2), (5, 600), 5, 600),  # heat's ensemble: a trajectory a problem
    ((12, 2), (600,), 1, 600),  # newparam: one input history
    ((12, 2), (), 1, 1),  # one draw
    ((12, 1, 2), (5, 600), 1, 3000),
    ((12, 5, 600, 2), (5, 600), 3000, 1),  # an input history a draw
    ((12, 1, 600, 2), (5, 600), 3000, 1),
    ((12, 3, 1, 1, 2), (3, 4, 6), 3, 24),
])
def test_input_problems(u_shape, batch, P, D):
    """The (P, n, nu) table and D: draw b of the flattened batch reads
    row b // D, the inputs ``dirk2_solve`` would broadcast to it."""
    u = torch.randn(u_shape, dtype=torch.float32)
    table, p, d = input_problems(u, torch.Size(batch))
    assert (p, d) == (P, D) and table.shape == (P, 12, 2) and table.dtype == F64
    assert table.is_contiguous()
    axes = (1,) * (len(batch) - len(u_shape) + 2) + u_shape[1:-1]
    full = u.reshape((12,) + axes + (2,)).expand((12,) + batch + (2,))
    full = full.reshape(12, -1, 2).movedim(0, 1)
    assert torch.equal(table.repeat_interleave(D, dim=0), full.to(F64))


def test_input_problems_refuses_inputs_that_widen_the_batch():
    with pytest.raises(ValueError, match="widen"):
        input_problems(torch.randn(12, 4, 600, 2), torch.Size((600,)))


def _no_build(*_):
    raise AssertionError("the wrapper reached the build")


def test_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
    monkeypatch.setattr(build, "build", _no_build)
    monkeypatch.setattr(build, "load_library", _no_build)
    rom, O, q0, t, u = _cpu_case()
    before = cd.launches
    with pytest.raises(ValueError, match="CUDA"):
        cd.cahbn_dirk2_cuda(O.reshape(6, 3, -1).contiguous(),
                            q0.expand(2, 3, 3).reshape(6, 3).contiguous(), t,
                            torch.zeros(2, 24, 2, dtype=F64), 2)
    assert cd.launches == before


def test_kernel_names_and_limits_are_the_wrappers():
    """The kernel's name stays out of kernel B's roofline reader (which
    counts ``cahbn_screen`` and ``mean_error_kernel``), its instances are
    r 1..8 with nu 1..2, and the C entry's limits are the wrapper's."""
    src = (CSRC / "cahbn_screen.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\(32\)\s+(\w+)", src))
    assert "cahbn_dirk2_kernel" in kernels
    assert not any(n in "cahbn_dirk2_kernel" for n in ("cahbn_screen", "mean_error_kernel"))
    assert int(re.search(r"kDirk2MaxR = (\d+);", src).group(1)) == cd.MAX_STATE == 8
    assert int(re.search(r"kDirk2MaxNu = (\d+);", src).group(1)) == cd.MAX_INPUT == 2
    cases = re.findall(r"GPBOI_DIRK2_CASE\((\d+)\)", src)
    assert [int(c) for c in cases] == list(range(1, 9))
    assert "launch_dirk2_r<1>" in src and "launch_dirk2_r<2>" in src
