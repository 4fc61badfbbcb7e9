"""Which kernel family each screen takes by dimension, the warps a
candidate's draws take in each, and the wrappers' refusals, on the CPU.

Kernel A (``ops/ensemble_screen.py``, ``csrc/quadratic_screen.cu``) and
kernel B (``ops/cahbn_screen.py``, ``csrc/cahbn_screen.cu``) each have
four families: the templated instances, the capacity-templated kernel,
the runtime-dimension kernel and the wide kernel. The wrapper picks
one of the templated, capacity and wide families by dimension (the
runtime kernel only when forced) and passes its code to the C entry,
which picks the capacity instance by r; both sides are read here, the C
side from the sources. No JAX, no card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.ops import cahbn_screen as cs
from gp_bayesopinf_torch.ops import ensemble_screen as es

CSRC = Path(__file__).resolve().parents[1] / "gp_bayesopinf_torch" / "csrc"


@pytest.mark.parametrize("r,family,capacity", [
    (1, "templated", None), (12, "templated", None),  # the templated instances
    (13, "capacity", 16), (16, "capacity", 16),  # the first capacity instance
    (17, "capacity", 32), (32, "capacity", 32),  # the second
    (33, "wide", None), (64, "wide", None),  # above the capacity kernel
])
def test_kernel_a_family_by_r(r, family, capacity):
    assert es.screen_family(r) == family
    if capacity is not None:
        assert es.capacity_instance(r) == capacity


@pytest.mark.parametrize("r,nu,family,capacity", [
    (1, 1, "templated", None), (8, 2, "templated", None),
    (9, 2, "capacity", 12), (8, 3, "capacity", 12),  # past the templated r, past its nu
    (12, 4, "capacity", 12), (13, 4, "capacity", 16), (16, 4, "capacity", 16),
    (16, 5, "wide", None), (17, 1, "wide", None), (3, 5, "wide", None),  # beyond the capacity
])
def test_kernel_b_family_by_r_and_nu(r, nu, family, capacity):
    assert cs.screen_family(r, nu) == family
    if capacity is not None:
        assert cs.capacity_instance(r) == capacity


@pytest.mark.parametrize("r,nd,templated_warps", [(1, 20, 1), (6, 20, 5), (12, 20, 10),
                                                  (12, 7, 4), (5, 32, 8)])
def test_warps_per_candidate_by_family(r, nd, templated_warps):
    """The templated instances pack 32 / (power of two >= r) draws into a
    warp; the capacity and runtime kernels give each draw its own warp, the
    wide kernel its own block: nd per-draw sums in each."""
    assert es.warps_per_candidate(r, nd) == templated_warps
    for family in ("capacity", "runtime", "wide"):
        assert es.warps_per_candidate(r, nd, templated=family == "templated") == nd


@pytest.mark.parametrize("call,match", [
    (lambda: es.screen_family(13, "templated"), "templated kernel does not take r=13"),
    (lambda: es.screen_family(33, "capacity"), "capacity kernel does not take r=33"),
    (lambda: es.screen_family(6, "any_r"), "family must be one of"),
    (lambda: es.screen_family(0), "r >= 1"),
    (lambda: cs.screen_family(9, 2, "templated"), "templated kernel does not take r=9, nu=2"),
    (lambda: cs.screen_family(8, 3, "templated"), "templated kernel does not take r=8, nu=3"),
    (lambda: cs.screen_family(17, 1, "capacity"), "capacity kernel does not take r=17"),
    (lambda: cs.screen_family(16, 5, "capacity"), "capacity kernel does not take r=16, nu=5"),
    (lambda: cs.screen_family(5, 0), "r and nu >= 1"),
])
def test_family_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_forced_families_that_fit():
    """Forcing "runtime" still takes the runtime kernel at every dimension, and
    "wide" takes every dimension too; no automatic choice is "runtime"."""
    assert es.screen_family(6, "capacity") == "capacity"
    for r in (1, 6, 13, 32, 33, 40, 64, 100):
        assert es.screen_family(r, "runtime") == "runtime"
        assert es.screen_family(r, "wide") == "wide"
        assert es.screen_family(r) != "runtime"
    assert cs.screen_family(5, 2, "capacity") == "capacity"
    for r, nu in ((1, 1), (5, 2), (9, 2), (16, 4), (16, 5), (17, 1), (20, 6), (48, 2)):
        assert cs.screen_family(r, nu, "runtime") == "runtime"
        assert cs.screen_family(r, nu, "wide") == "wide"
        assert cs.screen_family(r, nu) != "runtime"
    assert es.FAMILIES[:3] == ("templated", "capacity", "runtime")  # codes 0-2 unchanged
    assert es.CHOSEN == ("templated", "capacity", "wide")


def test_c_entries_agree_with_the_wrappers():
    """The family codes (the wide family's 3 beside 0-2), the limits and
    the capacity instances of both C entries are those of the wrappers; the
    entries refuse a code past the wide family's and take the wide family
    at every dimension (no limit of their own)."""
    for src, mod in (("quadratic_screen.cu", es), ("cahbn_screen.cu", cs)):
        text = (CSRC / src).read_text()
        codes = {name: int(v) for name, v in
                 re.findall(r"constexpr int k(Templated|Capacity|Runtime|Wide) = (\d+);", text)}
        assert codes == {f.capitalize(): i for i, f in enumerate(es.FAMILIES)}
        assert codes["Wide"] == 3
        assert "family < kTemplated || family > kWide" in re.sub(r"\s+", " ", text)
        assert not re.search(r"family == kWide && ", text)
        limits = dict(re.findall(r"constexpr int k(\w+Max\w+) = (\d+);", text))
        assert int(limits["TemplatedMaxR"]) == mod.TEMPLATED_MAX_STATE
        assert int(limits["CapacityMaxR"]) == mod.CAPACITY_MAX_STATE
        instances = sorted({int(c) for c in re.findall(r"launch_cap<(\d+)", text)})
        assert tuple(instances) == mod.CAPACITY_INSTANCES
        # The entry takes the smaller instance up to its capacity.
        assert f"r <= {mod.CAPACITY_INSTANCES[0]} ? launch_cap<{mod.CAPACITY_INSTANCES[0]}" in \
            re.sub(r"\s+", " ", text)
    b = (CSRC / "cahbn_screen.cu").read_text()
    assert int(re.search(r"kTemplatedMaxNu = (\d+);", b).group(1)) == cs.TEMPLATED_MAX_INPUT
    assert int(re.search(r"kCapacityMaxNu = (\d+);", b).group(1)) == cs.CAPACITY_MAX_INPUT


def _a_args(r, G=2, nd=3, k=5):
    rng = np.random.default_rng(r)
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.1 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= np.eye(r)
    arrays = (Ohat, 0.3 * rng.standard_normal(r), np.linspace(0, 0.2, k), np.zeros(r),
              np.full(r, 10.0), rng.standard_normal((r, k)))
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


def _b_args(r, nu, G=2, nd=3, k=4, substeps=1):
    rng = np.random.default_rng(100 + r)
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    Ohat = 0.1 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= np.eye(r)
    t = torch.linspace(0, 0.2, k, dtype=torch.float64)
    u = torch.sin(cs.input_stage_times(t, substeps))[:, None].repeat(1, nu)
    arrays = (Ohat, 0.3 * rng.standard_normal(r), t, np.zeros(r), np.full(r, 10.0), u,
              rng.standard_normal((r, k)))
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


@pytest.mark.parametrize("r", [6, 13, 33])
def test_kernel_a_cpu_tensors_take_the_plain_version(r):
    """On the CPU the dispatcher runs the plain version at every r and
    launches nothing; the CUDA entry refuses CPU tensors before it looks
    at the family."""
    before, by_family = es.launches, dict(es.family_launches)
    stable, err = es.quadratic_ensemble_screen(*_a_args(r), nd=3, substeps=2)
    assert stable.shape == (6,) and err.shape == (2,) and bool(stable.all())
    assert es.launches == before and es.family_launches == by_family
    with pytest.raises(ValueError, match="CUDA tensors"):
        es.quadratic_ensemble_screen_cuda(*_a_args(r), nd=3, family="runtime")


@pytest.mark.parametrize("r,nu", [(5, 2), (9, 2), (6, 3), (17, 1)])
def test_kernel_b_cpu_tensors_take_the_plain_version(r, nu):
    before, by_family = cs.launches, dict(cs.family_launches)
    stable, err = cs.cahbn_ensemble_screen(*_b_args(r, nu), nd=3, substeps=1, newton_iters=2)
    assert stable.shape == (6,) and err.shape == (2,) and bool(stable.all())
    assert cs.launches == before and cs.family_launches == by_family
    with pytest.raises(ValueError, match="CUDA tensors"):
        cs.cahbn_ensemble_screen_cuda(*_b_args(r, nu), nd=3, substeps=1, family="capacity")
