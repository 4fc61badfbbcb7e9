"""The SEIRD cell's check on the CPU, at the cut of
``benchmark/tests/tiny/seird.ex1a.json``: ``run_seird`` through the
benchmark's ``drive.Run`` against the plain reference
``benchmark/reference/seird.py``. A sound experiment reads every number
under its limit in ``benchmark/checks/seird.ex1a.json``; each of three
planted faults reads above the limit of the number that guards it: the
ensemble from the unseen initial state integrated with 4 substeps in
place of 8 (``ensemble``), ``SEIRD2.cah_operators`` with the sign of the
recovered rate flipped, so that the search screens another model
(``search_err``), and the regression without the last variable's block
(``posterior``). The reference loads nothing of the port or of JAX."""

import ast
import dataclasses
from pathlib import Path
from unittest import mock

import pytest
import torch

from benchmark.harness import drive, judge, spec
from benchmark.tests import _tiny
from gp_bayesopinf_torch.bayes.posterior import BayesianODE
from gp_bayesopinf_torch.models.seird import SEIRD2
from gp_bayesopinf_torch.pipeline import odes

CELL = "tiny_seird.tinyode1a"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tiny cell's ``drive.Run``, on one thread: the tiny run's many
    small operations run fastest there."""
    folder = _tiny.build(tmp_path_factory.mktemp("cells"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield drive.Run(spec.Cell(spec.load(folder), CELL, folder, folder), "cpu")
    torch.set_num_threads(threads)


def _numbers(run) -> dict:
    """The compared numbers of one experiment at the tiny pool's seed."""
    s = drive.experiment_seed(_tiny.SEED, 0, run.traffic["data_seeds"])
    with drive.Instruments(run.config, run.runner_module) as inst:
        _, res = run.experiment(s, inst)
        capture = dict(inst.capture)
    return run.judge(s, run.observe(res, capture, drive.pick_for(s, run.check)), {})


def test_a_sound_experiment_is_within_every_limit(run):
    values = _numbers(run)
    limits = run.check["limits"]
    assert set(values) == set(limits)
    ok, rows = judge.verdict(values, limits)
    assert ok, rows


def _coarse_newic():
    """The ensemble without an envelope (the unseen initial state's) is
    integrated with 4 substeps."""
    orig = BayesianODE.solution_posterior

    def coarse(self, *args, stability_envelope=None, **kwargs):
        if stability_envelope is None:
            self = dataclasses.replace(self, model=dataclasses.replace(self.model, substeps=4))
        return orig(self, *args, stability_envelope=stability_envelope, **kwargs)

    return mock.patch.object(BayesianODE, "solution_posterior", coarse)


def _flipped_operator():
    """The recovered rate enters R' with the wrong sign in the operator
    rows the search screens."""
    orig = SEIRD2.cah_operators

    def flipped(self, params):
        O = orig(self, params)
        O[..., 3, 3] = -O[..., 3, 3]  # row R, column I
        return O

    return mock.patch.object(SEIRD2, "cah_operators", flipped)


def _block_left_out():
    """The regression weighs four of the five variables' blocks."""
    orig = odes.weighted_lstsq_fit

    def four(D_blocks, roots, rhs, **kwargs):
        return orig(D_blocks[:4], roots[:, :4], rhs[:, :4], **kwargs)

    return mock.patch.object(odes, "weighted_lstsq_fit", four)


@pytest.mark.parametrize("fault, number", [(_coarse_newic, "ensemble"),
                                           (_flipped_operator, "search_err"),
                                           (_block_left_out, "posterior")],
                         ids=["newic with 4 substeps", "operator sign flipped",
                              "a block left out"])
def test_each_fault_reads_above_its_limit(run, fault, number):
    with fault():
        values = _numbers(run)
    assert values[number] > run.check["limits"][number], values
    assert not judge.verdict(values, run.check["limits"])[0]


def _imports(path: Path) -> set:
    """The top-level names a module imports, and the modules of its
    package it imports, by name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= ({node.module.split(".")[0]} if node.level == 0
                      else {"." + a.name for a in node.names})
    return names


def test_the_reference_loads_nothing_of_the_port_or_of_jax():
    """``reference/seird.py`` and every module of the reference it loads
    import only the standard library's ``math``, NumPy, SciPy and
    PyTorch."""
    home = _tiny.ROOT / "benchmark" / "reference"
    todo, seen, names = ["seird"], set(), set()
    while todo:
        mod = todo.pop()
        seen.add(mod)
        for name in _imports(home / f"{mod}.py"):
            if name.startswith("."):
                todo += [name[1:]] if name[1:] not in seen else []
            else:
                names.add(name)
    assert seen == {"seird", "common", "experiment"}
    assert names <= {"math", "numpy", "scipy", "torch"}
    assert not names & {"gp_bayesopinf_torch", "gp_bayesopinf_tpu", "jax", "jaxlib", "flax"}
