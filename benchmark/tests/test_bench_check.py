"""The check that decides ``correct``, driven on the CPU at small sizes
through the harness's own run (all but its look for a card): a sound run
passes; the control (the reference in the next lower precision, in the
program's place) and each fault that a cell can have, planted under the
timed path, fail: the four of every cell, and a GP fit that stops short
and a search that picks another candidate, which the method's own
choices allow. A cell on one chip has no exchange between chips, so that
fault does not apply."""

import inspect
import time
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.harness import drive, judge, measure, spec
from benchmark.tests import _tiny

CELLS = ["tiny_euler.tiny1a", "tiny_heat.tiny3"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _tiny.build(tmp_path_factory.mktemp("cells"))


def _cell(folder, name):
    return spec.Cell(spec.load(folder), name, folder, folder)


def _measure(cell):
    result, rows = measure.measure(cell, _tiny.SEED, 1.0, False, "cpu", time.perf_counter())
    return result, {name: value for name, value, _ in rows}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(folder, name):
    result, values = _measure(_cell(folder, name))
    assert result["correct"], values
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"experiment_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(folder, name):
    cell = _cell(folder, name)
    run, _ = measure.set_up(cell, "cpu")
    s = drive.experiment_seed(_tiny.SEED, 0, cell.traffic["data_seeds"])
    with drive.Instruments(run.config, run.runner_module) as inst:
        _, res = run.experiment(s, inst)
        capture = dict(inst.capture)
    obs = run.observe(res, capture, drive.pick_for(s, cell.check))
    program, control = run.judge_sides(s, obs, {}, [calibrate.CONTROL])
    assert judge.verdict(program, cell.check["limits"])[0], program
    assert not judge.verdict(control, cell.check["limits"])[0], control


def _unchanged_state(name):
    """Every integration step of the ROM ensembles returns its state."""
    import gp_bayesopinf_torch.rom.model as model

    def frozen(rhs, q0, t_eval, *args, **kwargs):
        return q0[..., None].expand(*q0.shape, t_eval.shape[0]).clone()

    return mock.patch.object(model, "rk4_solve" if "euler" in name else "dirk2_solve", frozen)


def _half_batch(name):
    """The screen integrates half of each candidate's draws and takes the
    mean over them."""
    if "euler" in name:
        import gp_bayesopinf_torch.ops.ensemble_screen as mod
        attr = "quadratic_ensemble_screen_torch"
    else:
        import gp_bayesopinf_torch.ops.cahbn_screen as mod
        attr = "cahbn_ensemble_screen_torch"
    orig = getattr(mod, attr)
    signature = inspect.signature(orig)

    def half(*args, **kwargs):
        a = signature.bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        Ohat, nd = a["Ohat"], a["nd"]
        G, h = Ohat.shape[0] // nd, nd // 2
        a["Ohat"] = Ohat.reshape(G, nd, *Ohat.shape[1:])[:, :h].reshape(G * h, *Ohat.shape[1:])
        a["nd"] = h
        stable, err = orig(**a)
        part = stable.reshape(*stable.shape[:-1], G, h)
        return torch.cat([part, part], dim=-1).reshape(*stable.shape[:-1], G * nd), err

    return mock.patch.object(mod, attr, half)


def _altered_answer(name):
    """Each posterior ensemble's draws are altered by one part in a million
    where they are produced."""
    from gp_bayesopinf_torch.bayes.posterior import BayesianROM

    orig = BayesianROM.solution_posterior

    def altered(self, *args, **kwargs):
        draws, valid = orig(self, *args, **kwargs)
        return draws * (1.0 + 1e-6), valid

    return mock.patch.object(BayesianROM, "solution_posterior", altered)


def _short_fit(name):
    """The GP fit returns the best of its starts, without its descent and
    polish."""
    import gp_bayesopinf_torch.gp.gp as gp

    orig = gp.fit_gp_hyperparameters

    def short(*args, **kwargs):
        return orig(*args, **dict(kwargs, adam_steps=0, polish_iters=0))

    return mock.patch.object(gp, "fit_gp_hyperparameters", short)


def _other_candidate(name):
    """The search returns the kept grid candidate next to its best."""
    import gp_bayesopinf_torch.pipeline.pdes as pdes
    import gp_bayesopinf_torch.pipeline.pdes_multi as pdes_multi

    mod = pdes if "euler" in name else pdes_multi
    orig = mod.auto_regularize

    def other(*args, **kwargs):
        res = orig(*args, **kwargs)
        grid = np.sort(np.asarray(kwargs["grid"]))
        kept = np.flatnonzero(res.grid_errors < judge.MAXOPTVAL)
        best = int(np.argmin(res.grid_errors))
        pick = kept[kept != best][np.argmin(np.abs(kept[kept != best] - best))]
        return res._replace(regularizer=float(grid[pick]), refined=False)

    return mock.patch.object(mod, "auto_regularize", other)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer, _short_fit,
                                   _other_candidate],
                         ids=["unchanged state", "half the batch", "altered answer", "short fit",
                              "other candidate"])
def test_each_fault_fails_the_check(folder, name, fault):
    cell = _cell(folder, name)
    with fault(name):
        result, values = _measure(cell)
    assert not result["correct"], values
    assert result["failed"] == result["attempted"] == 1


def _false_rejection():
    """The search rejects every candidate, kept or not, so that it raises."""
    import gp_bayesopinf_torch.bayes.regsearch as regsearch

    make = regsearch._kernel_objective

    def rejecting(*args, **kwargs):
        evaluate = make(*args, **kwargs)
        return lambda lams, xi: np.full_like(evaluate(lams, xi), 1e12)

    return mock.patch.object(regsearch, "_kernel_objective", rejecting)


@pytest.mark.parametrize("name", CELLS)
def test_a_search_that_raises_fails_the_run(folder, name):
    with _false_rejection():
        result, values = _measure(_cell(folder, name))
    assert not result["correct"], values
    assert result["failed"] >= 1 and result["failed"] == result["attempted"]
    assert "experiment_s" not in result["metrics"]
