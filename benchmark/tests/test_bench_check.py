"""The check that decides ``correct``, driven on the CPU at small sizes
through the harness's own run (all but its look for a card): a sound run
passes; the control (the reference in the next lower precision, in the
program's place) and each fault that a cell can have, planted under the
timed path, fail: the four of every cell, and a GP fit that stops short
and a search that picks another candidate, which the method's own
choices allow; where the roots are factored, a factorization stopped
short. A cell on one chip has no exchange between chips, so that fault
does not apply. The cells are ``BENCHMARK.json``'s, and each fault
finds its target from the cell's configuration: the runner's module, the
screen's module and the observation module's ``POSTERIOR``,
``INTEGRATOR`` and ``PLAIN_SCREEN``. A cell of a new configuration,
added from new files alone, passes the same check."""

import contextlib
import hashlib
import importlib
import inspect
import io
import json
import math
import shutil
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.harness import drive, judge, measure, spec
from benchmark.tests import _tiny

CELLS = _tiny.cells()


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


def _observed(cell):
    """(run, data seed, observations) of one experiment."""
    run, _ = measure.set_up(cell, "cpu")
    s = drive.experiment_seed(_tiny.SEED, 0, cell.traffic["data_seeds"])
    with drive.Instruments(run.config, run.runner_module) as inst:
        _, res = run.experiment(s, inst)
        capture = dict(inst.capture)
    return run, s, run.observe(res, capture, drive.pick_for(s, cell.check))


def _control_verdicts(cell):
    """(program's numbers, control's numbers) of one experiment."""
    run, s, obs = _observed(cell)
    return run.judge_sides(s, obs, {}, [calibrate.CONTROL])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(folder, name):
    cell = _cell(folder, name)
    program, control = _control_verdicts(cell)
    assert judge.verdict(program, cell.check["limits"])[0], program
    assert not judge.verdict(control, cell.check["limits"])[0], control


def test_the_check_in_processes_reads_as_in_one(folder):
    """Experiments shared out over the check's processes come back in
    their order, each with the numbers the reference gives in this
    process (another data seed's reference reads this run far off)."""
    run, s, obs = _observed(_cell(folder, CELLS[0]))
    other = s + 1
    pooled = measure.check(run, [(s, obs), (other, obs), (s, obs)], "cpu")
    for numbers, seed in zip(pooled, (s, other, s)):
        alone = run.judge(seed, obs, {})
        assert numbers.keys() == alone.keys()
        for k, v in alone.items():
            assert numbers[k] == pytest.approx(v, rel=1e-6, abs=1e-13), k
    assert judge.verdict(pooled[0], run.check["limits"])[0]
    assert not judge.verdict(pooled[1], run.check["limits"])[0]


def _observer(cell):
    return drive.resolve(f"benchmark.observe.{cell.config['observe']}")


def _unchanged_state(cell):
    """Every integration step of the ROM ensembles returns its state."""
    def frozen(rhs, q0, t_eval, *args, **kwargs):
        return q0[..., None].expand(*q0.shape, t_eval.shape[0]).clone()

    module, attr = _observer(cell).INTEGRATOR.split(":")
    return mock.patch.object(drive.resolve(module), attr, frozen)


def _half_batch(cell):
    """The screen integrates half of each candidate's draws and takes the
    mean over them."""
    mod = drive.resolve(cell.config["screen"]["function"].split(":")[0])
    attr = _observer(cell).PLAIN_SCREEN
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


def _altered_answer(cell):
    """Each posterior ensemble's draws are altered by one part in a million
    where they are produced."""
    posterior = drive.resolve(_observer(cell).POSTERIOR)
    orig = posterior.solution_posterior

    def altered(self, *args, **kwargs):
        draws, valid = orig(self, *args, **kwargs)
        return draws * (1.0 + 1e-6), valid

    return mock.patch.object(posterior, "solution_posterior", altered)


def _short_fit(cell):
    """The GP fit returns the best of its starts, without its descent and
    polish."""
    import gp_bayesopinf_torch.gp.gp as gp

    orig = gp.fit_gp_hyperparameters

    def short(*args, **kwargs):
        return orig(*args, **dict(kwargs, adam_steps=0, polish_iters=0))

    return mock.patch.object(gp, "fit_gp_hyperparameters", short)


def _other_candidate(cell):
    """The search returns the kept grid candidate next to its best."""
    mod = drive.resolve(cell.config["runner"].split(":")[0])
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
    with fault(cell):
        result, values = _measure(cell)
    assert not result["correct"], values
    assert result["failed"] == result["attempted"] == 1


def _factored_cells():
    """The tiny cells whose check holds factored weight roots (its limits
    list ``root_basis``)."""
    spec_ = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
    checks = _tiny.ROOT / "benchmark" / "checks"
    return [_tiny.tiny_file(w["name"])["name"] for w in spec_["workloads"]
            if "root_basis" in json.loads((checks / f"{w['name']}.json").read_text())["limits"]]


def _truncated_roots():
    """The factored roots' pivoted Cholesky stops at a billion times the
    method's tolerance, so that it leaves out eigenpairs of C above eta."""
    import gp_bayesopinf_torch.gp.lowrank as lowrank

    return mock.patch.object(lowrank, "DEFAULT_TOL_FACTOR", lowrank.DEFAULT_TOL_FACTOR * 1e9)


@pytest.mark.parametrize("name", _factored_cells())
def test_truncated_factored_roots_fail_the_check(folder, name):
    cell = _cell(folder, name)
    with _truncated_roots():
        result, values = _measure(cell)
    assert not result["correct"], values
    assert values["roots"] > cell.check["limits"]["roots"]


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


def _tree_digest(path):
    """A digest of every file under ``path`` but the bytecode caches."""
    h = hashlib.sha256()
    for f in sorted(p for p in path.rglob("*") if p.is_file() and "__pycache__" not in p.parts):
        h.update(str(f.relative_to(path)).encode() + f.read_bytes())
    return h.hexdigest()


def test_a_configuration_added_from_new_files_alone(tmp_path):
    """A copy of the repository gains a configuration under a new name, a
    copy of ``euler``, with its cell, check and tiny copy, as new files and
    new entries of ``BENCHMARK.json``; no file of the harness changes. Its
    sound experiment is correct, and its control and a fault fail."""
    before = _tree_digest(_tiny.ROOT / "benchmark")
    repo = tmp_path / "repo"
    shutil.copytree(_tiny.ROOT / "benchmark", repo / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
    euler = next(c for c in s["configs"] if c["name"] == "euler")
    config = json.loads((_tiny.ROOT / euler["file"]).read_text())
    home = repo / "benchmark"
    (home / "configs" / "eulerx.json").write_text(json.dumps(dict(config, name="eulerx")))
    shutil.copy(home / "checks" / "euler.ex1a.json", home / "checks" / "eulerx.ex1a.json")
    tiny = json.loads((home / "tests" / "tiny" / "euler.ex1a.json").read_text())
    (home / "tests" / "tiny" / "eulerx.ex1a.json").write_text(
        json.dumps(dict(tiny, name="tiny_eulerx.tiny1a")))
    s["configs"].append(dict(euler, name="eulerx", file="benchmark/configs/eulerx.json"))
    s["workloads"].append({"name": "eulerx.ex1a", "config": "eulerx", "traffic": "ex1a",
                           "chips": 1, "why": "a copy of euler.ex1a under a new configuration"})
    for m in s["per_layer"]:
        if "euler.ex1a" in m.get("workloads", []):
            m["workloads"].append("eulerx.ex1a")
    (repo / "BENCHMARK.json").write_text(json.dumps(s))
    spec.load(repo)
    assert "tiny_eulerx.tiny1a" in _tiny.cells(repo)

    folder = _tiny.build(tmp_path / "cells", repo)
    cell = _cell(folder, "tiny_eulerx.tiny1a")
    result, values = _measure(cell)
    assert result["correct"], values
    program, control = _control_verdicts(cell)
    assert judge.verdict(program, cell.check["limits"])[0], program
    assert not judge.verdict(control, cell.check["limits"])[0], control
    with _altered_answer(cell):
        result, values = _measure(cell)
    assert not result["correct"], values
    assert _tree_digest(_tiny.ROOT / "benchmark") == before


def test_a_cell_without_a_tiny_copy_is_named(tmp_path):
    shutil.copy(_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "tests" / "tiny" / "heat.ex3.json").unlink()
    with pytest.raises(FileNotFoundError, match=r"tiny/heat\.ex3\.json is missing"):
        _tiny.build(tmp_path / "cells", tmp_path)


def test_a_listed_number_that_was_not_read_fails():
    ok, rows = judge.verdict({"truth": 0.0}, {"truth": 1e-10, "pod": 1e-9})
    assert not ok
    assert dict((name, value) for name, value, _ in rows) == {"truth": 0.0, "pod": math.inf}


def test_a_number_without_a_limit_raises():
    with pytest.raises(ValueError, match="pod"):
        judge.verdict({"truth": 0.0, "pod": 0.0}, {"truth": 1e-10})


def test_a_number_is_computed_only_from_what_was_observed():
    truth = np.ones((1, 6, 4))
    assert judge.numbers({"truth": truth}, {"truth": truth}, 3) == {"truth": 0.0}


def test_factored_roots_are_held_against_the_plain_covariance():
    """A sound factored root reads at roundoff. One that leaves out an
    eigenpair of C reads its eigenvalue over eta, though its tail is a
    ten-millionth of ||C||: 6e-8 and 1e-7 read 6 and 10 (the root off by
    a factor 2.6 and 3.3 in its direction), 2e-7 reads 20, above the
    limit of every cell with factored roots. A wrong gain or a column
    scaled reads far above the basis's limit; a root without its C reads
    infinite."""
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.standard_normal((100, 9)))[0]
    lam, eta = np.r_[np.logspace(0, -6, 5), 2e-7, 1e-7, 6e-8, 1e-12], 1e-8
    C = (Q * lam) @ Q.T
    gain = 1.0 - np.sqrt(eta / (eta + lam))
    sound = {"Q": Q, "gain": gain, "lam": lam}
    tail, basis = judge.lowrank_gaps([[sound]], C[None, None], eta)
    assert tail < 1e-6 and basis < 1e-14
    limits = [json.loads(p.read_text())["limits"]
              for p in (_tiny.ROOT / "benchmark" / "checks").glob("*.json")]
    limits = [lim for lim in limits if "root_basis" in lim]
    assert limits
    for k in (5, 6, 7):
        keep = np.arange(9) != k
        dropped = dict(sound, Q=Q[:, keep], gain=gain[keep], lam=lam[keep])
        tail, _ = judge.lowrank_gaps([[dropped]], C[None, None], eta)
        assert tail == pytest.approx(lam[k] / eta, rel=1e-6)
        if k == 5:
            assert all(tail > lim["roots"] for lim in limits)
    for f in (dict(sound, gain=gain * (1 + 1e-6)), dict(sound, Q=Q * np.r_[2.0, [1.0] * 8])):
        _, basis = judge.lowrank_gaps([[f]], C[None, None], eta)
        assert all(basis > lim["root_basis"] for lim in limits)
    assert judge.lowrank_gaps([[sound, sound]], C[None, None], eta) == (math.inf, math.inf)


class _LoadsJax:
    """Unpickled, imports the module named ``jax``."""

    def __reduce__(self):
        return importlib.import_module, ("jax",)


def test_a_check_process_that_loads_jax_refuses_the_run(folder, tmp_path, monkeypatch):
    """An observation whose unpickling, in a process of the check, loads
    a module named ``jax`` (a stand-in on the path) raises
    ``ForbiddenModules``; this process never loads it; ``run.main`` turns
    that into a non-zero exit without a result line."""
    (tmp_path / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    run, s, obs = _observed(_cell(folder, CELLS[0]))
    with pytest.raises(measure.ForbiddenModules, match="jax"):
        measure.check(run, [(s, obs), (s, dict(obs, planted=_LoadsJax()))], "cpu")
    assert "jax" not in sys.modules

    from benchmark import run as run_py

    def refused(*args, **kwargs):
        raise measure.ForbiddenModules("the check's processes loaded modules of JAX: ['jax']")

    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "")  # run.main sets them; restored after the test
    printed = io.StringIO()
    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: 1), \
            mock.patch.object(measure, "measure", refused), \
            contextlib.redirect_stdout(printed):
        rc = run_py.main(["--workload", "euler.ex1a", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and printed.getvalue() == ""
