"""The PyTorch port's records of a run on the CPU: the report text against
the JAX package's for the same inputs, ``setup_logging``, the CLI's
``log.log`` / figures folder / ``report.txt`` and ``--nolog`` (with the
pipeline replaced by a fake result), ``--profile`` on a tiny SEIRD run,
``StageTimer`` and the ``TimedBlock`` watchdog."""

import glob
import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from gp_bayesopinf_tpu.pipeline import report as jreport
from gp_bayesopinf_torch.pipeline import cli, odes, report
from gp_bayesopinf_torch.utils import StageTimer, TimedBlock, setup_logging


@pytest.fixture(autouse=True)
def _root_handlers():
    """Leave the root logger's handlers as they were."""
    root = logging.getLogger()
    before, level = list(root.handlers), root.level
    yield
    for h in root.handlers[:]:
        if h not in before:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


SCENARIOS = [
    dict(training_span=(0.0, 90.0), num_samples=90, noiselevel=0.1, num_regression_points=360,
         gp_regularizer=1e-8, ndraws=600),
    dict(training_span=(0.0, 0.06), num_samples=200, noiselevel=0.03, num_regression_points=400,
         numPODmodes=6, gp_regularizer=1e-8, ndraws=600),
    dict(training_span=(0.5, 1.0), num_samples=20, noiselevel=0.05, num_regression_points=80,
         numPODmodes=5),
]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_summarize_experiment_text_equals_jax(tmp_path, capsys, scenario):
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    text = report.summarize_experiment(**scenario, folder=str(port))
    assert text == jreport.summarize_experiment(**scenario, folder=str(jax))
    assert (port / "report.txt").read_text() == (jax / "report.txt").read_text()
    out = capsys.readouterr().out
    assert out.count(text) == 2


def test_summarize_posterior_text_equals_jax(tmp_path, rng):
    """Tensors (the port's posterior) and arrays (the JAX package's) give
    the same characters."""

    class Posterior:
        def __init__(self, mean, cov):
            self.mean, self.cov = mean, cov

    mean = np.abs(rng.standard_normal(4)) * 1e-3
    X = rng.standard_normal((4, 4))
    cov = X @ X.T * 1e-9
    params = (0.00025, 0.1, 0.099, 0.005)
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    text = report.summarize_posterior(params, Posterior(torch.as_tensor(mean), torch.as_tensor(cov)),
                                      str(port))
    assert text == jreport.summarize_posterior(params, Posterior(mean, cov), str(jax))
    assert (port / "report.txt").read_text() == (jax / "report.txt").read_text()
    assert text.startswith("POSTERIOR DISTRIBUTION\nTrue parameters:\t[ 2.5000e-04")


def test_figures_path_and_setup_logging(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    folder = report.figures_path()
    assert os.path.isdir(folder)
    assert folder == os.path.join("figures", time.strftime("%b%d").lower(),
                                  os.path.basename(folder))
    assert setup_logging() == "log.log"
    setup_logging()  # idempotent: still one handler for the file
    handlers = [h for h in logging.getLogger().handlers
                if isinstance(h, logging.FileHandler)
                and h.baseFilename == str(tmp_path / "log.log")]
    assert len(handlers) == 1
    logging.info("a line")
    text = (tmp_path / "log.log").read_text()
    assert text.count("NEW SESSION") == 2 and "INFO: a line" in text


class _FakeResult:
    """What ``main`` reads of a SEIRD result."""

    regularizer = 1e-3
    valid = torch.tensor([True, False, True])

    class model:
        parameters = (1.0, 2.0, 3.0, 4.0)

    class bayesian_model:
        mean = torch.zeros(4, dtype=torch.float64)
        cov = torch.eye(4, dtype=torch.float64)


def test_cli_records(tmp_path, monkeypatch, capsys):
    """A run keeps ``log.log`` and a dated folder with ``report.txt`` (the
    scenario, and the posterior for ``seird``); ``--nolog`` keeps none."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "_run_pipeline", lambda args: _FakeResult())
    assert cli.main(["seird", "90", "90", "0.1", "360", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "chosen regularizer: 1.000000e-03" in out and "stable draws: 2/3" in out
    logtext = (tmp_path / "log.log").read_text()
    assert "NEW SESSION" in logtext and "chosen regularizer: 1.000000e-03" in logtext
    assert "gpboi-torch seird" in logtext
    reports = glob.glob(str(tmp_path / "figures" / "*" / "*" / "report.txt"))
    assert len(reports) == 1
    text = open(reports[0]).read()
    assert "EXPERIMENTAL SCENARIO" in text and "POSTERIOR DISTRIBUTION" in text

    (tmp_path / "log.log").unlink()
    for path in reports:
        os.remove(path)
    assert cli.main(["seird", "90", "90", "0.1", "360", "--device", "cpu", "--nolog"]) == 0
    assert not (tmp_path / "log.log").exists()
    assert not glob.glob(str(tmp_path / "figures" / "*" / "*" / "report.txt"))


STAGES = ("data", "gp_fit", "regression", "ensemble", "newic")


def _staged_run(**kwargs):
    """A stand-in for ``run_seird`` (a real run takes a minute under the
    CPU profiler): the pipeline's stage blocks around a little work."""
    assert kwargs["device"] == "cpu"
    x = torch.ones(8, dtype=torch.float64)
    for name in STAGES:
        with TimedBlock(f"{name} stage", silent=True, device="cpu", name=name):
            x = torch.cumsum(x * 0.5, 0)
    return x


def test_cli_profile_writes_trace(tmp_path, monkeypatch):
    """``--profile LOGDIR`` wraps the pipeline in ``profile_trace``: one
    Chrome trace holding every stage's range (the ``TimedBlock`` names)
    and the operations inside them."""
    monkeypatch.setattr(odes, "run_seird", _staged_run)
    argv = ["seird", "60", "24", "0.05", "32", "--device", "cpu", "--nolog",
            "--profile", str(tmp_path / "prof")]
    assert cli.run(argv).shape == (8,)
    traces = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert set(STAGES) <= set(names) and names.count("aten::cumsum") == len(STAGES)
    assert cli.run(argv[:-2]).shape == (8,)  # no --profile, no new trace
    assert len(glob.glob(str(tmp_path / "prof" / "*.json"))) == 1


def test_stage_timer_and_watchdog(capsys):
    timer = StageTimer()
    for _ in range(2):
        with timer.block("a"):
            pass
    with pytest.raises(TimeoutError, match="'b' exceeded 0.0 s"):
        with timer.block("b", timelimit=0.0):
            time.sleep(0.001)
    assert set(timer.times) == {"a", "b"} and timer.times["b"] >= 0.001
    lines = timer.report().splitlines()
    assert lines[0].startswith("a: ") and lines[-1].startswith("TOTAL: ")
    with TimedBlock("quick", timelimit=60.0, silent=True) as tb:
        pass
    assert tb.elapsed < 60.0
    # An exception inside the block propagates and the watchdog stays out.
    with pytest.raises(KeyError):
        with TimedBlock("failing", timelimit=0.0, silent=True):
            raise KeyError("x")
    assert "done in" in capsys.readouterr().out
