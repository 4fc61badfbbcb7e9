"""``run_scaled``'s checkpoint of its front half on the CPU, at the tiny
size of ``tests/test_torch_cli_serve.py`` (n 48, k 80, 2 modes, m 30,
m' 32): a rerun with the checkpoint returns the same result to the bit
and skips data, POD and the GP fit; another seed ignores the checkpoint
and overwrites it; the CLI's ``--checkpoint-dir``; and the checkpoint
module itself."""

import json

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.io import (
    checkpoint, load_checkpoint, pipeline_stage_state, save_checkpoint,
)
from gp_bayesopinf_torch.pipeline import cli, run_scaled
from gp_bayesopinf_torch.pipeline.scaled import run as run_module

SIZES = dict(n_space=48, n_snapshots=80, num_modes=2, num_gp_samples=30,
             num_regression_points=32, n_restarts=2, ndraws=4, grid_size=4)
FRONT = {"data", "pod", "gp_fit"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _assert_same(a, b):
    """Bit for bit: the decisions and every array of the result."""
    assert a.regularizer == b.regularizer and a.train_error == b.train_error
    assert a.stable_fraction == b.stable_fraction
    for name in ("grid_errors", "ensemble_mean", "svdvals", "sample_times", "samples",
                 "hyperparameters"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("extra", [{}, dict(time_windows=2, modelform="cAH",
                                            regularization="blocked")])
def test_resume_is_bit_identical(tmp_path, extra):
    first = run_scaled(**SIZES, **extra, checkpoint_dir=str(tmp_path), device="cpu")
    assert (tmp_path / "scaled_fit_stage" / "state.pt").is_file()
    assert FRONT <= set(first.stage_seconds)
    second = run_scaled(**SIZES, **extra, checkpoint_dir=str(tmp_path), device="cpu")
    assert not FRONT & set(second.stage_seconds)
    assert {"estimate", "screening", "ensemble"} <= set(second.stage_seconds)
    _assert_same(first, second)
    plain = run_scaled(**SIZES, **extra, device="cpu")
    _assert_same(first, plain)  # the checkpoint changes nothing of the run


def test_resume_skips_the_front_half(tmp_path, monkeypatch):
    run_scaled(**SIZES, checkpoint_dir=str(tmp_path), device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the front half ran again")

    monkeypatch.setattr(run_module, "_compress_and_fit", refuse)
    res = run_scaled(**SIZES, checkpoint_dir=str(tmp_path), device="cpu")
    assert np.isfinite(res.train_error)


def test_other_run_overwrites_the_checkpoint(tmp_path):
    """A checkpoint of another seed (or of another sample or restart
    count) is recomputed and overwritten."""
    run_scaled(**SIZES, checkpoint_dir=str(tmp_path), device="cpu")
    path = str(tmp_path / "scaled_fit_stage")
    _, meta0 = load_checkpoint(path, device="cpu")
    other = run_scaled(**SIZES, seed=1, checkpoint_dir=str(tmp_path), device="cpu")
    assert FRONT <= set(other.stage_seconds)
    state, meta1 = load_checkpoint(path, device="cpu")
    assert meta0["shape"][3] == 0 and meta1["shape"][3] == 1
    np.testing.assert_array_equal(state["Y"].numpy(), other.samples)
    _assert_same(other, run_scaled(**SIZES, seed=1, device="cpu"))
    fewer = run_scaled(**dict(SIZES, num_gp_samples=24), seed=1, checkpoint_dir=str(tmp_path),
                       device="cpu")
    assert FRONT <= set(fewer.stage_seconds) and fewer.samples.shape == (2, 24)


def test_cli_checkpoint_dir(tmp_path, capsys):
    argv = ["scaled", "--n-space", "48", "--k", "80", "--modes", "2", "--gp-samples", "30",
            "--mprime", "32", "--restarts", "2", "--ndraws", "4", "--grid-size", "4",
            "--device", "cpu", "--quiet", "--checkpoint-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    resumed = cli.run(argv)
    assert not FRONT & set(resumed.stage_seconds)
    assert cli.main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == first


def test_checkpoint_module(tmp_path):
    """Tensors and arrays in, tensors on the asked device out; metadata of
    plain values; None entries left out; a save replaces the old one."""
    state = pipeline_stage_state(a=torch.arange(3.0), b=np.eye(2), c=None)
    assert set(state) == {"a", "b"} and state["b"].dtype == torch.float64
    path = str(tmp_path / "ck")
    assert not checkpoint.has_checkpoint(path)
    save_checkpoint(path, state, metadata={"shape": [1, "x"]})
    assert checkpoint.has_checkpoint(path)
    got, meta = load_checkpoint(path, device="cpu")
    assert meta == {"shape": [1, "x"]}
    torch.testing.assert_close(got["a"], torch.arange(3.0), rtol=0, atol=0)
    save_checkpoint(path, {"a": torch.zeros(1)})
    got, meta = load_checkpoint(path, device="cpu")
    assert set(got) == {"a"} and meta == {}
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["state.pt"]
