"""``run_scaled(mesh=...)`` at world 2 on the mesh that ``scaled --devices 2``
builds ({"draw": 1, "mode": 2}): local window bases (W 2) against the
port's one-device run, a checkpoint written on the mesh and resumed on it,
and ``scaled --devices 2 --device cpu`` through ``cli.main``. The size is
the JAX package's ``test_scaled_pipeline_on_mesh`` (n 128, k 300, r 4, m
80, m' 96, 2 restarts, 16 draws, grid 8, "cAH").

Local bases from scratch: each window's randomized POD sums its products
over the ranks, so the window bases agree with one device's up to sign to
1e-4 (float32), the singular values to 1e-4 of the largest, the
hyperparameters to 1e-3 in their logarithm, and the grid's rejections with
the JAX test's gates. Resumed from one device's checkpoint, the back half
is one device's to the bit (the TSQR's problems and the GP fits split over
"mode" only, no sum over ranks). A run resumed from the mesh's own
checkpoint is the run that wrote it, to the bit.
"""

import json

import numpy as np
import pytest
import torch

import _torch_mesh_common as common
from gp_bayesopinf_torch.parallel import spawn
from gp_bayesopinf_torch.pipeline import cli, run_scaled
from gp_bayesopinf_torch.pipeline.scaled.search import REJECTED

SHAPE = {"draw": 1, "mode": 2}
LOCAL = dict(time_windows=2, window_basis="local")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One device's local run (with its checkpoint) and every rank's
    runs: local from scratch, local resumed from one device's checkpoint,
    and a global run twice with a fresh checkpoint directory."""
    one_dir = str(tmp_path_factory.mktemp("one"))
    mesh_dir = str(tmp_path_factory.mktemp("mesh"))
    one = common._scaled_digest(run_scaled(**common.SCALED, **LOCAL, checkpoint_dir=one_dir,
                                           device="cpu"))
    plan = [LOCAL, dict(LOCAL, checkpoint_dir=one_dir), dict(checkpoint_dir=mesh_dir),
            dict(checkpoint_dir=mesh_dir)]
    return one, spawn(common.scaled_runs, 2, ["cpu"] * 2, args=(SHAPE, plan), timeout=300)


def test_local_bases_from_scratch_match_one_device(runs):
    one, ranks = runs
    res = ranks[0][0]
    for out in ranks[1:]:
        for key, value in res.items():
            np.testing.assert_array_equal(out[0][key], value, err_msg=key)
    B, B1 = res["window_bases"], one["window_bases"]
    assert B.shape == B1.shape == (2, 128, 4)
    signs = np.sign(np.sum(B * B1, axis=1, keepdims=True))
    np.testing.assert_allclose(B * signs, B1, rtol=0, atol=1e-4)
    sv1 = one["svdvals"]
    for sv, ref in zip(res["svdvals"], sv1):
        np.testing.assert_allclose(sv, ref, rtol=0, atol=1e-4 * ref[0])
    np.testing.assert_allclose(np.log(res["hyperparameters"]), np.log(one["hyperparameters"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res["grid_errors"] >= REJECTED,
                                  one["grid_errors"] >= REJECTED)
    assert res["stable_fraction"] > 0.5 and np.isfinite(res["ensemble_mean"]).all()
    assert res["window_regularizers"].shape == (2,)


def test_local_back_half_resumed_is_one_device_bit_for_bit(runs):
    one, ranks = runs
    res = ranks[0][1]
    assert not {"data", "pod", "gp_fit"} & set(res["stages"])
    for key in ("window_bases", "grid_errors", "window_regularizers", "ensemble_mean"):
        np.testing.assert_array_equal(res[key], one[key], err_msg=key)
    assert (res["regularizer"], res["stable_fraction"], res["train_error"]) == (
        one["regularizer"], one["stable_fraction"], one["train_error"])


def test_checkpoint_written_on_the_mesh_resumes_to_the_bit(runs):
    _, ranks = runs
    for out in ranks:
        first, second = out[2], out[3]
        assert {"data", "pod", "gp_fit"} <= set(first["stages"])
        assert not {"data", "pod", "gp_fit"} & set(second["stages"])
        for key, value in first.items():
            if key != "stages":
                np.testing.assert_array_equal(second[key], value, err_msg=key)


def test_scaled_devices_on_cpu_ranks_prints_one_line(capsys):
    argv = ["scaled", "--n-space", "128", "--k", "300", "--modes", "4", "--gp-samples", "80",
            "--mprime", "96", "--restarts", "2", "--ndraws", "16", "--grid-size", "8",
            "--modelform", "cAH", "--device", "cpu", "--quiet"]
    assert cli.main(argv + ["--devices", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert summary["stable_fraction"] > 0.5 and summary["regularizer"] > 0
