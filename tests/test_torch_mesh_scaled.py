"""``run_scaled(mesh=...)`` in 2 and 4 gloo ranks against the port's one-device
run on the same seed, at the size of the JAX package's
``tests/test_pipeline.py::test_scaled_pipeline_on_mesh`` (n 128, k 300, r 4,
m 80, m' 96, 2 restarts, 16 draws, grid 8, "cAH"), on the meshes {"draw": 2,
"mode": 1} and {"draw": 2, "mode": 2}.

From scratch a mesh sums the float32 POD's products and the compressed
snapshots over the ranks in another order than one device, so the front
half differs at float32 roundoff, and the GP fit's flat optimum and the
search carry that on. Stated tolerances, stage by stage: singular values
to 1e-4 of the largest, the compressed GP samples to 1e-5 of the largest,
the hyperparameters to 1e-3 in their logarithm; the grid's rejections and
argmin equal, lambda inside world 1's bracket of grid neighbours, the
ensemble mean within 1% of world 1's, and the JAX test's gates (stable
share > 0.5, a finite mean).

Resumed from world 1's checkpoint of the front half, the back half is
world 1's to the bit where it has no sum over ranks: the GP estimation,
the TSQR (the same row blocks; its problems split over "mode" and its rows
over "draw"), the grid (candidates split over "draw") and the refinement;
the ensembles' means, whose sums over the draws run over the ranks, to
1e-12 of the largest. Every rank returns the same result, bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _torch_mesh_common as common
from gp_bayesopinf_torch.parallel import spawn
from gp_bayesopinf_torch.pipeline import run_scaled
from gp_bayesopinf_torch.pipeline.scaled.search import REJECTED

SHAPES = {2: {"draw": 2, "mode": 1}, 4: {"draw": 2, "mode": 2}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1's run (with its checkpoint) and every rank's runs at world
    2 and 4: from scratch, resumed from world 1's checkpoint, and with 3
    modes (which do not divide over "mode" 2)."""
    ckpt = str(tmp_path_factory.mktemp("world1"))
    one = common._scaled_digest(run_scaled(**common.SCALED, checkpoint_dir=ckpt, device="cpu"))
    plan = [{}, dict(checkpoint_dir=ckpt), dict(num_modes=3)]
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        futures = {w: pool.submit(spawn, common.scaled_runs, w, ["cpu"] * w,
                                  args=(shape, plan), timeout=300)
                   for w, shape in SHAPES.items()}
        return one, {w: f.result() for w, f in futures.items()}


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_every_rank_returns_the_same_result(runs, world):
    _, ranks = runs
    for out in ranks[world][1:]:
        for mine, first in zip(out[:2], ranks[world][0][:2]):
            for key, value in first.items():
                np.testing.assert_array_equal(mine[key], value, err_msg=key)


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_front_half_from_scratch_matches_world_1(runs, world):
    one, ranks = runs
    res = ranks[world][0][0]
    assert {"data", "pod", "gp_fit"} <= set(res["stages"])
    sv1 = one["svdvals"]
    np.testing.assert_allclose(res["svdvals"], sv1, rtol=0, atol=1e-4 * sv1[0])
    np.testing.assert_array_equal(res["sample_times"], one["sample_times"])
    Y1 = one["samples"]
    np.testing.assert_allclose(res["samples"], Y1, rtol=0, atol=1e-5 * np.abs(Y1).max())
    np.testing.assert_allclose(np.log(res["hyperparameters"]), np.log(one["hyperparameters"]),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_back_half_from_scratch_matches_world_1(runs, world):
    one, ranks = runs
    res = ranks[world][0][0]
    errs, errs1 = res["grid_errors"], one["grid_errors"]
    np.testing.assert_array_equal(errs >= REJECTED, errs1 >= REJECTED)
    ibest = int(np.argmin(errs1))
    assert int(np.argmin(errs)) == ibest
    grid = np.logspace(-12, 6, common.SCALED["grid_size"])
    assert grid[ibest - 1] <= res["regularizer"] <= grid[ibest + 1]
    # The JAX test's gates.
    assert res["stable_fraction"] > 0.5 and np.isfinite(res["ensemble_mean"]).all()
    mean1 = one["ensemble_mean"]
    assert np.linalg.norm(res["ensemble_mean"] - mean1) < 0.01 * np.linalg.norm(mean1)


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_back_half_resumed_is_world_1_bit_for_bit(runs, world):
    one, ranks = runs
    res = ranks[world][0][1]
    assert not {"data", "pod", "gp_fit"} & set(res["stages"])
    for key in ("svdvals", "samples", "hyperparameters", "grid_errors"):
        np.testing.assert_array_equal(res[key], one[key], err_msg=key)
    assert res["regularizer"] == one["regularizer"]
    assert res["stable_fraction"] == one["stable_fraction"]
    mean1 = one["ensemble_mean"]
    np.testing.assert_allclose(res["ensemble_mean"], mean1, rtol=0,
                               atol=1e-12 * np.abs(mean1).max())
    np.testing.assert_allclose(res["train_error"], one["train_error"], rtol=1e-12)


def test_modes_must_divide_the_mode_axis(runs):
    _, ranks = runs
    assert [out[2] for out in ranks[4]] == ["num_modes must divide the 'mode' mesh axis"] * 4
    assert isinstance(ranks[2][0][2], dict)  # "mode" 1 takes 3 modes
