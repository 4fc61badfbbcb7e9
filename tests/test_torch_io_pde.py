"""The PyTorch port's Euler and heat-multi exports against the JAX
package's, on the CPU: ``export_result`` of a small port run and
``gp_bayesopinf_tpu.io.export_result`` of the JAX package's result
dataclass rebuilt from the same arrays (basis, GPs and posterior built in
JAX from the port's), file by file, dataset by dataset; then the
reference's plotters on the port's files.

The runs are the small ones of ``tests/test_torch_slice.py`` (nx = 40,
m = 40, m' = 60, r = 3, with ``ddtdata``) and of
``tests/test_torch_heat_slice.py`` (L = 2, 30 interior points, 11 times,
m = 12, m' = 16, r = 3), each with 12 draws."""

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from _torch_io_common import assert_same_h5, host, j_basis, j_gps, j_posterior, j_rom
from gp_bayesopinf_tpu import io as jio
from gp_bayesopinf_tpu.bayes import BayesianROM as JBayesianROM
from gp_bayesopinf_tpu.models import Euler as JEuler
from gp_bayesopinf_tpu.pipeline.pdes import EulerResult as JEulerResult
from gp_bayesopinf_tpu.pipeline.pdes_multi import HeatMultiResult as JHeatResult
from gp_bayesopinf_tpu.viz import paper
from gp_bayesopinf_torch import io
from gp_bayesopinf_torch.pipeline import (
    EulerConfig, GPBounds, HeatMultiConfig, run_euler, run_heat_multi,
)

BOUNDS = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))
# Datasets the exporters compute (GP moments, basis products): rtol 1e-10.
COMPUTED = ("gp_means", "gp_stds", "true_states_compressed", "true_states_projected",
            "draws_full", "covs_0", "covs_1", "covs_2")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _j_bayes(bm):
    return JBayesianROM(j_rom(bm.model), j_posterior(bm.posterior), bm.regularizer)


@pytest.fixture(scope="module")
def euler_run():
    torch.set_num_threads(1)
    cfg = EulerConfig(spatial_domain=np.linspace(0, 2, 41)[:-1],
                      time_domain=np.linspace(0, 0.09, 61),
                      gp_bounds=GPBounds(*BOUNDS, 16), reg_grid=np.logspace(-10, 4, 9))
    return run_euler((0.0, 0.06), 40, 0.01, 60, 3, ndraws=12, config=cfg, ddtdata=True,
                     device="cpu", verbose=False)


@pytest.fixture(scope="module")
def heat_run():
    torch.set_num_threads(1)
    cfg = HeatMultiConfig(spatial_domain=np.linspace(0, 1, 32), time_domain=np.linspace(0, 2, 11),
                          input_parameters=((-2, 0), (2, 2)), test_parameters=(1.5, 0.5),
                          gp_bounds=GPBounds(*BOUNDS, 16), reg_grid=np.logspace(-1, 3, 5),
                          fom_substeps=2, rom_substeps=2)
    return run_heat_multi((0.0, 1.0), 12, 0.05, 16, 3, ndraws=12, config=cfg, device="cpu",
                          verbose=False)


def test_export_euler_matches_jax(tmp_path, euler_run):
    r = euler_run
    jres = JEulerResult(
        model=JEuler(np.asarray(r.model.spatial_domain)), basis=j_basis(r.basis),
        rom=j_rom(r.rom), bayesian_model=_j_bayes(r.bayesian_model), regularizer=r.regularizer,
        time_domain=r.time_domain, true_states=host(r.true_states),
        time_domain_sampled=r.time_domain_sampled, snapshots_sampled=host(r.snapshots_sampled),
        snapshots_compressed=host(r.snapshots_compressed), t_estimation=r.t_estimation,
        gps=j_gps(r.gps), draws_compressed=host(r.draws_compressed), valid=host(r.valid),
        draws=host(r.draws), svdvals=host(r.svdvals),
        ddtdata={k: host(v) for k, v in r.ddtdata.items()},
    )
    port, jax = str(tmp_path / "port" / "e"), str(tmp_path / "jax" / "e")
    io.export_result(r, port)
    jio.export_result(jres, jax)
    for suffix in ("_data-reduced.h5", "_data-full.h5", "-ddtdata.h5", "_posterior.h5"):
        assert_same_h5(port + suffix, jax + suffix, computed=COMPUTED)
    np.testing.assert_array_equal(np.load(port + "-svdvals.npy"), np.load(jax + "-svdvals.npy"))

    import matplotlib.pyplot as plt

    for fn in (paper.euler_reduced_figure, paper.euler_ddt_figure, paper.svdval_decay_figure,
               paper.euler_gpfit_figure, paper.euler_fomsolution_figure):
        assert fn(port)
        plt.close("all")


def test_export_heat_multi_matches_jax(tmp_path, heat_run):
    r = heat_run
    L = r.true_states.shape[0]
    jres = JHeatResult(
        basis=j_basis(r.basis), rom=j_rom(r.rom), bayesian_model=_j_bayes(r.bayesian_model),
        regularizer=r.regularizer, time_domain=r.time_domain,
        true_states=[host(x) for x in r.true_states], time_domain_sampled=r.time_domain_sampled,
        snapshots=[host(x) for x in r.snapshots],
        snapshots_compressed=[host(x) for x in r.snapshots_compressed],
        t_estimation=r.t_estimation, gps=[j_gps(row) for row in r.gps],
        draws_compressed=[host(x) for x in r.draws_compressed],
        valid=[host(x) for x in r.valid], newparam_draws=host(r.newparam_draws),
        newparam_valid=host(r.newparam_valid), newparam_true=host(r.newparam_true),
        spatial_domain=r.spatial_domain, input_parameters=r.input_parameters,
        test_parameters=r.test_parameters,
    )
    assert L == 2
    port, jax = str(tmp_path / "port" / "h"), str(tmp_path / "jax" / "h")
    io.export_result(r, port)
    jio.export_result(jres, jax)
    for suffix in ("_data.h5", "_posterior.h5"):
        assert_same_h5(port + suffix, jax + suffix, computed=COMPUTED)

    import matplotlib.pyplot as plt

    assert paper.heat_multi_figure(port)
    plt.close("all")
