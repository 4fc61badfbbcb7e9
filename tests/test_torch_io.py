"""The PyTorch port's HDF5 files against the JAX package's, on the CPU:
posterior round trips, files of either package read by the other, the
SEIRD export dataset for dataset against ``gp_bayesopinf_tpu.io``'s
export of the same result, the reference's SEIRD plotter on the port's
file, and the ImportError that names ``h5py`` where it is missing.

The SEIRD run is the small one of ``tests/test_torch_seird_slice.py``
(T = 60, m = 24, m' = 48, a 6-point grid) with 12 draws."""

import builtins

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from _torch_io_common import RTOL, assert_same_h5, host, j_gps, j_posterior, j_rom
from gp_bayesopinf_tpu import io as jio
from gp_bayesopinf_tpu.bayes import BayesianODE as JBayesianODE
from gp_bayesopinf_tpu.bayes import BayesianROM as JBayesianROM
from gp_bayesopinf_tpu.bayes import OperatorPosterior as JPosterior
from gp_bayesopinf_tpu.models import SEIRD2 as JSEIRD2
from gp_bayesopinf_tpu.pipeline.odes import SEIRDResult as JSEIRDResult
from gp_bayesopinf_torch import io
from gp_bayesopinf_torch.bayes import BayesianODE, BayesianROM, OperatorPosterior
from gp_bayesopinf_torch.models import SEIRD2
from gp_bayesopinf_torch.pipeline import GPBounds, SEIRDConfig, cli, run_seird
from gp_bayesopinf_torch.rom import GalerkinROM

f64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spd(rng, d, k):
    X = rng.standard_normal((k, d, d))
    return X @ X.transpose(0, 2, 1) + d * np.eye(d)


def _ode(rng):
    model = SEIRD2()
    mean, cov = np.abs(rng.standard_normal(4)) * 0.1, _spd(rng, 4, 1)[0]
    post = OperatorPosterior.from_moments(torch.as_tensor(mean)[None], torch.as_tensor(cov))
    return BayesianODE(model, post), mean, cov


def _rom(rng, structure="cAHBN", r=3, m=2):
    rom = GalerkinROM(structure, r, input_dimension=m, ivp_method="dirk2", substeps=3)
    d = rom.operator_dimension
    means, covs = rng.standard_normal((r, d)), _spd(rng, d, r)
    post = OperatorPosterior.from_moments(torch.as_tensor(means), torch.as_tensor(covs))
    return BayesianROM(rom, post, 0.25), means, covs


def test_bayesian_ode_round_trip(tmp_path, rng):
    """Means exact; covariances through their Cholesky factors, rtol 1e-10."""
    bm, mean, cov = _ode(rng)
    path = str(tmp_path / "ode.h5")
    io.save_bayesian_ode(bm, path)
    back = io.load_bayesian_ode(path, bm.model, device="cpu")
    np.testing.assert_array_equal(back.mean.numpy(), mean)
    np.testing.assert_allclose(back.cov.numpy(), cov, rtol=RTOL)
    with pytest.raises(FileExistsError):
        io.save_bayesian_ode(bm, path, overwrite=False)


def test_bayesian_rom_round_trip(tmp_path, rng):
    bm, means, covs = _rom(rng)
    path = str(tmp_path / "rom.h5")
    io.save_bayesian_rom(bm, path)
    back = io.load_bayesian_rom(path, device="cpu")
    assert back.model == bm.model and back.regularizer == 0.25 and back.ndims == 3
    np.testing.assert_array_equal(back.means.numpy(), means)
    np.testing.assert_allclose(back.covs.numpy(), covs, rtol=RTOL)
    # The loaded posterior integrates.
    t = torch.linspace(0.0, 0.1, 5, dtype=f64)
    u = lambda times: torch.stack([torch.sin(times), torch.cos(times)])
    draws, valid = back.solution_posterior(torch.zeros(3, dtype=f64), t, 4,
                                           generator=torch.Generator().manual_seed(0),
                                           input_func=u)
    assert draws.shape == (4, 3, 5) and bool(valid.all())


@pytest.mark.parametrize("kind", ["ode", "rom"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_posterior_files_cross_load(tmp_path, rng, kind, writer):
    """A file written by either package loads in the other: the same
    datasets and attributes, means exact, covariances rtol 1e-10."""
    if kind == "ode":
        bm, means, covs = _ode(rng)
        means, covs = means[None], covs[None]
        jbm = JBayesianODE(JSEIRD2(), j_posterior(bm.posterior))
        save, jsave = io.save_bayesian_ode, jio.save_bayesian_ode
        load = lambda p: io.load_bayesian_ode(p, bm.model, device="cpu")
        jload = lambda p: jio.load_bayesian_ode(p, JSEIRD2())
    else:
        bm, means, covs = _rom(rng)
        jbm = JBayesianROM(j_rom(bm.model), j_posterior(bm.posterior), bm.regularizer)
        save, jsave = io.save_bayesian_rom, jio.save_bayesian_rom
        load = lambda p: io.load_bayesian_rom(p, device="cpu")
        jload = jio.load_bayesian_rom
    port_path, jax_path = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    save(bm, port_path)
    jsave(jbm, jax_path)
    assert_same_h5(port_path, jax_path, computed=("cov", "covs_0", "covs_1", "covs_2"))
    if writer == "jax":
        back = load(jax_path)
        got_means, got_covs = back.posterior.means.numpy(), back.posterior.covariances().numpy()
        if kind == "rom":
            assert back.model == bm.model and back.regularizer == bm.regularizer
    else:
        back = jload(port_path)
        got_means = np.asarray(back.posterior.means)
        got_covs = np.asarray(back.posterior.covariances())
        if kind == "rom":
            assert back.model == jbm.model and back.regularizer == jbm.regularizer
    np.testing.assert_array_equal(got_means, means)
    np.testing.assert_allclose(got_covs, covs, rtol=RTOL)


@pytest.fixture(scope="module")
def seird_run():
    cfg = SEIRDConfig(time_domain=np.linspace(0, 90, 61),
                      gp_bounds=GPBounds((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5), 8),
                      reg_grid=np.logspace(-10, 2, 6))
    torch.set_num_threads(1)
    return run_seird((0.0, 60.0), 24, 0.05, 48, ndraws=12, config=cfg, device="cpu",
                     verbose=False)


def _j_seird_result(res):
    """The JAX package's ``SEIRDResult`` of the port's run's arrays."""
    model = JSEIRD2(parameters=tuple(res.model.parameters), substeps=res.model.substeps)
    bm = JBayesianODE(model, j_posterior(res.bayesian_model.posterior),
                      res.bayesian_model.regularizer)
    return JSEIRDResult(
        model=model, bayesian_model=bm, regularizer=res.regularizer,
        time_domain=res.time_domain, true_states=res.true_states,
        sample_times=list(res.sample_times), snapshots=res.snapshots,
        t_estimation=res.t_estimation, gps=j_gps(res.gps), draws=host(res.draws),
        valid=host(res.valid), newic_draws=host(res.newic_draws),
        newic_valid=host(res.newic_valid),
    )


def test_export_seird_matches_jax(tmp_path, seird_run):
    """``export_result`` of a SEIRD run against the JAX package's export of
    the same arrays: every group, dataset, attribute, shape and dtype;
    arrays exact, the GP moments and the covariance rtol 1e-10. The
    reference's plotter reads the port's file."""
    from gp_bayesopinf_tpu.viz import paper

    io.export_result(seird_run, str(tmp_path / "port" / "s"))
    jio.export_result(_j_seird_result(seird_run), str(tmp_path / "jax" / "s"))
    for suffix in ("_data.h5", "_posterior.h5"):
        assert_same_h5(str(tmp_path / "port" / f"s{suffix}"), str(tmp_path / "jax" / f"s{suffix}"),
                       computed=("gp_means", "gp_stds", "cov"))
    back = io.load_bayesian_ode(str(tmp_path / "port" / "s_posterior.h5"), seird_run.model,
                                device="cpu")
    np.testing.assert_array_equal(back.mean.numpy(), seird_run.bayesian_model.mean.numpy())
    import matplotlib.pyplot as plt

    assert paper.seird_figure(str(tmp_path / "port" / "s"))
    plt.close("all")


def _block_h5py(monkeypatch):
    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name.split(".")[0] == "h5py":
            raise ModuleNotFoundError("No module named 'h5py'", name="h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake_import)


def test_exportto_without_h5py(tmp_path, monkeypatch, seird_run):
    """Without h5py, ``export_result`` and ``--exportto`` raise an
    ImportError that names it, the command line before it runs the
    pipeline; nothing else needs it."""
    _block_h5py(monkeypatch)
    with pytest.raises(ImportError, match="h5py"):
        io.export_result(seird_run, str(tmp_path / "s"))
    runs = []
    monkeypatch.setattr(cli, "_run_pipeline", lambda args: runs.append(args) or seird_run)
    argv = ["seird", "60", "24", "0.05", "48", "--device", "cpu", "--nolog"]
    assert cli.main(argv) == 0 and len(runs) == 1
    with pytest.raises(ImportError, match="h5py"):
        cli.main(argv + ["--exportto", str(tmp_path / "s")])
    assert len(runs) == 1 and not list(tmp_path.iterdir())


def test_exportto_writes_files(tmp_path, monkeypatch, capsys, seird_run):
    monkeypatch.setattr(cli, "_run_pipeline", lambda args: seird_run)
    prefix = str(tmp_path / "out" / "s")
    assert cli.main(["seird", "60", "24", "0.05", "48", "--device", "cpu", "--nolog", "--noopen",
                     "--exportto", prefix]) == 0
    assert f"exported artifacts with prefix {prefix}" in capsys.readouterr().out
    assert (tmp_path / "out" / "s_data.h5").is_file()
    assert (tmp_path / "out" / "s_posterior.h5").is_file()


def test_load_rom_posterior_on_device_argument(tmp_path, rng):
    """``device`` is required by the loaders, as by every entry point."""
    bm, _, _ = _rom(rng, "cAH", 2, 0)
    path = str(tmp_path / "rom.h5")
    io.save_bayesian_rom(bm, path)
    with pytest.raises(TypeError):
        io.load_bayesian_rom(path)
    assert io.load_bayesian_rom(path, device="cpu").means.device.type == "cpu"
    # The JAX package reads the same file into a usable posterior.
    jbm = jio.load_bayesian_rom(path)
    assert isinstance(jbm.posterior, JPosterior)
    draws, _ = jbm.solution_posterior(jax.random.PRNGKey(0), jnp.zeros(2),
                                      jnp.linspace(0, 0.1, 4), ndraws=2)
    assert draws.shape == (2, 2, 4)
