"""The plotting methods of the PyTorch port's models (``Euler``,
``HeatBimodal``, ``SEIRD2``) against the JAX package's, on the CPU under
Agg, and the port's new basis, estimate and file-name helpers.

Each method draws the same seeded float64 NumPy arrays in both packages;
the figures are compared artist by artist (``tests/_torch_viz_common.py``)
and exactly. The port's methods also draw the same arrays as float32
tensors, which must give the float64 figure within float32 resolution:
``RTOL32`` = 4 eps(float32) ~ 4.8e-7 of each array's largest magnitude
(one rounding of the input and one of the reciprocal ``1 / zeta`` the
Euler plots draw). Animations are stepped by hand at frame 0 and a later
frame, since under Agg a ``FuncAnimation`` draws nothing until it is saved
or stepped.

The helpers are held against the JAX package at rtol 1e-10:
``PODBasis.project``, ``PODBasis.residual_energy``,
``EulerScaledBasis.scalers``, the one-variable ``gp_estimates`` and
``TRNFMT``, ``SPRSFMT``, ``NOISEFMT``, ``DIMFMT``.
"""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
from _torch_viz_common import assert_same_figure  # noqa: E402

from gp_bayesopinf_tpu import models as jmodels  # noqa: E402
from gp_bayesopinf_tpu.gp import gp_estimates as j_gp_estimates  # noqa: E402
from gp_bayesopinf_tpu.pipeline import configs as jconfigs  # noqa: E402
from gp_bayesopinf_tpu.rom import EulerScaledBasis as JEulerBasis  # noqa: E402
from gp_bayesopinf_tpu.rom import PODBasis as JPODBasis  # noqa: E402
from gp_bayesopinf_torch import models  # noqa: E402
from gp_bayesopinf_torch.gp import gp_estimates  # noqa: E402
from gp_bayesopinf_torch.pipeline import configs  # noqa: E402
from gp_bayesopinf_torch.rom import EulerScaledBasis, PODBasis  # noqa: E402

RTOL32 = 4 * float(np.finfo(np.float32).eps)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _arrays():
    rng = np.random.default_rng(11)
    nx, k = 16, 9
    vpz = np.vstack([100 + rng.standard_normal((nx, k)), 1e5 + rng.standard_normal((nx, k)),
                     0.05 + 0.001 * rng.standard_normal((nx, k))])
    return dict(
        x=np.linspace(0, 2, nx + 1)[:-1], t=np.linspace(0, 0.01, k), vpz=vpz,
        xh=np.linspace(0, 1, 14), heat=rng.standard_normal((14, k)),
        heat2=rng.standard_normal((3, 14, k)), traj=rng.random((5, k)),
    )


A = _arrays()
CMAP = plt.cm.viridis


def _fig(out):
    """The figure of whatever a plotting method returns."""
    if isinstance(out, tuple):
        out = out[0]
    return out if isinstance(out, plt.Figure) else out.get_figure()


# name -> (model class name, constructor arguments, call(model, convert)); ``convert``
# turns each array into what the method is given.
CALLS = {
    "euler.plot_space": ("Euler", (A["x"],), lambda m, c: m.plot_space(c(A["vpz"][:, 0]))),
    "euler.plot_time": ("Euler", (A["x"],), lambda m, c: m.plot_time(c(A["t"]), c(A["vpz"][3]))),
    "euler.plot_traces": ("Euler", (A["x"],),
                          lambda m, c: m.plot_traces(c(A["t"]), c(A["vpz"]), nlocs=4)),
    "euler.plot_traces-cmap-data": ("Euler", (A["x"],), lambda m, c: m.plot_traces(
        c(A["t"]), c(A["vpz"]), nlocs=3, cmap=CMAP, isdata=True)),
    "euler.plot_spacetime": ("Euler", (A["x"],),
                             lambda m, c: m.plot_spacetime(c(A["t"]), c(A["vpz"]))),
    "heat.plot_space": ("HeatBimodal", (A["xh"], 0.0, 1.0),
                        lambda m, c: m.plot_space(c(A["heat"][:, 0]))),
    "heat.plot_space-interior": ("HeatBimodal", (A["xh"], 0.5, 1.0),
                                 lambda m, c: m.plot_space(c(A["heat"][1:-1, :3].T))),
    "heat.plot_time": ("HeatBimodal", (A["xh"], 0.0, 1.0),
                       lambda m, c: m.plot_time(c(A["t"]), c(A["heat"][3:5]))),
    "heat.plot_spacetime": ("HeatBimodal", (A["xh"], 0.0, 1.0),
                            lambda m, c: m.plot_spacetime(c(A["t"]), c(A["heat"]), nlines=3)),
    "heat.plot_spacetime-interior": ("HeatBimodal", (A["xh"], 0.0, 1.0), lambda m, c:
                                     m.plot_spacetime(c(A["t"]), c(A["heat"][1:-1]))),
    "seird.plot": ("SEIRD2", (), lambda m, c: m.plot(c(A["t"]), c(A["traj"]))),
    "seird.plot-ls": ("SEIRD2", (), lambda m, c: m.plot(c(A["t"]), c(A["traj"]), ls="-")),
    "seird.plot_phase": ("SEIRD2", (), lambda m, c: m.plot_phase(c(A["t"]), c(A["traj"]),
                                                                 variables=(0, 2))),
    "seird.plot_phase-pair": ("SEIRD2", (), lambda m, c: m.plot_phase(c(A["t"]),
                                                                      c(A["traj"][3:]))),
}

CONVERT = {
    "numpy64": lambda a: a,
    "tensor64": lambda a: torch.as_tensor(a),
    "tensor32": lambda a: torch.as_tensor(a, dtype=torch.float32),
}


@pytest.mark.parametrize("name", sorted(CALLS))
@pytest.mark.parametrize("kind", sorted(CONVERT))
def test_model_plot_matches_jax(name, kind):
    cls, args, call = CALLS[name]
    ref = _fig(call(getattr(jmodels, cls)(*args), lambda a: a))
    got = _fig(call(getattr(models, cls)(*args), CONVERT[kind]))
    assert_same_figure(got, ref, rtol=RTOL32 if kind == "tensor32" else 0.0)


ANIMATIONS = {
    "euler": ("Euler", (A["x"],), lambda m, c: m.animate(c(A["vpz"]), skip=3), (0, 2)),
    "heat": ("HeatBimodal", (A["xh"], 0.0, 1.0), lambda m, c: m.animate(c(A["heat"])), (0, 7)),
    "heat-several": ("HeatBimodal", (A["xh"], 0.0, 1.0), lambda m, c: m.animate(
        c(A["heat2"]), labels=["a", "b", "c"], titles=False), (0, 5)),
}


@pytest.mark.parametrize("name", sorted(ANIMATIONS))
@pytest.mark.parametrize("kind", sorted(CONVERT))
def test_model_animation_matches_jax(name, kind):
    cls, args, call, frames = ANIMATIONS[name]
    ref = call(getattr(jmodels, cls)(*args), lambda a: a)
    got = call(getattr(models, cls)(*args), CONVERT[kind])
    assert got._save_count == ref._save_count  # the number of frames
    for frame in frames:
        ref._func(frame)
        got._func(frame)
        assert_same_figure(got._fig, ref._fig, rtol=RTOL32 if kind == "tensor32" else 0.0)


def test_model_plots_refuse_what_the_jax_package_refuses():
    for mod in (models, jmodels):
        with pytest.raises(ValueError, match="two dimensional"):
            mod.Euler(A["x"]).plot_spacetime(A["t"], A["vpz"][:, 0])
        with pytest.raises(ValueError, match="two-dimensional"):
            mod.Euler(A["x"]).animate(A["vpz"][:, 0])
        with pytest.raises(ValueError, match="not aligned"):
            mod.HeatBimodal(A["xh"]).plot_spacetime(A["t"][:-1], A["heat"])
        with pytest.raises(ValueError, match="3 Axes"):
            mod.SEIRD2.plot_phase(A["t"], A["traj"], fig=plt.figure())


# -- helpers ----------------------------------------------------------------------
def _snapshots(rng, n=3 * 12, k=15):
    scale = np.repeat([100.0, 1e5, 0.05], n // 3)[:, None]
    return scale * (1 + 0.1 * rng.standard_normal((n, k)))


@pytest.mark.parametrize("cls", ["PODBasis", "EulerScaledBasis"])
def test_basis_project_and_residual_energy_match_jax(cls):
    Q = _snapshots(np.random.default_rng(5))
    port = {"PODBasis": PODBasis, "EulerScaledBasis": EulerScaledBasis}[cls]
    ref = {"PODBasis": JPODBasis, "EulerScaledBasis": JEulerBasis}[cls]
    basis, jbasis = port.fit(torch.as_tensor(Q), 4), ref.fit(jnp.asarray(Q), num_vectors=4)
    np.testing.assert_allclose(basis.project(torch.as_tensor(Q)).numpy(),
                               np.asarray(jbasis.project(jnp.asarray(Q))),
                               rtol=RTOL, atol=RTOL * np.abs(Q).max())
    want = np.asarray(jbasis.residual_energy())
    np.testing.assert_allclose(basis.residual_energy().numpy(), want, rtol=RTOL, atol=1e-14)
    assert want[-1] == pytest.approx(0.0, abs=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_euler_scalers_match_jax(dtype):
    Q = _snapshots(np.random.default_rng(6))
    basis = EulerScaledBasis.fit(torch.as_tensor(Q, dtype=dtype), 3, v_ref=50.0, rho_ref=4.0)
    jbasis = JEulerBasis.fit(jnp.asarray(Q), num_vectors=3, v_ref=50.0, rho_ref=4.0)
    scalers = basis.scalers
    assert scalers.dtype == dtype and scalers.device == basis.entries.device
    np.testing.assert_allclose(scalers.double().numpy(), np.asarray(jbasis.scalers),
                               rtol=RTOL if dtype == torch.float64 else RTOL32)


@pytest.mark.parametrize("method", ["eigh", "chol"])
def test_gp_estimates_one_variable_matches_jax(method):
    rng = np.random.default_rng(8)
    t = np.sort(rng.uniform(0, 1, 14))
    y, t_est = np.sin(5 * t) + 0.05 * rng.standard_normal(14), np.linspace(0, 1, 10)
    hyper = (1.3, 0.4, 1e-3)
    got = gp_estimates(torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(t_est), *hyper,
                       eta=1e-8, method=method)
    ref = j_gp_estimates(jnp.asarray(t), jnp.asarray(y), jnp.asarray(t_est), *hyper,
                         eta=1e-8, method=method)
    for name in ("state_estimate", "ddt_estimate", "ddt_covariance"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=name)
    assert got.state_estimate.shape == (10,) and bool(got.ok)
    if method == "chol":  # the eigh root is roundoff-determined on C's near-null space
        want = np.asarray(ref.weight_root)
        np.testing.assert_allclose(got.weight_root.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("name, args", [
    ("TRNFMT", (7,)), ("TRNFMT", (1234,)), ("SPRSFMT", (0.25,)), ("SPRSFMT", (0.5,)),
    ("NOISEFMT", (0,)), ("NOISEFMT", (0.03,)), ("NOISEFMT", (0.1,)), ("DIMFMT", (3,)),
    ("DIMFMT", (12,)),
])
def test_file_name_formatters_match_jax(name, args):
    assert getattr(configs, name)(*args) == getattr(jconfigs, name)(*args)
