"""The reference API that the PyTorch port added last, against the JAX
package on the CPU with the same inputs (and JAX's own normals replayed):
``blocked_gamma_diag``, ``BayesianROM``'s moments, draws and prediction,
the ``GaussianProcess`` methods, ``GalerkinROM.extract_operators`` and
``rhs``, ``thomas_solve``, the heat model's operators and device solve,
and ``SEIRD2.noise``. Tolerances are stated at each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_bayesopinf_tpu.bayes import BayesianROM as JBayesianROM
from gp_bayesopinf_tpu.bayes import OperatorPosterior as JPosterior
from gp_bayesopinf_tpu.gp import GaussianProcess as JGP
from gp_bayesopinf_tpu.models import CubicHeatBimodal as JCubic
from gp_bayesopinf_tpu.models import HeatBimodal as JHeat
from gp_bayesopinf_tpu.models.seird import _truncnorm_noise_np as j_truncnorm_np
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.rom import blocked_gamma_diag as j_blocked_gamma_diag
from gp_bayesopinf_tpu.solve.ivp import thomas_solve as j_thomas_solve
from gp_bayesopinf_torch.bayes import BayesianROM, OperatorPosterior
from gp_bayesopinf_torch.gp import GaussianProcess
from gp_bayesopinf_torch.models import CubicHeatBimodal, HeatBimodal, SEIRD2
from gp_bayesopinf_torch.rom import GalerkinROM, blocked_gamma_diag, operator_splits
from gp_bayesopinf_torch.solve import dirk2_solve, thomas_solve

f64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("structure,r,m,lams,default", [
    ("cAH", 4, 0, {"c": 0.5, "A": 0.5, "H": 3.0}, 0.0),
    ("cAHBN", 3, 2, {"H": 1e-3, "N": 7.0}, 0.25),
    ("AH", 5, 0, None, 2.0),
])
def test_blocked_gamma_diag_exact(structure, r, m, lams, default):
    got = blocked_gamma_diag(structure, r, m, lams, default, device="cpu")
    want = np.asarray(j_blocked_gamma_diag(structure, r, m, lams, default))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert operator_splits(structure, r, m)[-1][2] == got.shape[0]
    lam = torch.tensor(0.125, dtype=f64)  # a tensor value is taken as it is
    assert float(blocked_gamma_diag(structure, r, m, {"H": lam}, device="cpu").max()) == 0.125


def test_blocked_gamma_diag_rejects_unknown_letters():
    with pytest.raises(ValueError, match="unknown operators"):
        blocked_gamma_diag("cAH", 2, lams={"Q": 1.0}, device="cpu")


def _rom_posterior(rng, structure, r, m, ivp, substeps):
    rom, jrom = (cls(structure, r, input_dimension=m, ivp_method=ivp, substeps=substeps)
                 for cls in (GalerkinROM, JROM))
    d = rom.operator_dimension
    means = 0.1 * rng.standard_normal((r, d))
    means[:, 1:1 + r] -= np.eye(r)  # decaying dynamics
    F = np.tril(0.01 * rng.standard_normal((r, d, d))) + 0.01 * np.eye(d)
    bm = BayesianROM(rom, OperatorPosterior(_t(means), _t(F)), 0.5)
    jbm = JBayesianROM(jrom, JPosterior(jnp.asarray(means), jnp.asarray(F)), 0.5)
    return bm, jbm


def test_bayesian_rom_moments_and_draws(rng):
    """``ndims``, ``means`` exact; ``covs`` rtol 1e-12; ``rvs`` with JAX's
    normals replayed rtol 1e-12."""
    bm, jbm = _rom_posterior(rng, "cAH", 3, 0, "rk4", 4)
    assert bm.ndims == jbm.ndims == 3
    np.testing.assert_array_equal(bm.means.numpy(), np.asarray(jbm.means))
    np.testing.assert_allclose(bm.covs.numpy(), np.asarray(jbm.covs), rtol=1e-12)
    key = jax.random.PRNGKey(7)
    xi = jax.random.normal(key, (5, 3, bm.model.operator_dimension), dtype=jnp.float64)
    np.testing.assert_allclose(bm.rvs(5, xi=_t(xi)).numpy(), np.asarray(jbm.rvs(key, 5)),
                               rtol=1e-12)
    drawn = bm.rvs(4, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 3, bm.model.operator_dimension)


def test_bayesian_rom_predict(rng):
    """One draw integrated: rk4 "cAH" and dirk2 "cAHBN" with inputs, JAX's
    normals replayed, rtol 1e-10."""
    t = np.linspace(0.0, 0.5, 11)
    key = jax.random.PRNGKey(3)
    for structure, m, ivp in (("cAH", 0, "rk4"), ("cAHBN", 2, "dirk2")):
        bm, jbm = _rom_posterior(rng, structure, 3, m, ivp, 2)
        q0 = rng.standard_normal(3)
        xi = jax.random.normal(key, (1, 3, bm.model.operator_dimension), dtype=jnp.float64)
        port_u = jax_u = None
        if m:
            port_u = lambda times: torch.stack([torch.sin(3 * times), torch.cos(times)])
            jax_u = lambda s: jnp.stack([jnp.sin(3 * s), jnp.cos(s)])
        got = bm.predict(_t(q0), _t(t), input_func=port_u, xi=_t(xi))
        want = jbm.predict(key, jnp.asarray(q0), jnp.asarray(t), input_func=jax_u)
        assert got.shape == (3, t.size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)


def _gps(rng, t=None):
    t = np.sort(rng.uniform(0, 1, 15)) if t is None else t
    y = np.sin(5 * t) + 0.01 * rng.standard_normal(t.size)
    hyper = (1.3, 0.21, 1e-4)
    return GaussianProcess(_t(t), _t(y), *hyper), JGP(jnp.asarray(t), jnp.asarray(y), *hyper)


def test_gaussian_process_methods(rng):
    """``nsamples``, ``prediction_bounds`` (every kind), ``__call__`` and
    ``rbf_eval`` against the JAX GP, rtol 1e-10."""
    gp, jgp = _gps(rng)
    assert gp.nsamples == jgp.nsamples == 15
    tq = np.linspace(-0.1, 1.1, 9)
    for kind in ("std", "95%", "2std", "3std"):
        for a, b in zip(gp.prediction_bounds(_t(tq), kind), jgp.prediction_bounds(tq, kind)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError):
        gp.prediction_bounds(_t(tq), "99%")
    t2 = np.concatenate([tq[:4], np.asarray(gp.t_training[:3])])
    np.testing.assert_allclose(gp(_t(tq), _t(t2)).numpy(), np.asarray(jgp(tq, t2)), rtol=1e-10)
    assert float(gp(_t(t2), _t(t2))[5, 5]) == pytest.approx(1.3 + 1e-4, rel=1e-12)
    np.testing.assert_allclose(gp.rbf_eval(_t(tq), _t(t2)).numpy(),
                               np.asarray(jgp.rbf_eval(tq, t2)), rtol=1e-10)


@pytest.mark.parametrize("method", ["eigh", "chol"])
def test_compute_lstsq_matrices(rng, method):
    """The estimates and the derivative covariance at the default eta
    1e-8, rtol 1e-10 of their scale; the weight root at eta 1e-1, where
    C + eta I is well conditioned (at 1e-8 the root is roundoff-determined
    on C's near-null space), rtol 1e-10."""
    t_est = np.linspace(0, 1, 12)
    for eta in (1e-8, 1e-1):
        gp, jgp = _gps(np.random.default_rng(5))
        assert gp.compute_lstsq_matrices(_t(t_est), eta, method) is gp
        jgp.compute_lstsq_matrices(t_est, eta, method)
        assert gp.weight_method == method and gp.t_estimation.shape == (12,)
        names = ["state_estimate", "ddt_estimate", "ddt_covariance"] + (["sqrtW"] if eta > 1e-3
                                                                        else [])
        for name in names:
            want = np.asarray(getattr(jgp, name))
            np.testing.assert_allclose(getattr(gp, name).numpy(), want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max(), err_msg=name)


def test_compute_lstsq_matrices_not_spd_raises(rng):
    """Duplicate sample times and eta = 0: the weight covariance is not
    positive definite, and both packages raise the same ValueError."""
    t = np.repeat(np.linspace(0, 1, 6), 2)
    gp, jgp = _gps(rng, t)
    for g, t_est in ((gp, _t(t)), (jgp, t)):
        with pytest.raises(ValueError, match="increase eta"):
            g.compute_lstsq_matrices(t_est, eta=0.0)


def test_rom_extract_operators_and_rhs(rng):
    """Named blocks exact; the right-hand side with inputs at one time,
    rtol 1e-12."""
    rom, jrom = GalerkinROM("cAHBN", 3, input_dimension=2), JROM("cAHBN", 3, input_dimension=2)
    O = rng.standard_normal((3, rom.operator_dimension))
    got, want = rom.extract_operators(_t(O)), jrom.extract_operators(jnp.asarray(O))
    assert list(got) == list(want) == ["c", "A", "H", "B", "N"]
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    q = rng.standard_normal(3)
    port_u = lambda times: torch.stack([torch.sin(times), 2 * torch.cos(times)])
    jax_u = lambda s: jnp.stack([jnp.sin(s), 2 * jnp.cos(s)])
    np.testing.assert_allclose(rom.rhs(_t(O), 0.3, _t(q), port_u).numpy(),
                               np.asarray(jrom.rhs(jnp.asarray(O), 0.3, jnp.asarray(q), jax_u)),
                               rtol=1e-12)
    auto, jauto = GalerkinROM("cAH", 3), JROM("cAH", 3)
    O = O[:, :auto.operator_dimension]
    np.testing.assert_allclose(auto.rhs(_t(O), 0.0, _t(q)).numpy(),
                               np.asarray(jauto.rhs(jnp.asarray(O), 0.0, jnp.asarray(q))),
                               rtol=1e-12)


def test_thomas_solve_matches_jax(rng):
    """Batches of diagonally dominant systems in the gtsv layout (dl[0],
    du[-1] are set to garbage: unused) against JAX's tridiagonal solve,
    rtol 1e-12."""
    B, n = 4, 9
    dl, du = rng.standard_normal((B, n)), rng.standard_normal((B, n))
    d = 4.0 + np.abs(rng.standard_normal((B, n)))
    dl[:, 0], du[:, -1] = 1e3, -1e3
    b = rng.standard_normal((B, n))
    got = thomas_solve(_t(dl), _t(d), _t(du), _t(b))
    want = np.stack([np.asarray(j_thomas_solve(*(jnp.asarray(x[i]) for x in (dl, d, du, b))))
                     for i in range(B)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    # Leading axes broadcast: one matrix, several right-hand sides.
    many = thomas_solve(_t(dl[0]), _t(d[0]), _t(du[0]), _t(b))
    np.testing.assert_allclose(many[0].numpy(), want[0], rtol=1e-12)
    with pytest.raises(ValueError, match="exactly one"):
        dirk2_solve(lambda j, q: -q, _t(np.ones(2)), _t(np.linspace(0, 1, 3)))


@pytest.mark.parametrize("cls,jcls", [(HeatBimodal, JHeat), (CubicHeatBimodal, JCubic)])
def test_heat_operators_exact_and_device_solve(cls, jcls):
    """``stiffness``, ``constant``, ``input_matrix`` and ``jacobian`` exact;
    the device ``solve`` against the JAX model's ``solve`` rtol 1e-8."""
    x = np.linspace(0, 1, 22)
    kw = dict(left_bc=0.0, right_bc=1.0, diffusion=1e-2, a=1.5, b=-0.5, substeps=2)
    model, jmodel = cls(x, **kw), jcls(x, **kw)
    for name in ("stiffness", "constant", "input_matrix"):
        np.testing.assert_array_equal(getattr(model, name), np.asarray(getattr(jmodel, name)))
    q0 = np.asarray(jcls.initial_conditions(x, 0.0, 1.0))
    inner = q0[1:-1]
    np.testing.assert_array_equal(model.jacobian(0.1, _t(inner)).numpy(),
                                  np.asarray(jmodel.jacobian(0.1, jnp.asarray(inner))))
    np.testing.assert_array_equal(model.jacobian(0.1, inner.copy()),
                                  np.asarray(jmodel.jacobian(0.1, jnp.asarray(inner))))
    t = np.linspace(0.0, 0.5, 6)
    got = model.solve(_t(q0), _t(t))
    want = np.asarray(jmodel.solve(jnp.asarray(q0), jnp.asarray(t)))
    assert got.shape == (22, 6) and got.dtype == f64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(model.solve(_t(inner), _t(t)).numpy(), want, rtol=1e-8,
                               atol=1e-12)  # the interior alone, boundary rows added
    np.testing.assert_allclose(got.numpy(), model.solve_host(q0, t), rtol=1e-8, atol=1e-12)


def test_heat_solve_boundary_errors():
    model = HeatBimodal(np.linspace(0, 1, 12))
    q0 = torch.as_tensor(model.initial_conditions(model.spatial_domain, 0.0, 1.0))
    t = torch.linspace(0, 0.1, 3, dtype=f64)
    bad = q0.clone()
    bad[-1] = 0.5
    with pytest.raises(ValueError, match="do not match the Dirichlet boundary conditions"):
        model.solve(bad, t)
    with pytest.raises(ValueError, match=r"must have 10 \(interior\) or 12 \(full-grid\)"):
        model.solve(q0[:-3], t)


def test_seird_noise(rng):
    """Injected uniforms give the host twin's numbers (1e-12); drawn from
    a generator, the noise stays in [0, 1] and keeps exact zeros."""
    states = np.abs(rng.uniform(0, 1, (5, 40)))
    states[3, :5] = 0.0
    states[4, 7] = 1.0
    u = rng.uniform(size=states.shape)

    class Replay:
        def uniform(self, size):
            assert size == u.shape
            return u

    model = SEIRD2()
    got = model.noise(_t(states), 0.1, u=_t(u))
    np.testing.assert_allclose(got.numpy(), j_truncnorm_np(Replay(), states, 0.1), rtol=0,
                               atol=1e-12)
    drawn = model.noise(_t(states), 0.3, generator=torch.Generator().manual_seed(1))
    assert bool(((drawn >= 0) & (drawn <= 1)).all())
    assert bool((drawn[3, :5] == 0).all()) and not torch.equal(drawn, _t(states))
    np.testing.assert_array_equal(model.noise(_t(states), 0.0).numpy(), states)
