"""The port's SEIRD layer against the JAX package's on the CPU: the truth
models, the operator map onto the quadratic screen, the data matrices,
the host noise model and ``BayesianODE``. Inputs come from numpy with a
seed; each test states its tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.bayes import BayesianODE as JBayesianODE
from gp_bayesopinf_tpu.bayes import OperatorPosterior as JPosterior
from gp_bayesopinf_tpu.models import SEIRD as JSEIRD
from gp_bayesopinf_tpu.models import SEIRD2 as JSEIRD2
from gp_bayesopinf_tpu.models.seird import _truncnorm_noise_np as j_truncnorm
from gp_bayesopinf_tpu.pipeline.configs import SEIRDConfig as JConfig
from gp_bayesopinf_tpu.pipeline.odes import sample_trajectory as j_sample_trajectory
from gp_bayesopinf_tpu.solve.ivp import rk4_solve_np as j_rk4_solve_np
from gp_bayesopinf_tpu.utils import host_rng, key_from_seed
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.bayes import (
    BayesianODE, KernelScreenSpec, OperatorPosterior, auto_regularize,
)
from gp_bayesopinf_torch.models import SEIRD, SEIRD2
from gp_bayesopinf_torch.models.seird import _truncnorm_noise_np
from gp_bayesopinf_torch.ops import ckron
from gp_bayesopinf_torch.pipeline import SEIRDConfig, sample_trajectory
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

P4 = np.array([0.25, 0.1, 0.095, 0.0025])  # ex1a's (p1, p2, p3, p4)
P6 = np.array([1000.0, 0.27, 0.09, 0.12, 0.015, 0.04])
Q0 = np.array([0.994, 0.005, 0.001, 0.0, 0.0])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _features(q):
    return torch.cat([torch.ones(1, dtype=q.dtype), q, ckron(q)])


@pytest.mark.parametrize("shape", [(4,), (1, 4)])
def test_cah_operators_four_parameters(rng, shape):
    """Equal to the reference's operators exactly (the same seven entries),
    and to ``derivative`` on random states at rtol 1e-12."""
    model = SEIRD2()
    O = model.cah_operators(_t(P4.reshape(shape)))
    assert O.shape == (5, 21) and O.dtype == torch.float64
    np.testing.assert_array_equal(O.numpy(), np.asarray(JSEIRD2().cah_operators(jnp.asarray(P4))))
    for _ in range(5):
        q = _t(rng.uniform(0.0, 1.0, size=5))
        np.testing.assert_allclose(
            (O @ _features(q)).numpy(), model.derivative(0.0, q, _t(P4)).numpy(), rtol=1e-12
        )


@pytest.mark.parametrize("shape", [(6,), (1, 6)])
def test_cah_operators_six_parameters(rng, shape):
    model = SEIRD()
    O = model.cah_operators(_t(P6.reshape(shape)))
    np.testing.assert_allclose(
        O.numpy(), np.asarray(JSEIRD().cah_operators(jnp.asarray(P6))), rtol=1e-15
    )
    q = _t(rng.uniform(0.0, 300.0, size=5))
    np.testing.assert_allclose(
        (O @ _features(q)).numpy(), model.derivative(0.0, q, _t(P6)).numpy(), rtol=1e-12
    )
    np.testing.assert_allclose(
        model.derivative(0.0, q, _t(P6)).numpy(),
        np.asarray(JSEIRD().derivative(0.0, jnp.asarray(q.numpy()), jnp.asarray(P6))), rtol=1e-14,
    )


def test_cah_operators_batch_equals_loop(rng):
    """A batch (N, 1, 4) of regression draws in one call: bit-equal to the
    reference's per-draw map."""
    draws = P4 * (1.0 + 0.3 * rng.standard_normal((12, 1, 4)))
    O = SEIRD2().cah_operators(_t(draws))
    assert O.shape == (12, 5, 21)
    want = np.asarray(jax.vmap(JSEIRD2().cah_operators)(jnp.asarray(draws)))
    np.testing.assert_array_equal(O.numpy(), want)


def test_convert_parameters_and_model(rng):
    cfg6 = JConfig().true_parameters6
    want = np.asarray(JSEIRD2.convert_parameters(cfg6))
    np.testing.assert_allclose(SEIRD2.convert_parameters(cfg6).numpy(), want, rtol=1e-15)
    batch = np.abs(rng.standard_normal((3, 6))) + 0.1
    got = SEIRD2.convert_parameters(_t(batch)).numpy()
    for row, g in zip(batch, got):
        np.testing.assert_allclose(g, np.asarray(JSEIRD2.convert_parameters(row)), rtol=1e-15)
    jmodel = JSEIRD2(parameters=tuple(want), substeps=8)
    model = convert.seird_model(jmodel)
    assert type(model) is SEIRD2 and model.substeps == 8
    assert model.parameters == tuple(float(p) for p in want)
    assert type(convert.seird_model(JSEIRD())) is SEIRD


def test_data_matrices_match_jax(rng):
    states = rng.uniform(0.0, 1.0, size=(5, 17))
    blocks = SEIRD2.data_matrix_blocks(_t(states))
    assert blocks.shape == (5, 17, 4)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(JSEIRD2.data_matrix_blocks(jnp.asarray(states)))
    )
    np.testing.assert_array_equal(
        SEIRD2.data_matrix(_t(states)).numpy(),
        np.asarray(JSEIRD2.data_matrix(jnp.asarray(states))),
    )


def test_batched_solve_matches_jax(rng):
    """One batched solve over parameter draws against the reference's
    solve of each draw, rtol 1e-10 (the same RK4 stepping in float64)."""
    t = np.linspace(0.0, 90.0, 31)
    draws = P4 * (1.0 + 0.1 * rng.standard_normal((4, 4)))
    model, jmodel = SEIRD2(tuple(P4), substeps=8), JSEIRD2(tuple(P4), substeps=8)
    got = model.solve(_t(Q0), _t(t), parameters=_t(draws))
    assert got.shape == (4, 5, 31)
    for g, p in zip(got, draws):
        want = np.asarray(jmodel.solve(Q0, t, parameters=jnp.asarray(p)))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-10, atol=1e-14)
    single = model.solve(_t(Q0), _t(t), strict=True)
    np.testing.assert_allclose(single.numpy(), np.asarray(jmodel.solve(Q0, t)),
                               rtol=1e-10, atol=1e-14)
    with pytest.raises(ValueError, match="sum to"):
        model.solve(_t(Q0 * 0.9), _t(t), strict=True)


def test_six_parameter_solve_matches_jax():
    t = np.linspace(0.0, 60.0, 16)
    q0 = 1000.0 * Q0
    got = SEIRD(substeps=4).solve(_t(q0), _t(t), strict=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(JSEIRD(substeps=4).solve(q0, t)),
                               rtol=1e-10, atol=1e-10)


def test_solve_host_matches_jax_and_device_solve():
    """The host RK4 against the reference's NumPy RK4, bit for bit, and
    against the port's own device solve at rtol 1e-12."""
    t = np.sort(np.random.default_rng(3).choice(90, size=20, replace=False)).astype(float)
    model = SEIRD2(tuple(P4), substeps=8)
    got = model.solve_host(Q0, t)
    want = j_rk4_solve_np(JSEIRD2(tuple(P4), substeps=8)._rhs_np(), Q0, t, substeps=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, model.solve(_t(Q0), _t(t)).numpy(), rtol=1e-12, atol=1e-16)
    six = SEIRD(substeps=4)
    np.testing.assert_array_equal(
        six.solve_host(1000.0 * Q0, t),
        j_rk4_solve_np(JSEIRD(substeps=4)._rhs_np(), 1000.0 * Q0, t, substeps=4),
    )


def test_truncnorm_noise_bit_equal_under_one_generator():
    states = JSEIRD2(tuple(P4), substeps=8).solve_host(Q0, np.linspace(0, 90, 40))
    states = np.asarray(states)
    got = _truncnorm_noise_np(np.random.default_rng(5), states, 0.1)
    want = j_truncnorm(np.random.default_rng(5), states, 0.1)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[3:, 0] == 0.0)  # R and D start at zero and stay there
    assert np.all((got >= 0.0) & (got <= 1.0))
    model = SEIRD2()
    np.testing.assert_array_equal(model.noise_host(np.random.default_rng(5), states, 0.0), states)
    np.testing.assert_array_equal(model.noise_host(np.random.default_rng(5), states, 0.1), want)


@pytest.mark.parametrize("synced,integersonly", [(False, True), (True, True), (False, False)])
def test_sample_trajectory_matches_jax(synced, integersonly):
    """The same NumPy stream through both data stages: the same sample
    times exactly, the snapshots at rtol 1e-12 (the reference may solve
    with its C++ core)."""
    key = key_from_seed(11)
    p4 = tuple(np.asarray(JSEIRD2.convert_parameters(JConfig().true_parameters6)))
    jt, jsnaps = j_sample_trajectory(key, JSEIRD2(p4, substeps=8), JConfig(), (0.0, 60.0), 24,
                                     0.1, synced=synced, integersonly=integersonly)
    t, snaps = sample_trajectory(host_rng(key), SEIRD2(p4, substeps=8), SEIRDConfig(),
                                 (0.0, 60.0), 24, 0.1, synced=synced, integersonly=integersonly)
    assert t.shape == snaps.shape == (5, 24)
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_allclose(snaps, np.asarray(jsnaps), rtol=1e-12)


@pytest.fixture
def posteriors(rng):
    """One Gaussian over four parameters with a dense covariance, in both
    packages, through ``from_moments``."""
    A = rng.standard_normal((4, 4))
    cov = 1e-4 * (A @ A.T + 0.5 * np.eye(4)) * np.outer(P4, P4) / P4.max() ** 2
    jpost = JPosterior.from_moments(jnp.asarray(P4), jnp.asarray(cov))
    post = OperatorPosterior.from_moments(_t(P4), _t(cov))
    return jpost, post, cov


def test_from_moments_matches_jax(posteriors):
    jpost, post, cov = posteriors
    assert post.means.shape == (1, 4) and post.cov_factors.shape == (1, 4, 4)
    np.testing.assert_allclose(post.cov_factors.numpy(), np.asarray(jpost.cov_factors),
                               rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(post.covariances()[0].numpy(), cov, rtol=1e-12, atol=1e-20)
    carried = convert.operator_posterior(jpost, device="cpu")
    np.testing.assert_array_equal(carried.cov_factors.numpy(), np.asarray(jpost.cov_factors))


def test_bayesian_ode_rvs_matches_jax(posteriors):
    """The reference's normals replayed through ``xi``: draws at rtol
    1e-12, with and without the nonnegative oversample."""
    jpost, post, _ = posteriors
    jmodel = JSEIRD2(tuple(P4), substeps=8)
    jode, ode = JBayesianODE(jmodel, jpost), BayesianODE(convert.seird_model(jmodel), post)
    assert ode.num_params == 4
    np.testing.assert_allclose(ode.mean.numpy(), np.asarray(jode.mean), rtol=1e-15)
    np.testing.assert_allclose(ode.cov.numpy(), np.asarray(jode.cov), rtol=1e-12, atol=1e-20)
    key = key_from_seed(3)
    xi = np.asarray(jax.random.normal(key, (10, 1, 4)))
    got = ode.rvs(xi=_t(xi))
    assert got.shape == (10, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jode.rvs(key, 10)), rtol=1e-12)
    # p4's mean is 1.4 standard deviations above zero at most, so some
    # candidates are negative and the oversample has work to do.
    wide = OperatorPosterior(post.means, 30.0 * post.cov_factors)
    jwide = JPosterior(jpost.means, 30.0 * jpost.cov_factors)
    xi8 = np.asarray(jax.random.normal(key, (80, 1, 4)))
    got = BayesianODE(ode.model, wide).rvs(xi=_t(xi8), nonnegative=True)
    want = np.asarray(JBayesianODE(jmodel, jwide).rvs(key, 10, nonnegative=True))
    assert got.shape == (10, 4) and bool((got >= 0).all())
    plain = BayesianODE(ode.model, wide).rvs(xi=_t(xi8))
    assert bool((plain < 0).any())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_bayesian_ode_solution_posterior_matches_jax(posteriors):
    """One batched ensemble against the reference's vmapped one on
    replayed normals: identical validity, draws at rtol 1e-10."""
    jpost, post, _ = posteriors
    jmodel = JSEIRD2(tuple(P4), substeps=8)
    jode, ode = JBayesianODE(jmodel, jpost), BayesianODE(convert.seird_model(jmodel), post)
    t = np.linspace(0.0, 120.0, 25)
    truth = np.asarray(jmodel.solve(Q0, t))
    shift = truth.mean(axis=1)
    limits = 1.05 * np.max(np.abs(truth - shift[:, None]), axis=1)  # tight: rejects some
    key = key_from_seed(4)
    xi = _t(np.asarray(jax.random.normal(key, (16, 1, 4))))
    want, want_valid = jode.solution_posterior(key, Q0, t, ndraws=16,
                                               stability_envelope=(shift, limits))
    got, valid = ode.solution_posterior(_t(Q0), _t(t), xi=xi,
                                        stability_envelope=(_t(shift), _t(limits)))
    assert got.shape == (16, 5, 25)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert 0 < int(valid.sum()) < 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-14)
    _, finite = ode.solution_posterior(_t(Q0), _t(t), xi=xi)
    assert bool(finite.all())
    one = ode.predict(_t(Q0), _t(t), xi=xi[:1])
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_generated_draws_follow_the_generator(posteriors):
    _, post, _ = posteriors
    ode = BayesianODE(SEIRD2(tuple(P4)), post)
    a = ode.rvs(6, generator=torch.Generator().manual_seed(1), nonnegative=True)
    b = ode.rvs(6, generator=torch.Generator().manual_seed(1), nonnegative=True)
    assert a.shape == (6, 4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_spec_requires_operator_map(rng):
    model = SEIRD2(tuple(P4), substeps=4)
    t_est = np.linspace(0.0, 60.0, 24)
    states = model.solve(_t(Q0), _t(t_est))
    ddts = model.derivative(0.0, states.T).T
    fac = weighted_lstsq_fit(model.data_matrix_blocks(states),
                             1e4 * torch.eye(24, dtype=torch.float64).expand(1, 5, 24, 24), ddts[None])
    assert fac.num_problems == 1 and fac.num_unknowns == 4
    spec = KernelScreenSpec("cAH", 5, substeps=4)
    with pytest.raises(ValueError, match="operator_map"):
        auto_regularize(fac, spec, states[:, 0], _t(np.linspace(0, 90, 30)), _t(t_est), states,
                        generator=torch.Generator().manual_seed(0),
                        grid=np.logspace(-8, 0, 3), ndraws=4, verbose=False)
    # With the map the same call runs, and the noise-free regression
    # recovers the parameters.
    res = auto_regularize(fac, spec, states[:, 0], _t(np.linspace(0, 90, 30)), _t(t_est), states,
                          generator=torch.Generator().manual_seed(0),
                          grid=np.logspace(-8, 0, 3), ndraws=4, verbose=False,
                          operator_map=model.cah_operators)
    assert np.isfinite(res.regularizer) and res.regularizer > 0
    np.testing.assert_allclose(fac.solve(1e-8)[0].numpy(), P4, rtol=1e-2)
