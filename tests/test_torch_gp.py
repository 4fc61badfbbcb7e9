"""The port's GP layer against the JAX package's on the CPU: the batched
hyperparameter fit with the JAX package's restart starts injected, and
the estimation products given equal hyperparameters.

Tolerances. Fit: per-mode full-data NLML at rtol 1e-6 and log
hyperparameters at rtol 1e-4, because float64 Cholesky roundoff (two
different LAPACK/XLA factorizations) is amplified over 60 Adam steps;
the reference's own cross-backend tolerance is rtol 1e-1
(``ODEs/main.py:155``). Estimates: rtol 1e-9.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.gp import estimates as jest
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.gp import estimates as test_
from gp_bayesopinf_torch.gp import gp as tgp

jfit = importlib.import_module("gp_bayesopinf_tpu.gp.fit")
jnlml = importlib.import_module("gp_bayesopinf_tpu.gp.nlml")
tfit = importlib.import_module("gp_bayesopinf_torch.gp.fit")
tnlml = importlib.import_module("gp_bayesopinf_torch.gp.nlml")

BOUNDS = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def data(rng):
    """Three smooth noisy signals at 48 shared sample times."""
    m = 48
    t = np.sort(rng.uniform(0, 0.06, m))
    t[0], t[-1] = 0.0, 0.06
    Y = np.stack([
        np.sin(60 * t) + 0.02 * rng.standard_normal(m),
        0.5 * np.cos(90 * t + 0.3) + 0.01 * rng.standard_normal(m),
        0.2 * t / 0.06 + 0.05 * np.sin(150 * t) + 0.005 * rng.standard_normal(m),
    ])
    return t, Y


def test_fit_matches_jax_with_injected_starts(data):
    t, Y = data
    r, n_restarts = Y.shape[0], 4
    key = jax.random.PRNGKey(7)
    jbox = jnlml.BoxTransform.from_bounds(*BOUNDS)
    kw = dict(n_restarts=n_restarts, screen_points=32, polish_points=40)
    want = jfit.fit_gp_hyperparameters(jnp.asarray(t), jnp.asarray(Y), jbox, key, **kw)
    # The starts the JAX fit drew, one key per mode.
    z0 = np.stack([
        np.asarray(jfit._initial_z(jbox, k, n_restarts))
        for k in jax.random.split(key, r)
    ])
    tbox = tnlml.BoxTransform.from_bounds(*BOUNDS, device="cpu")
    got = tfit.fit_gp_hyperparameters(
        torch.as_tensor(t), torch.as_tensor(Y), tbox, z0=torch.as_tensor(z0), **kw
    )
    want = convert.fit_result(want, device="cpu")
    np.testing.assert_allclose(got.nlml.numpy(), want.nlml.numpy(), rtol=1e-6)
    for name in ("sigma2", "ell", "chi"):
        np.testing.assert_allclose(
            np.log(getattr(got, name).numpy()), np.log(getattr(want, name).numpy()),
            rtol=1e-4,
        )


def test_initial_z_layout(data):
    """Restart 0 is the projected kernel default, as in the JAX package."""
    tbox = tnlml.BoxTransform.from_bounds(*BOUNDS, device="cpu")
    jbox = jnlml.BoxTransform.from_bounds(*BOUNDS)
    gen = torch.Generator().manual_seed(0)
    z0 = tfit.initial_z(tbox, 3, 5, gen)
    assert z0.shape == (3, 6, 3)
    want0 = np.asarray(jfit._initial_z(jbox, jax.random.PRNGKey(0), 5))[0]
    np.testing.assert_allclose(z0[:, 0].numpy(), np.broadcast_to(want0, (3, 3)), rtol=1e-12)
    # The random starts stay strictly inside the box.
    lp = tbox.to_log_params(z0[:, 1:])
    assert torch.all(lp > tbox.lo) and torch.all(lp < tbox.hi)


@pytest.fixture
def hyper():
    return np.array([0.6, 0.2, 0.05]), np.array([4e-3, 3e-3, 6e-3]), np.array([4e-4, 1e-4, 2.5e-5])


def test_estimates_match_jax_given_hyperparameters(data, hyper):
    t, Y = data
    s2, ell, chi = hyper
    t_est = np.linspace(0, 0.06, 60)
    T = np.broadcast_to(t, Y.shape).copy()
    want = convert.gp_estimates(
        jest.numpy_batched_gp_estimates(T, Y, t_est, s2, ell, chi, 1e-8, method="eigh"),
        device="cpu",
    )
    got = test_.batched_gp_estimates(
        torch.as_tensor(T), torch.as_tensor(Y), torch.as_tensor(t_est),
        torch.as_tensor(s2), torch.as_tensor(ell), torch.as_tensor(chi), 1e-8,
    )
    assert got.ok.all() and want.ok.all()
    for name in ("state_estimate", "ddt_estimate", "ddt_covariance"):
        w = getattr(want, name).numpy()
        np.testing.assert_allclose(
            getattr(got, name).numpy(), w, rtol=1e-9, atol=1e-9 * np.abs(w).max()
        )
    # The weight root (C + eta I)^{-1/2} is compared on the eigenvectors
    # of C above 1e-6 of its largest eigenvalue. C's smallest eigenvalues
    # (~1e-11 here) are roundoff of a matrix whose largest is ~5e4, at the
    # scale of eta = 1e-8, so on that subspace no two eigensolvers agree
    # (elementwise the roots differ by ~1e-3 for that reason alone).
    for C, r_got, r_want in zip(want.ddt_covariance.numpy(),
                                got.weight_root.numpy(), want.weight_root.numpy()):
        w, Q = np.linalg.eigh(C)
        Qb = Q[:, w > 1e-6 * w.max()]
        b = Qb.T @ r_want @ Qb
        np.testing.assert_allclose(
            Qb.T @ r_got @ Qb, b, rtol=1e-9, atol=1e-9 * np.abs(b).max()
        )


def test_gp_predict_matches_jax(data, hyper):
    t, Y = data
    s2, ell, chi = (float(h[0]) for h in hyper)
    tq = np.linspace(0, 0.06, 17)
    m_j, s_j = jest.gp_predict(jnp.asarray(t), jnp.asarray(Y[0]), jnp.asarray(tq), s2, ell, chi)
    gp = tgp.GaussianProcess(torch.as_tensor(t), torch.as_tensor(Y[0]), s2, ell, chi)
    m_t, s_t = gp.predict(torch.as_tensor(tq))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-9)
    # The predictive variance is the prior variance minus a nearly equal
    # quadratic form, so the std keeps fewer digits than the mean.
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-12)


def test_fit_gaussian_processes_end_to_end(data):
    """The port's entry point fits, estimates and returns per-mode views."""
    t, Y = data
    gen = torch.Generator().manual_seed(1)
    t_est = torch.linspace(0, 0.06, 50, dtype=torch.float64)
    gps = tgp.fit_gaussian_processes(
        t_est, torch.as_tensor(t), torch.as_tensor(Y), *BOUNDS,
        n_restarts_optimizer=4, generator=gen,
    )
    assert len(gps) == 3
    for gp in gps:
        assert gp.sqrtW.shape == (50, 50) and torch.isfinite(gp.sqrtW).all()
        assert gp.state_estimate.shape == (50,)
        for lo_hi, v in zip(BOUNDS, (gp.constant, gp.length_scale, gp.noise_level)):
            assert lo_hi[0] <= v <= lo_hi[1]
