"""The Cholesky weight root of the port against the JAX package's on the
CPU: ``spd_cholesky``, the ``method="chol"`` estimates, the regression
with ``weights_are_cholesky=True`` and ``precisions``, at rtol 1e-8; and
the Cholesky and eigh routes of the port giving one posterior.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.gp import estimates as jest
from gp_bayesopinf_tpu.ops.chol import spd_cholesky as j_spd_cholesky
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.gp import (
    batched_gp_estimates, fit_gaussian_processes, spd_cholesky,
)
from gp_bayesopinf_torch.gp.gp import resolve_weight_method
from gp_bayesopinf_torch.models import SEIRD2
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

ETA = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture
def problem(rng):
    """Five smooth signals on sample times of their own, with
    hyperparameters as a SEIRD fit gives them, and 40 estimation times."""
    m, r = 30, 5
    T = np.sort(rng.uniform(0, 60, (r, m)), axis=1)
    T[:, 0], T[:, -1] = 0.0, 60.0
    Y = np.stack([0.5 + 0.4 * np.sin(T[i] / (8.0 + i)) * (1 + 0.01 * rng.standard_normal(m))
                  for i in range(r)])
    hyper = (np.array([0.4, 0.02, 0.005, 0.02, 1e-3]), np.array([40.0, 30.0, 25.0, 35.0, 20.0]),
             np.array([1e-4, 1e-5, 1e-6, 1e-5, 1e-6]))
    return T, Y, np.linspace(0, 60, 40), hyper


def _both_estimates(problem, method):
    T, Y, t_est, hyper = problem
    want = jest.numpy_batched_gp_estimates(T, Y, t_est, *hyper, ETA, method=method)
    got = batched_gp_estimates(_t(T), _t(Y), _t(t_est), *map(_t, hyper), ETA, method=method)
    return want, got


def test_spd_cholesky_matches_jax(rng):
    A = rng.standard_normal((3, 12, 12))
    C = A @ A.transpose(0, 2, 1)
    L, ok = spd_cholesky(_t(C), 1e-3)
    assert bool(ok.all()) and ok.shape == (3,)
    for i in range(3):
        Lj, okj = j_spd_cholesky(jnp.asarray(C[i]), 1e-3)
        assert bool(okj)
        np.testing.assert_allclose(L[i].numpy(), np.asarray(Lj), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose((L @ L.transpose(-1, -2)).numpy(), C + 1e-3 * np.eye(12),
                               rtol=1e-12, atol=1e-12)
    C[1] -= 50.0 * np.eye(12)  # indefinite
    _, ok = spd_cholesky(_t(C), 1e-3)
    assert ok.tolist() == [True, False, True]
    assert not bool(j_spd_cholesky(jnp.asarray(C[1]), 1e-3)[1])


def test_chol_estimates_match_jax(problem):
    want, got = _both_estimates(problem, "chol")
    assert bool(got.ok.all()) and bool(np.all(want.ok))
    for name in ("state_estimate", "ddt_estimate"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-8, atol=1e-12)
    # The factor of C + eta I: C's small eigenvalues sit at roundoff, so
    # the factors are compared through the product they define.
    L, Lj = got.weight_root.numpy(), np.asarray(want.weight_root)
    assert np.all(np.triu(L, 1) == 0.0)
    scale = np.abs(Lj @ Lj.transpose(0, 2, 1)).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), Lj @ Lj.transpose(0, 2, 1),
                               rtol=1e-8, atol=1e-8 * scale.max())
    with pytest.raises(ValueError, match="unknown weight method"):
        batched_gp_estimates(*map(_t, problem[:3]), *map(_t, problem[3]), ETA, method="qr")


def test_chol_regression_and_precisions_match_jax(problem):
    """The reference's Cholesky factors carried across, then both
    regressions: singular values, means and precisions at rtol 1e-8."""
    want, _ = _both_estimates(problem, "chol")
    st = np.asarray(want.state_estimate)
    D = SEIRD2.data_matrix_blocks(_t(st))
    roots, rhs = np.asarray(want.weight_root)[None], np.asarray(want.ddt_estimate)[None]
    jfac = j_lstsq_fit(jnp.asarray(D.numpy()), jnp.asarray(roots), jnp.asarray(rhs),
                       weights_are_cholesky=True)
    fac = weighted_lstsq_fit(D, _t(roots), _t(rhs), weights_are_cholesky=True)
    np.testing.assert_allclose(fac.S.numpy(), np.asarray(jfac.S), rtol=1e-8)
    lam = 1e-3
    np.testing.assert_allclose(fac.solve(lam).numpy(), np.asarray(jfac.solve(lam)), rtol=1e-8)
    P, Pj = fac.precisions(lam).numpy(), np.asarray(jfac.precisions(lam))
    assert P.shape == (1, 4, 4)
    np.testing.assert_allclose(P, Pj, rtol=1e-8, atol=1e-8 * np.abs(Pj).max())
    np.testing.assert_allclose(P[0] @ fac.covariances(lam)[0].numpy(), np.eye(4), atol=1e-8)
    lams = _t(np.array([1e-3, 1.0]))
    assert fac.precisions(lams).shape == (2, 1, 4, 4)
    carried = convert.weighted_lstsq(jfac, device="cpu")
    np.testing.assert_allclose(carried.precisions(lam).numpy(), Pj, rtol=1e-12,
                               atol=1e-12 * np.abs(Pj).max())


def test_chol_and_eigh_routes_give_one_posterior(problem):
    """The two roots define the same weighted norm: posterior means at
    rtol 1e-6 (the eigh root is roundoff-determined on C's near-null
    space), in the port and in the reference alike."""
    means = {}
    for method in ("eigh", "chol"):
        want, got = _both_estimates(problem, method)
        D = SEIRD2.data_matrix_blocks(got.state_estimate)
        fac = weighted_lstsq_fit(D, got.weight_root[None], got.ddt_estimate[None],
                                 weights_are_cholesky=(method == "chol"))
        jfac = j_lstsq_fit(jnp.asarray(D.numpy()), jnp.asarray(want.weight_root)[None],
                           jnp.asarray(want.ddt_estimate)[None],
                           weights_are_cholesky=(method == "chol"))
        means[method] = fac.solve(1e-3).numpy()
        np.testing.assert_allclose(means[method], np.asarray(jfac.solve(1e-3)), rtol=1e-6)
    np.testing.assert_allclose(means["chol"], means["eigh"], rtol=1e-6)


def test_fit_gaussian_processes_weight_method(problem):
    T, Y, t_est, _ = problem
    kw = dict(n_restarts_optimizer=2, adam_steps=5, polish_iters=2)
    fits = {
        method: fit_gaussian_processes(_t(t_est), _t(T), _t(Y), weight_method=method,
                                       generator=torch.Generator().manual_seed(0), **kw)
        for method in ("eigh", "chol")
    }
    for e, c in zip(fits["eigh"], fits["chol"]):
        assert (e.weight_method, c.weight_method) == ("eigh", "chol")
        assert e.length_scale == c.length_scale
        # sqrtW^2 = (C + eta I)^{-1} = (L L^T)^{-1}, on a scale-free footing.
        W = (e.sqrtW @ e.sqrtW).numpy()
        LLt = (c.sqrtW @ c.sqrtW.T).numpy()
        resid = W @ LLt - np.eye(W.shape[0])
        assert np.abs(resid).max() < 1e-5
    carried = convert.gaussian_processes(fits["chol"], device="cpu")
    assert all(g.weight_method == "chol" for g in carried)


@pytest.mark.parametrize("given,points,want", [
    (None, 400, "eigh"), ("auto", 1023, "eigh"), ("eigh", 4096, "eigh"), ("chol", 4096, "chol"),
])
def test_resolve_weight_method(given, points, want):
    assert resolve_weight_method(given, points) == want


@pytest.mark.parametrize("given,points,error", [
    ("svd", 400, ValueError), ("LOWRANK", 3200, ValueError),
    ("cholesky", 1024, ValueError), ("dense", 400, ValueError),
])
def test_resolve_weight_method_refuses(given, points, error):
    with pytest.raises(error):
        resolve_weight_method(given, points)
