"""Parity of the PyTorch port's feature maps, kernel matrices, NLML and
bound transform with the JAX package, float64 against float64 on the CPU.

Tolerance: rtol 1e-12. Both sides evaluate the same closed forms in
float64; only the order of a few reductions differs.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# The packages re-export functions named like their modules (nlml, rbf).
jnlml = importlib.import_module("gp_bayesopinf_tpu.gp.nlml")
jquad = importlib.import_module("gp_bayesopinf_tpu.ops.quadratic")
jrbf = importlib.import_module("gp_bayesopinf_tpu.ops.rbf")
tnlml = importlib.import_module("gp_bayesopinf_torch.gp.nlml")
tquad = importlib.import_module("gp_bayesopinf_torch.ops.quadratic")
trbf = importlib.import_module("gp_bayesopinf_torch.ops.rbf")

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("r", [1, 3, 6])
def test_ckron_matches_jax(rng, r):
    rows_j, cols_j = jquad.ckron_indices(r)
    rows_t, cols_t = tquad.ckron_indices(r)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(cols_t, cols_j)
    Q = rng.standard_normal((r, 7))
    _close(tquad.ckron(_t(Q)), jquad.ckron(jnp.asarray(Q)))
    _close(tquad.ckron(_t(Q[:, 0])), jquad.ckron(jnp.asarray(Q[:, 0])))
    # Batched states along the last axis give the same features.
    _close(tquad.ckron(_t(Q.T), dim=-1), np.asarray(jquad.ckron(jnp.asarray(Q))).T)


@pytest.fixture
def times(rng):
    t = np.sort(rng.uniform(0, 0.06, 25))
    t_est = np.linspace(0, 0.06, 31)
    return t, t_est, 0.7, 4e-3, 1e-4


def test_rbf_and_grams_match_jax(times):
    t, t_est, s2, ell, chi = times
    _close(trbf.rbf(_t(t), _t(t_est), s2, ell), jrbf.rbf(jnp.asarray(t), jnp.asarray(t_est), s2, ell))
    _close(trbf.rbf_gram(_t(t), s2, ell, chi), jrbf.rbf_gram(jnp.asarray(t), s2, ell, chi))
    K_zy_t, K_zz_t = trbf.derivative_gram(_t(t_est), _t(t), s2, ell)
    K_zy_j, K_zz_j = jrbf.derivative_gram(jnp.asarray(t_est), jnp.asarray(t), s2, ell)
    scale = float(np.max(np.abs(np.asarray(K_zz_j))))
    _close(K_zy_t, K_zy_j, atol=1e-14 * float(np.max(np.abs(np.asarray(K_zy_j)))))
    _close(K_zz_t, K_zz_j, atol=1e-14 * scale)


def test_lstsq_kernel_matrices_match_jax_batched(times):
    t, t_est, s2, ell, chi = times
    want = jrbf.lstsq_kernel_matrices(jnp.asarray(t), jnp.asarray(t_est), s2, ell, chi)
    # A batch of two GPs: the second with other hyperparameters.
    T = _t(np.stack([t, t[::-1].copy()]))
    got = trbf.lstsq_kernel_matrices(
        T, _t(t_est), _t([s2, 2 * s2]), _t([ell, 1.5 * ell]), _t([chi, 3 * chi])
    )
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        _close(getattr(got, name)[0], w, atol=1e-14 * np.max(np.abs(w)))
    want2 = jrbf.lstsq_kernel_matrices(
        jnp.asarray(t[::-1].copy()), jnp.asarray(t_est), 2 * s2, 1.5 * ell, 3 * chi
    )
    for name in want2._fields:
        w = np.asarray(getattr(want2, name))
        _close(getattr(got, name)[1], w, atol=1e-14 * np.max(np.abs(w)))


def test_nlml_matches_jax(rng, times):
    t, _, _, _, _ = times
    y = np.sin(80 * t) + 0.01 * rng.standard_normal(t.size)
    # Noise levels that keep K's condition number below ~1e4: the two
    # sides factorize with different LAPACK/XLA Cholesky codes, and a
    # worse-conditioned K amplifies their roundoff past rtol 1e-12.
    params = np.log(np.array([[0.7, 4e-3, 1e-2], [2.0, 1e-2, 1e-1], [0.1, 2e-3, 1e-3]]))
    got = tnlml.nlml(_t(params), _t(np.broadcast_to(t, (3, t.size))), _t(np.broadcast_to(y, (3, t.size))))
    for i, p in enumerate(params):
        want = jnlml.nlml(jnp.asarray(p), jnp.asarray(t), jnp.asarray(y), method="chol")
        _close(got[i], want)


def test_nlml_failed_cholesky_is_inf(times):
    t, _, _, _, _ = times
    # A huge variance with a tiny noise floor is numerically singular.
    p = _t(np.log([1e8, 1.0, 1e-16]))
    assert torch.isinf(tnlml.nlml(p, _t(t), _t(np.ones_like(t))))


def test_box_transform_matches_jax(rng):
    bounds = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))
    jbox = jnlml.BoxTransform.from_bounds(*bounds)
    tbox = tnlml.BoxTransform.from_bounds(*bounds)
    _close(tbox.lo, jbox.lo)
    _close(tbox.hi, jbox.hi)
    z = rng.standard_normal((5, 3))
    _close(tbox.to_log_params(_t(z)), np.stack([jbox.to_log_params(jnp.asarray(zz)) for zz in z]))
    lp = np.asarray(jbox.to_log_params(jnp.asarray(z[0])))
    _close(tbox.from_log_params(_t(lp)), jbox.from_log_params(jnp.asarray(lp)), rtol=1e-10)
    # Clipping at the box edge.
    edge = np.asarray(jbox.lo) - 1.0
    _close(tbox.from_log_params(_t(edge)), jbox.from_log_params(jnp.asarray(edge)))
