"""The tall-matrix factorizations of the PyTorch port (``parallel.sharded``)
against the JAX package's on the CPU (no mesh there) and against
``torch.linalg.svd``, from the same seeded matrices, the POD sketch
replayed.

Tolerances, in terms of the input's dtype: singular values to rtol 1e-6
of the largest in float32 (the TSQR contract is ~eps of the input) and
1e-12 in float64; subspaces by the sine of the largest principal angle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.parallel import sharded as jsh
from gp_bayesopinf_torch.parallel import randomized_pod, sharded_gram_pod, tall_skinny_svd
from gp_bayesopinf_torch.solve import weighted_lstsq_fit


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _sin_angle(A, B):
    """Sine of the largest principal angle between the column spans."""
    Qa, Qb = np.linalg.qr(A)[0], np.linalg.qr(B)[0]
    s = np.linalg.svd(Qa.T @ Qb, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def _stack(rng, dtype):
    """(3, 96, 5) tall problems with singular values over four decades."""
    X = rng.standard_normal((3, 96, 5)) * np.logspace(0, -4, 5)
    return X.astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_tall_skinny_svd_matches_jax_and_lapack(rng, dtype, tol):
    X = _stack(rng, dtype)
    U, S, V = tall_skinny_svd(_t(X))
    jU, jS, jV = jsh.tall_skinny_svd(jnp.asarray(X))
    assert U.shape == (3, 96, 5) and S.shape == (3, 5) and V.shape == (3, 5, 5)
    assert U.dtype == S.dtype == V.dtype == _t(X).dtype
    exact = np.linalg.svd(X.astype(np.float64), compute_uv=False)
    smax = exact.max()
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=0, atol=tol * smax)
    np.testing.assert_allclose(S.numpy(), exact, rtol=0, atol=tol * smax)
    assert bool((S[:, :-1] >= S[:, 1:]).all())
    # X = U diag(S) V^T, V orthogonal, V equal to JAX's up to column signs.
    recon = (U * S[:, None, :]) @ V.transpose(-1, -2)
    np.testing.assert_allclose(recon.numpy(), X, rtol=0, atol=10 * tol * smax)
    eye = np.broadcast_to(np.eye(5), (3, 5, 5))
    np.testing.assert_allclose((V.transpose(-1, -2) @ V).numpy(), eye, atol=100 * tol)
    signs = np.sign(np.sum(V.numpy() * np.asarray(jV), axis=1, keepdims=True))
    np.testing.assert_allclose(V.numpy() * signs, np.asarray(jV), atol=1e3 * tol)


@pytest.mark.parametrize("row_blocks,blocks", [(None, 8), (1, 1), (5, 4), (64, 16)])
def test_tall_skinny_svd_row_blocks(rng, row_blocks, blocks):
    """Any block count gives the same factorization; the count is capped
    at M // d and lowered to a divisor of M (96 rows, d = 5: at most 19)."""
    X = _stack(rng, np.float64)
    _, S, _ = tall_skinny_svd(_t(X), row_blocks=row_blocks)
    np.testing.assert_allclose(S.numpy(), np.linalg.svd(X, compute_uv=False), rtol=1e-10)
    P = max(1, min(8 if row_blocks is None else row_blocks, 96 // 5))
    while 96 % P:
        P -= 1
    assert P == blocks


def test_tall_skinny_svd_serves_the_regression_and_takes_no_mesh(rng):
    """Without a mesh the three factorizations give one device's result
    (their mesh forms: ``tests/test_torch_mesh.py``)."""
    X = _stack(rng, np.float64)
    for mine, one in zip(tall_skinny_svd(_t(X), mesh=None), tall_skinny_svd(_t(X))):
        assert torch.equal(mine, one)
    pods = [randomized_pod(_t(X[0]), 2, oversample=2, generator=torch.Generator().manual_seed(0),
                           **kw) for kw in (dict(mesh=None, row_axis="seq"), {})]
    for mine, one in zip(*pods):
        assert torch.equal(mine, one)
    for mine, one in zip(sharded_gram_pod(_t(X[0]), 2, mesh=None), sharded_gram_pod(_t(X[0]), 2)):
        assert torch.equal(mine, one)
    D = rng.standard_normal((1, 96, 5))
    roots = np.broadcast_to(np.eye(96), (3, 1, 96, 96))
    rhs = rng.standard_normal((3, 1, 96))
    dense = weighted_lstsq_fit(_t(D), _t(roots), _t(rhs))
    tsqr = weighted_lstsq_fit(_t(D), _t(roots), _t(rhs), svd_fn=tall_skinny_svd)
    np.testing.assert_allclose(tsqr.S.numpy(), dense.S.numpy(), rtol=1e-12)
    np.testing.assert_allclose(tsqr.solve(1e-3).numpy(), dense.solve(1e-3).numpy(), rtol=1e-9)


def _snapshots(rng, n, k, rank, dtype):
    """(n, k) snapshots with a POD-like spectrum plus a little noise."""
    left = np.linalg.qr(rng.standard_normal((n, rank)))[0]
    right = np.linalg.qr(rng.standard_normal((k, rank)))[0]
    X = (left * np.logspace(0, -3, rank)) @ right.T + 1e-5 * rng.standard_normal((n, k))
    return X.astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-9)])
def test_randomized_pod_matches_jax_with_the_sketch_replayed(rng, dtype, tol):
    n, k, nv = 120, 80, 6
    X = _snapshots(rng, n, k, 20, dtype)
    key = jax.random.PRNGKey(4)
    jU, jS = jsh.randomized_pod(jnp.asarray(X), nv, oversample=8, key=key)
    Omega = np.asarray(jax.random.normal(key, (k, nv + 8), dtype=X.dtype))
    U, S = randomized_pod(_t(X), nv, oversample=8, Omega=_t(Omega))
    assert U.shape == (n, nv) and S.shape == (nv + 8,) and S.dtype == torch.float64
    assert U.dtype == _t(X).dtype
    exact_U, exact_S, _ = np.linalg.svd(X.astype(np.float64), full_matrices=False)
    np.testing.assert_allclose(S.numpy()[:nv], np.asarray(jS)[:nv], rtol=0, atol=tol * exact_S[0])
    np.testing.assert_allclose(S.numpy()[:nv], exact_S[:nv], rtol=0, atol=tol * exact_S[0])
    assert _sin_angle(U.numpy().astype(np.float64), np.asarray(jU, np.float64)) < 100 * tol
    assert _sin_angle(U.numpy().astype(np.float64), exact_U[:, :nv]) < 100 * tol
    np.testing.assert_allclose((U.T @ U).numpy(), np.eye(nv), atol=100 * tol)
    # Its own sketch from a generator: the same subspace.
    U2, S2 = randomized_pod(_t(X), nv, oversample=8, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(S2.numpy()[:nv], exact_S[:nv], rtol=0, atol=tol * exact_S[0])
    assert _sin_angle(U2.numpy().astype(np.float64), exact_U[:, :nv]) < 100 * tol
    with pytest.raises(ValueError, match="rank bound"):
        randomized_pod(_t(X[:4]), nv)


def test_randomized_pod_with_a_sketch_wider_than_the_rank(rng):
    """Rank 10 under noise at 1e-5 and a 14-column sketch, float32: four
    sketch directions lie below the Gram matrix's own roundoff. The floor
    at eps of the dtype keeps them from being scaled up: singular values
    to 1e-4 of the largest, an orthonormal basis, whatever the sketch."""
    X = _snapshots(rng, 120, 80, 10, np.float32)
    exact = np.linalg.svd(X.astype(np.float64), compute_uv=False)
    for seed in range(4):
        U, S = randomized_pod(_t(X), 6, oversample=8,
                              generator=torch.Generator().manual_seed(seed))
        np.testing.assert_allclose(S.numpy()[:6], exact[:6], rtol=0, atol=1e-4 * exact[0])
        np.testing.assert_allclose((U.T @ U).numpy(), np.eye(6), atol=1e-3)


def test_sharded_gram_pod_matches_jax(rng):
    X = _snapshots(rng, 150, 12, 8, np.float64)
    U, S = sharded_gram_pod(_t(X), 4)
    jU, jS = jsh.sharded_gram_pod(jnp.asarray(X), 4)
    exact = np.linalg.svd(X, compute_uv=False)
    # The Gram route squares the condition number: 1e-8 of the largest.
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=0, atol=1e-8 * exact[0])
    np.testing.assert_allclose(S.numpy()[:4], exact[:4], rtol=0, atol=1e-8 * exact[0])
    signs = np.sign(np.sum(U.numpy() * np.asarray(jU), axis=0))
    np.testing.assert_allclose(U.numpy() * signs, np.asarray(jU), atol=1e-6)
