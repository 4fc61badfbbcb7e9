"""The low-rank GP weight root of the PyTorch port against the JAX
package's (pure NumPy there), on the CPU in float64, from the same seeded
inputs: the pivoted Cholesky and its batched form, the estimates, the
Woodbury root, the dense fallback, the factored regression, save/load and
``fit_gaussian_processes(weight_method="lowrank")``.

The root's trailing eigenpairs (lam far below eta = 1e-8, kept while
lam > 0) are roundoff: their count differs between two codes and they
change ``apply`` by ~lam / eta. So ranks are compared on the pivoted
Cholesky, and ``apply`` on well-determined directions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from gp_bayesopinf_tpu.gp import fit_gaussian_processes as j_fit_gps
from gp_bayesopinf_tpu.gp import lowrank as jlr
from gp_bayesopinf_tpu.gp.fit import _initial_z
from gp_bayesopinf_tpu.gp.gp import GaussianProcess as JGaussianProcess
from gp_bayesopinf_tpu.gp.nlml import BoxTransform as JBox
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.gp import GaussianProcess, fit_gaussian_processes, regression_weights
from gp_bayesopinf_torch.gp import lowrank as tlr
from gp_bayesopinf_torch.gp.gp import resolve_weight_method
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

M, MP, ETA = 40, 300, 1e-8
# (sigma2, ell, chi) per mode: smooth, smoother, and a short length scale.
HYPER = [(1.0, 0.2, 1e-4), (2.0, 0.4, 1e-4), (0.5, 0.05, 1e-6)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(20261016)
    t = np.sort(rng.uniform(0, 1, M))
    Y = np.stack([np.sin(7 * t), np.cos(3 * t), t**2]) + 0.01 * rng.standard_normal((3, M))
    return t, Y, np.linspace(0, 1, MP)


def _batched(problem, **kw):
    t, Y, t_est = problem
    hyper = [_t([h[i] for h in HYPER]) for i in range(3)]
    return tlr.batched_lowrank_gp_estimates(_t(t).expand(3, M), _t(Y), _t(t_est), *hyper, **kw)


def _kernel_blocks(t, t_est, sigma2, ell, chi):
    """NumPy K_zy, V = K_yy^{-1} K_yz and diag(C), as the reference builds them."""
    ell2 = ell * ell
    dyy = t[:, None] - t[None, :]
    K_yy = sigma2 * np.exp(-(dyy * dyy) / (2 * ell2)) + chi * np.eye(t.size)
    dzy = t_est[:, None] - t[None, :]
    K_zy = -dzy * sigma2 * np.exp(-(dzy * dzy) / (2 * ell2)) / ell2
    V = scipy.linalg.cho_solve(scipy.linalg.cho_factor(K_yy, lower=True), K_zy.T)
    diag = np.maximum(sigma2 / ell2 - np.einsum("im,mi->i", K_zy, V), 0.0)
    return K_zy, V, diag


@pytest.mark.parametrize("mode", range(3))
def test_pivoted_cholesky_matches_jax_and_its_batched_form(problem, mode):
    """At a tolerance clear of roundoff (1e-2 eta; the default 1e-8 eta =
    1e-16 stops on residuals that are roundoff themselves, so there two
    codes agree on the rank only to a few columns): the same rank as the
    reference's loop; the factor within 1e-6 of its largest entry (two
    BLAS orders of the same subtractions, which the late columns amplify); the mode's columns in the
    three-mode batch equal to its one-mode loop (the same rank, the
    columns within 1e-8 of the largest entry: a batched product sums in
    another order), zero past its rank."""
    t, Y, t_est = problem
    s2, ell, chi = HYPER[mode]
    K_zy, V, diag = _kernel_blocks(t, t_est, s2, ell, chi)
    tol, cap = 1e-2 * ETA, 4 + MP // 2
    U_j, resid_j = jlr._pivoted_cholesky_C(t_est, K_zy, V, diag, s2, ell, tol, cap)

    def run(modes):
        blocks = [_kernel_blocks(t, t_est, *HYPER[i]) for i in modes]
        return tlr._pivoted_cholesky_C(
            _t(t_est), *(_t(np.stack([b[k] for b in blocks])) for k in range(3)),
            _t([HYPER[i][0] for i in modes]), _t([HYPER[i][1] for i in modes]), tol, cap,
        )

    cols, ranks, resids = run([mode])
    assert ranks == [U_j.shape[1]] and ranks[0] < MP // 3
    np.testing.assert_allclose(cols[0].numpy(), U_j, rtol=0, atol=1e-6 * np.abs(U_j).max())
    assert resids[0] <= tol and resid_j <= tol
    cols_b, ranks_b, _ = run([0, 1, 2])
    assert ranks_b[mode] == ranks[0]
    mine = cols_b[mode]
    assert bool((mine[:, ranks[0]:] == 0).all())  # zero columns once the mode is done
    np.testing.assert_allclose(mine[:, : ranks[0]].numpy(), cols[0].numpy(), rtol=0,
                               atol=1e-8 * np.abs(U_j).max())


@pytest.mark.parametrize("mode", range(3))
def test_lowrank_gp_estimates_match_jax(problem, mode):
    """State and derivative estimates to rtol 1e-10 of their scale; the
    root low rank (its size itself is roundoff: the default tolerance
    1e-16 stops on roundoff, and eigenpairs are kept while lam > 0); the
    retained spectrum above eta to rtol 1e-8; ``apply`` on the leading
    eigenvectors of the reference's root (lam > 1e-2, well determined) to
    rtol 1e-6, and on random directions, which reach into the
    roundoff-determined near-null space of C, to 1e-3 of the result's scale."""
    t, Y, t_est = problem
    want = jlr.lowrank_gp_estimates(t, Y[mode], t_est, *HYPER[mode], eta=ETA)
    got = tlr.lowrank_gp_estimates(_t(t), _t(Y[mode]), _t(t_est), *HYPER[mode], eta=ETA)
    for name in ("state_estimate", "ddt_estimate"):
        ref = getattr(want, name)
        np.testing.assert_allclose(getattr(got, name).numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
    assert got.root.rank < MP // 3 and want.root.rank < MP // 3
    big = want.root.lam > ETA
    assert int((got.root.lam > ETA).sum()) == int(big.sum())
    np.testing.assert_allclose(got.root.lam.numpy()[: big.sum()], want.root.lam[big], rtol=1e-8,
                               atol=1e-12 * want.root.lam.max())
    lead = want.root.Q[:, want.root.lam > 1e-2]
    assert lead.shape[1] >= 5
    np.testing.assert_allclose(got.root.apply(_t(lead)).numpy(), want.root.apply(lead),
                               rtol=0, atol=1e-6 * np.abs(want.root.apply(lead)).max())
    X = np.random.default_rng(mode).standard_normal((MP, 4))
    ref = want.root.apply(X)
    np.testing.assert_allclose(got.root.apply(_t(X)).numpy(), ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())
    np.testing.assert_allclose(got.root.apply(_t(X[:, 0])).numpy(), got.root.apply(_t(X))[:, 0].numpy())
    # The batched call gives the same mode.
    both = _batched(problem)[mode]
    np.testing.assert_allclose(both.ddt_estimate.numpy(), got.ddt_estimate.numpy(), rtol=0,
                               atol=1e-10 * float(got.ddt_estimate.abs().max()))
    np.testing.assert_allclose(both.root.apply(_t(X)).numpy(), got.root.apply(_t(X)).numpy(),
                               rtol=0, atol=1e-3 * np.abs(ref).max())


def test_root_is_the_inverse_square_root(problem):
    """|| W (C + eta I) W - I || against the dense C: on the float64
    conditioning floor at eta = 1e-8 (the reference pins ~1e-3), and
    ``dense`` and ``covariance`` agree with ``apply`` and with C."""
    t, Y, t_est = problem
    est = _batched(problem)[0]
    K_zy, V, _ = _kernel_blocks(t, t_est, *HYPER[0])
    ell2 = HYPER[0][1] ** 2
    dzz = t_est[:, None] - t_est[None, :]
    C = HYPER[0][0] / ell2 * (1 - dzz**2 / ell2) * np.exp(-(dzz**2) / (2 * ell2)) - K_zy @ V
    Wd = est.root.dense().numpy()
    assert np.abs(Wd @ (C + ETA * np.eye(MP)) @ Wd - np.eye(MP)).max() < 5e-3
    X = np.random.default_rng(3).standard_normal((MP, 3))
    np.testing.assert_allclose(Wd @ X, est.root.apply(_t(X)).numpy(), rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(est.root.covariance().numpy(), C, rtol=0, atol=1e-9 * np.abs(C).max())
    assert est.root.rank == est.root.Q.shape[1] == est.root.gain.shape[0]


def test_dense_fallback_when_the_rank_cap_is_hit(problem):
    """A cap below the numerical rank: the exact eigh root with p = m',
    the spectrum equal to the reference's (rtol 1e-9 of the largest)."""
    t, Y, t_est = problem
    want = jlr.lowrank_gp_estimates(t, Y[0], t_est, *HYPER[0], max_rank=10)
    got = tlr.lowrank_gp_estimates(_t(t), _t(Y[0]), _t(t_est), *HYPER[0], max_rank=10)
    assert got.root.rank == want.root.rank == MP and got.root.resid == 0.0
    np.testing.assert_allclose(got.root.lam.numpy(), want.root.lam, rtol=0,
                               atol=1e-9 * want.root.lam.max())
    X = np.random.default_rng(4).standard_normal((MP, 2))
    ref = want.root.apply(X)
    np.testing.assert_allclose(got.root.apply(_t(X)).numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    # In a batch only the mode over its cap falls back.
    ranks = [e.root.rank for e in _batched(problem, max_rank=60)]
    assert ranks[2] == MP and max(ranks[:2]) < 60


def test_unrefined_root_keeps_the_cholesky_rank(problem):
    """Without the Rayleigh-Ritz pass the root's rank is the pivoted
    Cholesky's: equal to the reference's at a tolerance clear of roundoff."""
    t, Y, t_est = problem
    kw = dict(refine=False, tol_factor=1e-2)
    want = jlr.lowrank_gp_estimates(t, Y[1], t_est, *HYPER[1], **kw)
    got = tlr.lowrank_gp_estimates(_t(t), _t(Y[1]), _t(t_est), *HYPER[1], **kw)
    assert got.root.rank == want.root.rank
    np.testing.assert_allclose(got.root.lam.numpy()[:10], want.root.lam[:10], rtol=1e-8)


def test_non_spd_training_gram_raises(problem):
    t, Y, t_est = problem
    tt = np.array(t)
    tt[1] = tt[0]  # a duplicate time and no noise: K_yy is singular
    with pytest.raises(ValueError, match="not positive definite"):
        tlr.lowrank_gp_estimates(_t(tt), _t(Y[0]), _t(t_est), 1.0, 0.2, 0.0)


@pytest.mark.parametrize("blocks", [1, 2])
def test_factored_weighted_lstsq_fit_matches_jax(problem, blocks):
    """The factored-root regression on the reference's roots carried
    across: rows of roots (B = 1) and rows of B blocks. Singular values to
    rtol 1e-9 of the largest, the weighted matrices to 1e-10 of theirs."""
    t, Y, t_est = problem
    r, d = 3, 5
    rng = np.random.default_rng(blocks)
    jroots = [[jlr.lowrank_gp_estimates(t, Y[(i + b) % 3], t_est, *HYPER[(i + b) % 3]).root
               for b in range(blocks)] for i in range(r)]
    D = rng.standard_normal((blocks, MP, d))
    rhs = rng.standard_normal((r, blocks, MP))
    want = j_lstsq_fit(D, jroots if blocks > 1 else [row[0] for row in jroots], rhs)
    roots = [[convert.lowrank_root(root, device="cpu") for root in row] for row in jroots]
    got = weighted_lstsq_fit(_t(D), roots if blocks > 1 else [row[0] for row in roots], _t(rhs))
    for name in ("Dt", "zt"):
        ref = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S), rtol=0,
                               atol=1e-9 * float(np.max(want.S)))
    np.testing.assert_allclose(got.solve(1e-3).numpy(), np.asarray(want.solve(1e-3)), rtol=1e-6)
    # svd_fn replaces the factorization.
    calls = []

    def svd_fn(X):
        calls.append(X.shape)
        U, S, Vh = torch.linalg.svd(X, full_matrices=False)
        return U, S, Vh.transpose(-1, -2)

    again = weighted_lstsq_fit(_t(D), roots if blocks > 1 else [row[0] for row in roots],
                               _t(rhs), svd_fn=svd_fn)
    assert calls == [(r, blocks * MP, d)] and torch.equal(again.S, got.S)
    with pytest.raises(ValueError, match="rows of B"):
        weighted_lstsq_fit(_t(D), roots[:2], _t(rhs))
    with pytest.raises(ValueError, match="underdetermined"):
        weighted_lstsq_fit(_t(D[:, :2]), roots, _t(rhs[:, :, :2]))


def test_fit_gaussian_processes_lowrank_matches_jax():
    """``weight_method="lowrank"`` and "auto" above a lowered threshold,
    JAX's restart starts replayed: hyperparameters as the dense path's
    (rtol 1e-4 in log), estimates to 1e-3 of their scale (they follow
    the hyperparameters), the regression
    through ``regression_weights`` to rtol 1e-6 on the posterior mean."""
    rng = np.random.default_rng(7)
    m, mp, r, nres = 30, 60, 2, 4
    t = np.sort(rng.uniform(0, 1, m))
    Y = np.stack([np.sin(5 * t), np.cos(4 * t)]) + 0.01 * rng.standard_normal((r, m))
    t_est = np.linspace(0, 1, mp)
    bounds = ((1e-5, 1e5), (1e-2, 1e2), (1e-8, 1e2))
    key = jax.random.PRNGKey(3)
    jgps = j_fit_gps(t_est, t, Y, *bounds, n_restarts_optimizer=nres, key=key,
                     weight_method="lowrank")
    z0 = np.stack([np.asarray(_initial_z(JBox.from_bounds(*bounds), k, nres))
                   for k in jax.random.split(key, r)])
    gps = fit_gaussian_processes(_t(t_est), _t(t), _t(Y), *bounds, n_restarts_optimizer=nres,
                                 z0=_t(z0), weight_method="auto", lowrank_min_points=mp)
    for gp, jgp in zip(gps, jgps):
        assert gp.weight_method == jgp.weight_method == "lowrank"
        assert gp.sqrtW is None and gp.ddt_covariance is None
        np.testing.assert_allclose(
            np.log([gp.constant, gp.length_scale, gp.noise_level]),
            np.log([jgp.constant, jgp.length_scale, jgp.noise_level]), rtol=1e-4)
        ref = np.asarray(jgp.ddt_estimate)
        np.testing.assert_allclose(gp.ddt_estimate.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())
    carried = convert.gaussian_processes(jgps, device="cpu")
    assert all(isinstance(g.lowrank_root, tlr.LowRankWeightRoot) for g in carried)
    D = rng.standard_normal((1, mp, 3))
    rhs = np.stack([np.asarray(g.ddt_estimate) for g in jgps])[:, None]
    want = j_lstsq_fit(D, [g.lowrank_root for g in jgps], rhs)
    roots, are_cholesky = regression_weights([[g] for g in carried])
    got = weighted_lstsq_fit(_t(D), roots, _t(rhs), weights_are_cholesky=are_cholesky)
    assert not are_cholesky
    np.testing.assert_allclose(got.solve(1e-2).numpy(), np.asarray(want.solve(1e-2)), rtol=1e-6)


def test_save_load_round_trip_and_reads_the_jax_file(problem, tmp_path):
    t, Y, t_est = problem
    est = tlr.lowrank_gp_estimates(_t(t), _t(Y[0]), _t(t_est), *HYPER[0])
    gp = GaussianProcess(_t(t), _t(Y[0]), *HYPER[0], t_estimation=_t(t_est),
                         state_estimate=est.state_estimate, ddt_estimate=est.ddt_estimate,
                         weight_method="lowrank", lowrank_root=est.root)
    gp.save(tmp_path / "gp.npz")
    back = GaussianProcess.load(tmp_path / "gp.npz", device="cpu")
    assert back.weight_method == "lowrank" and back.sqrtW is None
    assert torch.equal(back.lowrank_root.Q, est.root.Q) and back.lowrank_root.eta == est.root.eta
    assert torch.equal(back.ddt_estimate, est.ddt_estimate)
    assert torch.equal(back.predict(_t(t_est))[0], gp.predict(_t(t_est))[0])
    # A file the JAX package wrote loads into the port.
    jest = jlr.lowrank_gp_estimates(t, Y[0], t_est, *HYPER[0])
    jgp = JGaussianProcess(jnp.asarray(t), jnp.asarray(Y[0]), *HYPER[0],
                           t_estimation=jnp.asarray(t_est),
                           state_estimate=jnp.asarray(jest.state_estimate),
                           ddt_estimate=jnp.asarray(jest.ddt_estimate),
                           weight_method="lowrank", lowrank_root=jest.root)
    jgp.save(str(tmp_path / "jgp.npz"))
    theirs = GaussianProcess.load(tmp_path / "jgp.npz", device="cpu")
    np.testing.assert_array_equal(theirs.lowrank_root.lam.numpy(), jest.root.lam)
    assert theirs.lowrank_root.rank == jest.root.rank


@pytest.mark.parametrize("given,points,floor,want", [
    ("lowrank", 60, 1024, "lowrank"), ("auto", 1024, 1024, "lowrank"),
    (None, 3200, 1024, "lowrank"), ("auto", 60, 60, "lowrank"), ("auto", 59, 60, "eigh"),
])
def test_resolve_weight_method_lowrank(given, points, floor, want):
    assert resolve_weight_method(given, points, floor) == want
