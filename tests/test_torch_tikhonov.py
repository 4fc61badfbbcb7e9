"""The Tikhonov regularizers of the PyTorch port against the JAX
package's, on the CPU in float64 from the same seeded regression, JAX's
standard normals replayed: the direct normal-equation solves of
``WeightedLSTSQ``, ``TikhonovLSTSQ`` and ``MatrixTikhonovLSTSQ`` (solve,
sample, posterior_spd, candidates on a leading axis, a precision that is
not positive definite), per-row ridges, and the generic search objective
against the JAX package's ``_make_objective``.

Tolerance: rtol 1e-8 against the entries' scale (two Cholesky codes on
the same normal equations, condition number ~1e4 here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.bayes import regsearch as jsearch
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.bayes import MAXOPTVAL, auto_regularize, regsearch
from gp_bayesopinf_torch.rom import GalerkinROM
from gp_bayesopinf_torch.solve import (
    MatrixTikhonovLSTSQ, TikhonovLSTSQ, rk4_stage_times, weighted_lstsq_fit,
)

R, M, D, ND = 3, 24, 5, 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def facs():
    rng = np.random.default_rng(11)
    Dm = rng.standard_normal((1, M, D))
    roots = np.stack([np.eye(M) + 0.1 * rng.standard_normal((M, M)) for _ in range(R)])[:, None]
    rhs = rng.standard_normal((R, 1, M))
    jfac = j_lstsq_fit(jnp.asarray(Dm), jnp.asarray(roots), jnp.asarray(rhs))
    return jfac, convert.weighted_lstsq(jfac, device="cpu"), rng


def test_direct_tikhonov_solves_match_jax(facs):
    jfac, fac, rng = facs
    g_shared, g_rows = np.abs(rng.standard_normal(D)) + 0.1, np.abs(rng.standard_normal((R, D)))
    _close(fac.solve_tikhonov(_t(g_shared)), jfac.solve_tikhonov(jnp.asarray(g_shared)))
    _close(fac.solve_tikhonov(_t(g_rows)), jfac.solve_tikhonov(jnp.asarray(g_rows)))
    G, G_rows = rng.standard_normal((D, D)), rng.standard_normal((R, D, D))
    for gamma in (G, G_rows):
        _close(fac.solve_tikhonov_matrix(_t(gamma)), jfac.solve_tikhonov_matrix(jnp.asarray(gamma)))
        means, precisions = fac.posterior_tikhonov(_t(gamma))
        jmeans, jprecisions = jfac.posterior_tikhonov(jnp.asarray(gamma))
        _close(means, jmeans)
        _close(precisions, jprecisions)
    # A ridge is the diagonal regularizer lambda I.
    _close(fac.solve_tikhonov(torch.full((D,), 0.3, dtype=torch.float64)), jfac.solve(0.3))
    with pytest.raises(ValueError, match="neither"):
        fac.solve_tikhonov_matrix(torch.zeros((D, D + 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="neither"):
        fac.matrix_tikhonov(torch.zeros((R + 1, D, D), dtype=torch.float64))


@pytest.mark.parametrize("shape", ["scalar", "shared", "rows"])
def test_tikhonov_lstsq_matches_jax(facs, shape):
    jfac, fac, rng = facs
    gamma = {"scalar": np.array(0.2), "shared": np.abs(rng.standard_normal(D)) + 0.05,
             "rows": np.abs(rng.standard_normal((R, D))) + 0.05}[shape]
    jtik, tik = jfac.tikhonov(), fac.tikhonov()
    assert isinstance(tik, TikhonovLSTSQ) and (tik.num_problems, tik.num_unknowns) == (R, D)
    _close(tik.DtD, jtik.DtD, 1e-12)
    _close(tik.precision_cholesky(_t(gamma)), jtik.precision_cholesky(jnp.asarray(gamma)))
    _close(tik.solve(_t(gamma)), jtik.solve(jnp.asarray(gamma)))
    _close(tik.solve(_t(gamma)), jfac.solve_tikhonov(jnp.broadcast_to(jnp.asarray(gamma), (R, D))))
    key = jax.random.PRNGKey(5)
    xi = np.asarray(jax.random.normal(key, (ND, R, D), dtype=jnp.float64))
    _close(tik.sample(_t(gamma), xi=_t(xi)), jtik.sample(jnp.asarray(gamma), key, ND))
    assert bool(tik.posterior_spd(_t(gamma))) and bool(jtik.posterior_spd(jnp.asarray(gamma)))
    carried = convert.tikhonov_lstsq(jtik, device="cpu")
    _close(carried.solve(_t(gamma)), tik.solve(_t(gamma)), 1e-12)
    drawn = tik.sample(_t(gamma), 2000, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2000, R, D)
    _close(drawn.mean(dim=0), tik.solve(_t(gamma)), 0.1)


def test_tikhonov_candidates_on_a_leading_axis(facs):
    """(C, R, D) regularizers: every candidate equal to its own call."""
    _, fac, rng = facs
    tik = fac.tikhonov()
    gammas = np.abs(rng.standard_normal((4, R, D))) + 0.05
    xi = rng.standard_normal((4, ND, R, D))
    means, draws = tik.solve(_t(gammas)), tik.sample(_t(gammas), xi=_t(xi))
    assert means.shape == (4, R, D) and draws.shape == (4, ND, R, D)
    assert tik.posterior_spd(_t(gammas)).tolist() == [True] * 4
    for c in range(4):
        _close(means[c], tik.solve(_t(gammas[c])).numpy(), 1e-12)
        _close(draws[c], tik.sample(_t(gammas[c]), xi=_t(xi[c])).numpy(), 1e-12)
    mt = fac.matrix_tikhonov(_t(rng.standard_normal((D, D))))
    scales = np.abs(rng.standard_normal((4, R))) + 0.1
    out = mt.sample(_t(scales), xi=_t(xi))
    for c in range(4):
        _close(out[c], mt.sample(_t(scales[c]), xi=_t(xi[c])).numpy(), 1e-12)


@pytest.mark.parametrize("per_row", [False, True])
def test_matrix_tikhonov_lstsq_matches_jax(facs, per_row):
    jfac, fac, rng = facs
    G = rng.standard_normal((R, D, D)) if per_row else rng.standard_normal((D, D))
    jmt, mt = jfac.matrix_tikhonov(jnp.asarray(G)), fac.matrix_tikhonov(_t(G))
    assert isinstance(mt, MatrixTikhonovLSTSQ)
    _close(mt.G2, jmt.G2, 1e-12)
    key = jax.random.PRNGKey(9)
    xi = np.asarray(jax.random.normal(key, (ND, R, D), dtype=jnp.float64))
    for scale in (np.array(0.7), np.abs(rng.standard_normal(R)) + 0.1):
        _close(mt.solve(_t(scale)), jmt.solve(jnp.asarray(scale)))
        Gs = np.broadcast_to(G, (R, D, D)) * np.broadcast_to(scale, (R,))[:, None, None]
        _close(mt.solve(_t(scale)), jfac.solve_tikhonov_matrix(jnp.asarray(Gs)))
        _close(mt.sample(_t(scale), xi=_t(xi)), jmt.sample(jnp.asarray(scale), key, ND))
        assert bool(mt.posterior_spd(_t(scale))) and bool(jmt.posterior_spd(jnp.asarray(scale)))
    carried = convert.matrix_tikhonov_lstsq(jmt, device="cpu")
    _close(carried.solve(0.7), mt.solve(0.7), 1e-12)


def test_non_spd_precision_is_false_not_an_exception(facs):
    """An indefinite Gram matrix in one row: ``posterior_spd`` is False in
    both packages, that row's mean and draws are NaN, the other rows'
    are untouched, and a batch of candidates goes on."""
    jfac, fac, rng = facs
    jtik, tik = jfac.tikhonov(), fac.tikhonov()
    bad = np.asarray(jtik.DtD).copy()
    bad[1] = -bad[1]
    jbad = jtik._replace(DtD=jnp.asarray(bad))
    tbad = tik._replace(DtD=_t(bad))
    assert not bool(jbad.posterior_spd(0.1)) and not bool(tbad.posterior_spd(0.1))
    mean = tbad.solve(0.1)
    assert bool(torch.isnan(mean[1]).all()) and bool(torch.isfinite(mean[[0, 2]]).all())
    _close(mean[[0, 2]], np.asarray(jbad.solve(0.1))[[0, 2]])
    draws = tbad.sample(0.1, 3, generator=torch.Generator().manual_seed(1))
    assert bool(torch.isnan(draws[:, 1]).all()) and bool(torch.isfinite(draws[:, [0, 2]]).all())
    # Candidate 1 is large enough to make every row positive definite.
    big = 10.0 * float(np.abs(bad).max()) ** 0.5
    assert tbad.posterior_spd(_t([0.1, big])[:, None, None]).tolist() == [False, True]
    mbad = fac.matrix_tikhonov(torch.eye(D, dtype=torch.float64))._replace(DtD=_t(bad))
    assert mbad.posterior_spd(_t([[0.1] * R, [big] * R])).tolist() == [False, True]


def test_per_row_ridges(facs):
    """``per_row=True``: the last axis of lambda holds one ridge per row
    problem; each row equal to its own scalar call, JAX's per-row form."""
    jfac, fac, rng = facs
    lams = np.abs(rng.standard_normal((2, R))) + 0.01
    xi = rng.standard_normal((2, ND, R, D))
    means = fac.solve(_t(lams), per_row=True)
    draws = fac.sample(_t(lams), xi=_t(xi), per_row=True)
    assert fac.posterior_spd(_t(lams), per_row=True).tolist() == [True, True]
    for c in range(2):
        _close(means[c], jfac.solve(jnp.asarray(lams[c])), 1e-12)
        for i in range(R):
            _close(draws[c, :, i], fac.sample(lams[c, i], xi=_t(xi[c]))[:, i].numpy(), 1e-12)


def test_rk4_stage_times_are_the_integrators_own():
    t = _t(np.array([0.0, 0.1, 0.4, 0.5]))
    times = rk4_stage_times(t, 2).reshape(3, 2, 3)
    np.testing.assert_allclose(times[1, 1].numpy(), [0.25, 0.325, 0.4], rtol=1e-15)
    np.testing.assert_allclose(times[:, 0, 0].numpy(), [0.0, 0.1, 0.4], rtol=0)


@pytest.mark.parametrize("structure,inputs", [("cA", False), ("cAH", False), ("cAHBN", True)])
def test_generic_objective_matches_jax(structure, inputs):
    """``_generic_objective`` against ``_make_objective`` on JAX's
    factorization and replayed draws, float64, L = 2 trajectories: a cA
    ROM, a cAH ROM (``use_kernel=False``) and a cAHBN ROM integrated by
    rk4 with inputs. The same stability verdicts; errors to rtol 1e-5."""
    rng = np.random.default_rng(len(structure))
    r, mp, L, nu, nd = 2, 16, 2, 1, 4
    rom = GalerkinROM(structure, r, input_dimension=nu if inputs else 0, substeps=2)
    jrom = JROM(structure, r, input_dimension=nu if inputs else 0, substeps=2)
    t_est, t_pred = np.linspace(0, 0.5, mp), np.linspace(0, 0.8, 12)
    states = np.stack([[np.cos(3 * t_est + ell), np.sin(3 * t_est + ell)] for ell in range(L)])
    ddts = np.stack([[-3 * np.sin(3 * t_est + ell), 3 * np.cos(3 * t_est + ell)]
                     for ell in range(L)])
    amps = [1.0, -0.5]
    u_np = lambda a: (lambda t: a * np.sin(2 * t)[None])
    D_blocks = np.stack([
        np.asarray(jrom.data_matrix(jnp.asarray(states[ell]),
                                    jnp.asarray(u_np(amps[ell])(t_est)) if inputs else None))
        for ell in range(L)])
    roots = np.broadcast_to(20.0 * np.eye(mp), (r, L, mp, mp))  # narrow posteriors
    jfac = j_lstsq_fit(jnp.asarray(D_blocks), jnp.asarray(roots),
                       jnp.asarray(np.swapaxes(ddts, 0, 1)))
    fac = convert.weighted_lstsq(jfac, device="cpu")
    d = fac.num_unknowns
    # The reference's predict calls the input function at one time.
    predict_fns = [
        (lambda O, q, t, a=a: jrom.predict(
            O, q, t, input_func=(lambda s: a * jnp.sin(2 * s)[None]) if inputs else None))
        for a in amps]
    jobj = jsearch._make_objective(
        jfac, predict_fns, jnp.asarray(states[:, :, 0]), jnp.asarray(t_pred),
        jnp.asarray(t_est), jnp.asarray(states), nd)
    t_inputs = [(lambda t, a=a: a * torch.sin(2 * t)[None]) for a in amps] if inputs else None
    tobj = regsearch._generic_objective(
        fac, rom, _t(states[:, :, 0]), _t(t_pred), _t(t_est), _t(states), nd, t_inputs)
    lams = np.array([1e-6, 1e-2, 1.0, 30.0])
    keys = jax.random.split(jax.random.PRNGKey(2), lams.size)
    xi = np.stack([np.asarray(jax.random.normal(k, (nd, r, d), dtype=jnp.float64)) for k in keys])
    want = np.array([float(jobj(jnp.asarray(lam), k)) for lam, k in zip(lams, keys)])
    got = tobj(_t(lams), _t(xi))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got >= MAXOPTVAL, want >= MAXOPTVAL)
    assert (want < MAXOPTVAL).sum() >= 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # The whole search through the generic objective picks a finite lambda.
    res = auto_regularize(
        fac, rom, _t(states[:, :, 0]), _t(t_pred), _t(t_est), _t(states),
        generator=torch.Generator().manual_seed(0), grid=lams, ndraws=nd, verbose=False,
        input_funcs=t_inputs, use_kernel=False, screen_dtype=torch.float32)
    assert np.isfinite(res.regularizer) and res.grid_errors.shape == (4,)
    if structure != "cAH":
        with pytest.raises(ValueError, match="use_kernel requires"):
            auto_regularize(fac, rom, _t(states[:, :, 0]), _t(t_pred), _t(t_est), _t(states),
                            grid=lams, ndraws=nd, input_funcs=t_inputs, use_kernel=True)
