"""The production-scale pipeline of the PyTorch port against the JAX
package's ``run_scaled`` on the CPU at a tiny size (n = 96, k = 200, 4
modes, m = 60, m' = 64, 2 restarts, 8 draws, a 6-point grid; a
one-device mesh on the JAX side), stage by stage.

The JAX front half (snapshots, POD, GP fit, estimation, weighting, TSQR)
is composed here from the JAX package's own functions exactly as
``run_scaled`` composes them, from the same keys, so that its products can
cross into the port's stages; the search and the ensembles are held
against what JAX's ``run_scaled`` itself returns, with every random
number of the JAX run replayed into the port (sample indices, lift,
noise, sketch, restart starts, and the posterior normals of the grid, the
refinement, the final ensemble and the chained rollouts).
"""

import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.gp.fit import _initial_z, fit_gp_hyperparameters as j_fit
from gp_bayesopinf_tpu.gp.nlml import BoxTransform as JBox
from gp_bayesopinf_tpu.parallel import make_mesh
from gp_bayesopinf_tpu.parallel.sharded import randomized_pod as j_randomized_pod
from gp_bayesopinf_tpu.parallel.sharded import tall_skinny_svd as j_tall_skinny_svd
from gp_bayesopinf_tpu.pipeline import scaled as jscaled
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.solve.lstsq import WeightedLSTSQ as JWeightedLSTSQ
from gp_bayesopinf_tpu.utils.timing import TimedBlock as JTimedBlock
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.gp.fit import fit_gp_hyperparameters
from gp_bayesopinf_torch.gp.nlml import BoxTransform
from gp_bayesopinf_torch.parallel import randomized_pod, tall_skinny_svd
from gp_bayesopinf_torch.pipeline import ScaledNormals, cli, run_scaled
from gp_bayesopinf_torch.pipeline.scaled import data, estimate, rollout, search
from gp_bayesopinf_torch.pipeline.scaled.gamma import resolve_gamma
from gp_bayesopinf_torch.rom import GalerkinROM

N, K, R, M, MP, NRES, NDRAWS, G = 96, 200, 4, 60, 64, 2, 8, 6
SIZES = dict(n_space=N, n_snapshots=K, num_modes=R, num_gp_samples=M,
             num_regression_points=MP, n_restarts=NRES, ndraws=NDRAWS, grid_size=G)
BOUNDS = ((1e-5, 1e5), (1e-3, 1e2), (1e-10, 1e2))
f32, f64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _tb(msg):
    return JTimedBlock(msg, silent=True)


def _mesh():
    return make_mesh({"draw": 1, "mode": 1}, devices=jax.devices()[:1])


def _keys(seed=0):
    k_data, k_fit, k_draw = jax.random.split(jax.random.PRNGKey(seed), 3)
    return k_data, k_fit, k_draw


@functools.lru_cache(maxsize=None)
def jax_gp_stage(source="synthetic"):
    """Snapshots, POD and GP fit as ``run_scaled`` composes them."""
    k_data, k_fit, _ = _keys()
    mesh = _mesh()
    states = (jscaled._euler_states(k_data, N, K) if source == "euler"
              else jscaled._synthetic_states(k_data, N, K, R))
    centered = states - jnp.mean(states, axis=1, keepdims=True)
    pod_key = jax.random.fold_in(k_data, 1)
    basis, svdvals = j_randomized_pod(centered, R, mesh=mesh,
                                      row_axis=tuple(mesh.axis_names), key=pod_key)
    compressed = basis.T @ centered
    t_all = np.linspace(0.0, 1.0, K)
    sample_idx = np.sort(np.asarray(jax.random.choice(k_fit, K, (M,), replace=False)))
    ts = t_all[sample_idx]
    Y = compressed[:, sample_idx]
    fit_key = jax.random.fold_in(k_fit, 1)
    fit = j_fit(jnp.asarray(ts), Y, JBox.from_bounds(*BOUNDS), fit_key,
                n_restarts=NRES, adam_steps=150, polish_iters=30)
    return dict(states=states, centered=centered, basis=basis, svdvals=svdvals, ts=ts, Y=Y,
                fit=fit, sample_idx=sample_idx, pod_key=pod_key, fit_key=fit_key)


@functools.lru_cache(maxsize=None)
def jax_regression(modelform, W, weight_method="chol", source="synthetic"):
    """Estimation, weighting and TSQR as ``run_scaled`` composes them."""
    j = jax_gp_stage(source)
    mw = MP // W
    rom = JROM(modelform, state_dimension=R, substeps=2)
    tw = np.linspace(0.0, 1.0, MP).reshape(W, mw)
    fit = j["fit"]
    state_est, ddt_est, ctx = jscaled._gp_estimate_windows(
        j["ts"], j["Y"], fit.sigma2, fit.ell, fit.chi, tw, weight_method, _tb)
    Dt, zt = jscaled._weight_windows(rom, state_est, ddt_est, ctx, _tb)
    d = Dt.shape[-1]
    Dt_flat = jnp.asarray(Dt, jnp.float32).reshape(W * R, mw, d)
    zt_flat = jnp.asarray(zt, jnp.float32).reshape(W * R, mw)
    U, S, V = j_tall_skinny_svd(Dt_flat, mesh=_mesh(), spec=("mode", "draw", None))
    fac = JWeightedLSTSQ(U, S, V, jnp.einsum("rmd,rm->rd", U, zt_flat), Dt_flat, zt_flat)
    return dict(rom=rom, tw=tw, state_est=state_est, ddt_est=ddt_est, ctx=ctx, Dt=Dt, zt=zt,
                fac=fac, d=d)


def _replayed(W, d, blocked):
    """The posterior normals of JAX's run: grid, refinement, final, chain."""
    _, _, k_draw = _keys()
    shape = (W * R, d)
    normal = lambda key, n: np.asarray(jax.random.normal(key, (n,) + shape, dtype=jnp.float32))
    xi_refine = normal(jax.random.fold_in(k_draw, 101), 20)
    xi_grid = None if blocked else np.stack([normal(k, 20) for k in jax.random.split(k_draw, G)])
    return dict(xi_grid=xi_grid, xi_refine=xi_refine,
                xi_final=normal(jax.random.fold_in(k_draw, 7), NDRAWS),
                xi_chain=normal(jax.random.fold_in(k_draw, 8), NDRAWS))


# --- the front half, stage by stage ------------------------------------------------


def test_synthetic_states_match_jax():
    """Float32 snapshots from replayed normals: 1e-5 of the largest entry."""
    k_data, _, _ = _keys()
    k2, k3 = jax.random.split(k_data, 2)
    lift = np.asarray(jax.random.normal(k2, (N, R), dtype=jnp.float32))
    noise = np.asarray(jax.random.normal(k3, (N, K), dtype=jnp.float32))
    got = data.synthetic_states(N, K, R, device="cpu", lift_normals=_t(lift),
                                noise_normals=_t(noise))
    want = np.asarray(jax_gp_stage()["states"])
    assert got.dtype == f32 and got.shape == (N, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    own = data.synthetic_states(N, K, R, device="cpu", generator=torch.Generator().manual_seed(0))
    sv = torch.linalg.svdvals(own.double())
    assert float(sv[R - 1] / sv[R]) > 3.0  # numerical rank R above the noise


def test_euler_states_match_jax():
    """The Euler source with the noise replayed: two float64 truth solves,
    then float32; 1e-5 of the largest entry."""
    k_data, _, _ = _keys()
    noise = np.asarray(jax.random.normal(k_data, (N, K), jnp.float32))
    got = data.euler_states(N, K, device="cpu", noise_normals=_t(noise))
    want = np.asarray(jax_gp_stage("euler")["states"])
    assert got.dtype == f32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="divisible by 3"):
        data.euler_states(N + 1, K, device="cpu")


def test_pod_and_gp_fit_match_jax():
    """POD on JAX's centred snapshots with its sketch (singular values to
    1e-4 of the largest, of JAX's and of the exact ones: float32 products,
    and the two floor the sketch's Gram spectrum differently; basis up to
    column signs), then
    the GP fit on JAX's compressed samples from its restart starts (log
    hyperparameters to rtol 1e-3, or a lower likelihood)."""
    j = jax_gp_stage()
    sketch = np.asarray(jax.random.normal(j["pod_key"], (K, R + 32), dtype=jnp.float32))
    basis, svdvals = randomized_pod(_t(j["centered"]), R, Omega=_t(sketch))
    jsv = np.asarray(j["svdvals"])
    np.testing.assert_allclose(svdvals.numpy()[:R], jsv[:R], rtol=0, atol=1e-4 * jsv[0])
    exact = np.linalg.svd(np.asarray(j["centered"], np.float64), compute_uv=False)
    np.testing.assert_allclose(svdvals.numpy()[:R], exact[:R], rtol=0, atol=1e-4 * exact[0])
    # The basis against the exact singular vectors to 1e-4; JAX's own sits
    # 2.4e-3 from them here (its floor lets float32 noise into the sketch).
    exact_U = np.linalg.svd(np.asarray(j["centered"], np.float64), full_matrices=False)[0][:, :R]
    signs = np.sign(np.sum(basis.numpy() * exact_U, axis=0))
    np.testing.assert_allclose(basis.numpy() * signs, exact_U, atol=1e-4)
    jbasis = np.asarray(j["basis"])
    signs = np.sign(np.sum(basis.numpy() * jbasis, axis=0))
    np.testing.assert_allclose(basis.numpy() * signs, jbasis, atol=5e-3)

    z0 = np.stack([np.asarray(_initial_z(JBox.from_bounds(*BOUNDS), k, NRES))
                   for k in jax.random.split(j["fit_key"], R)])
    box = BoxTransform.from_bounds(*BOUNDS, device="cpu", dtype=f64)
    fit = fit_gp_hyperparameters(_t(j["ts"]), _t(j["Y"], f64), box, n_restarts=NRES,
                                 adam_steps=150, polish_iters=30, z0=_t(z0, f64))
    # A mode either lands on JAX's optimum or on a better one (mode 3's
    # 30-step Newton polish ends at a likelihood 4 lower here).
    logs = lambda f: np.log(np.stack([np.asarray(getattr(f, n), np.float64)
                                      for n in ("sigma2", "ell", "chi")], axis=1))
    same = np.all(np.isclose(logs(fit), logs(j["fit"]), rtol=1e-3, atol=1e-3), axis=1)
    better = fit.nlml.numpy() < np.asarray(j["fit"].nlml) - 1e-6
    assert same.sum() >= R - 1 and np.all(same | better), (logs(fit), logs(j["fit"]))


@pytest.mark.parametrize("weight_method,W", [("chol", 1), ("chol", 2), ("lowrank", 1)])
def test_estimation_weighting_and_tsqr_match_jax(weight_method, W):
    """On JAX's hyperparameters: state and derivative estimates to 1e-7 of
    their scale; the weighted blocks on JAX's estimates and weights to
    1e-6 of theirs (triangular solves at condition ~1e12; for the
    factored root the near-null space is roundoff, 1e-3); the TSQR on
    JAX's float32 blocks, singular values to 1e-5 of the largest."""
    j, jr = jax_gp_stage(), jax_regression("cAH", W, weight_method)
    fit = j["fit"]
    hyper = [_t(np.asarray(x), f64) for x in (fit.sigma2, fit.ell, fit.chi)]
    rom = GalerkinROM("cAH", state_dimension=R, substeps=2)
    tw = _t(jr["tw"])
    state, ddt, ctx = estimate.gp_estimate_windows(_t(j["ts"]), _t(j["Y"], f64), *hyper, tw,
                                                   weight_method)
    assert state.shape == ddt.shape == (W, R, MP // W) and ctx[0] == weight_method
    for got, want in ((state, jr["state_est"]), (ddt, jr["ddt_est"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7 * np.abs(want).max())

    if weight_method == "chol":
        jctx = ("chol", _t(jr["ctx"][1]))
        LLt = ctx[1] @ ctx[1].transpose(-1, -2)
        want = np.asarray(jr["ctx"][1]) @ np.swapaxes(np.asarray(jr["ctx"][1]), -1, -2)
        np.testing.assert_allclose(LLt.numpy(), want, rtol=0, atol=1e-7 * np.abs(want).max())
        tol = 1e-6
    else:
        jctx = ("lowrank", [[convert.lowrank_root(root, device="cpu") for root in row]
                            for row in jr["ctx"][1]])
        tol = 1e-10  # the same factors through the same two products
    Dt, zt = estimate.weight_windows(rom, _t(jr["state_est"]), _t(jr["ddt_est"]), jctx)
    for got, want in ((Dt, jr["Dt"]), (zt, jr["zt"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    # The port's own weights give the same weighted Gram matrices, up to
    # the roundoff-determined near-null space of C.
    own_Dt, _ = estimate.weight_windows(rom, state, ddt, ctx)
    gram = lambda A: np.einsum("wrmi,wrmj->wrij", A, A)
    want = gram(np.asarray(jr["Dt"]))
    np.testing.assert_allclose(gram(own_Dt.numpy()), want, rtol=0, atol=5e-3 * np.abs(want).max())

    jfac = jr["fac"]
    _, S, _ = tall_skinny_svd(_t(jfac.Dt))
    np.testing.assert_allclose(S.numpy(), np.asarray(jfac.S), rtol=0,
                               atol=1e-5 * float(np.max(jfac.S)))


def test_underdetermined_windows_raise():
    rom = GalerkinROM("cAH", state_dimension=R, substeps=2)  # d = 15
    st = torch.zeros((8, R, 8), dtype=f64)
    with pytest.raises(ValueError, match="underdetermined"):
        estimate.weight_windows(rom, st, st, ("chol", torch.eye(8, dtype=f64).expand(8, R, 8, 8)))
    with pytest.raises(ValueError, match="weight_method"):
        estimate.gp_estimate_windows(st[0, 0], st[0], st[0, :, 0], st[0, :, 0], st[0, :, 0],
                                     st[0, :1], "eigh")


# --- gamma shapes and golden section -----------------------------------------------


@pytest.mark.parametrize("shape,kind,out", [
    ("colnorm", "diag", (2 * R, 7)), ((7,), "diag", (2 * R, 7)), ((R, 7), "diag", (2 * R, 7)),
    ((7, 7), "matrix", (2 * R, 7, 7)), ((R, 7, 7), "matrix", (2 * R, 7, 7)),
    ("rownorm", ValueError, "unknown"), ((6,), ValueError, "!="), ((R + 1, 7), ValueError, "none of"),
    ((2, R, 7, 7), ValueError, "none of"),
])
def test_resolve_gamma_matches_jax(rng, shape, kind, out):
    """All five accepted shapes against the reference's (equal to the
    last bit: an expand or a tile), and the refusals."""
    W, d = 2, 7
    Dt = rng.standard_normal((W * R, 10, d))
    gamma = shape if isinstance(shape, str) else rng.standard_normal(shape)
    if kind is ValueError:
        with pytest.raises(ValueError, match=out):
            resolve_gamma(gamma, _t(Dt), R, d, W)
        with pytest.raises(ValueError):
            jscaled._resolve_gamma(gamma, jnp.asarray(Dt), R, d, W)
        return
    got_kind, got = resolve_gamma(gamma, _t(Dt), R, d, W)
    want_kind, want = jscaled._resolve_gamma(gamma, jnp.asarray(Dt), R, d, W)
    assert got_kind == want_kind == kind and tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)


def test_square_gamma_is_a_matrix(rng):
    """(r, r) with r = d is taken as one (d, d) matrix, as the reference."""
    kind, G_ = resolve_gamma(rng.standard_normal((R, R)), torch.zeros((R, 5, R), dtype=f64), R, R, 1)
    assert kind == "matrix" and tuple(G_.shape) == (R, R, R)


def test_golden_vec_equals_jax_to_the_last_bit():
    """Both are NumPy: the same evaluations in the same order."""
    centers = np.array([-3.2, 0.4, 1.0])
    fn = lambda x: (x - centers) ** 2 + np.array([0.0, 1.0, -2.0])
    x0, lo, hi = np.array([-2.0, 0.0, 1.0]), np.array([-4.0, -1.0, 1.0]), np.array([-1.0, 2.0, 1.0])
    want = jscaled._golden_vec(fn, x0, fn(x0), lo, hi)
    got = search.golden_vec(fn, x0, fn(x0), lo, hi)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert abs(got[0][0] - centers[0]) < 1e-2 and got[0][2] == 1.0  # window 2 is inactive


# --- the rollout against the ROM's own integrator ------------------------------------


@pytest.mark.parametrize("structure", ["cA", "cAH", "A"])
def test_rollout_matches_rom_predict(rng, structure):
    """The batched window rollout against ``GalerkinROM.predict`` window
    by window, float64: rtol 1e-10 (the same RK4, the right-hand side
    summed block by block)."""
    W, n, mw = 3, 5, 9
    rom = GalerkinROM(structure, state_dimension=R, substeps=2)
    O = 0.2 * rng.standard_normal((n, W, R, rom.operator_dimension))
    q0 = rng.standard_normal((W, R))
    tw = np.linspace(0, 1, W * mw).reshape(W, mw)
    got = search.rollout(rom, _t(O), _t(q0), _t(tw))
    assert got.shape == (n, W, R, mw)
    for w in range(W):
        want = rom.predict(_t(O[:, w]), _t(q0[w]), _t(tw[w]))
        np.testing.assert_allclose(got[:, w].numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    per_draw = search.rollout(rom, _t(O), _t(np.broadcast_to(q0, (n, W, R))), _t(tw))
    assert torch.equal(per_draw, got)
    with pytest.raises(ValueError, match="autonomous"):
        search.rollout(GalerkinROM("cAHB", R, input_dimension=1), _t(O), _t(q0), _t(tw))


# --- the search and the ensembles against JAX's run_scaled -------------------------------

CONFIGS = {
    "scalar-1": dict(modelform="cA", regularization="scalar", time_windows=1),
    "blocked-1": dict(modelform="cAH", regularization="blocked", time_windows=1),
    "gamma-1": dict(modelform="cA", regularization="gamma", tikhonov_gamma="colnorm",
                    time_windows=1),
    "scalar-2": dict(modelform="cA", regularization="scalar", time_windows=2),
    "gamma-2": dict(modelform="cAH", regularization="gamma", tikhonov_gamma="colnorm",
                    time_windows=2),
}


PINNED = ("scalar-1", "scalar-2")


def _grid_errors(jres):
    """JAX's float32 grid errors in float64, its rejection mark (the
    float32 next to 1e12) made the port's exact 1e12."""
    errs = np.asarray(jres.grid_errors)
    return np.where(errs >= np.float32(search.REJECTED), search.REJECTED, errs.astype(np.float64))


@functools.lru_cache(maxsize=None)
def jax_run(name):
    return jscaled.run_scaled(mesh=_mesh(), **SIZES, **CONFIGS[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_search_and_ensembles_match_jax(name):
    """On JAX's float32 factorization and GP estimates, its normals
    replayed. Grid: the same candidates rejected, errors to rtol 1e-3
    (float32 rollouts of 63 or 31 steps), the same winner in every window.
    Refinement: the port's frozen-draw objective at its own choice and at
    JAX's agree to rtol 2e-3 (the same basin); the regularizers themselves
    to rtol 1e-2 where the basin has a bottom (``PINNED``: elsewhere the
    objective is flat to float32 roundoff over decades, 0.00485896 to
    0.00485911 at gamma-1, and its last bits choose the point). Ensembles
    at JAX's regularizers:
    stable fractions equal, every error to rtol 2e-2 (float64 here against
    float32 there), for all three chaining schemes."""
    cfg = CONFIGS[name]
    W, blocked = cfg["time_windows"], cfg["regularization"] == "blocked"
    jr, jres = jax_regression(cfg["modelform"], W), jax_run(name)
    rom = GalerkinROM(cfg["modelform"], state_dimension=R, substeps=2)
    fac = convert.weighted_lstsq(jr["fac"], device="cpu")
    normals = _replayed(W, jr["d"], blocked)
    build = lambda dtype: search.build_problem(
        rom, fac, _t(jr["state_est"]), _t(jr["tw"]), cfg["regularization"],
        cfg.get("tikhonov_gamma"), 0.02, dtype)
    screen = build(f32)
    grid = np.logspace(-12, 6, G)
    xi_refine = _t(normals["xi_refine"])
    errs = search.grid_screen(screen, grid, xi_refine if blocked else _t(normals["xi_grid"]),
                              blocked)
    want = _grid_errors(jres).reshape(errs.shape)
    rejected = want >= search.REJECTED
    np.testing.assert_array_equal(errs >= search.REJECTED, rejected)
    np.testing.assert_allclose(errs[~rejected], want[~rejected], rtol=1e-3)
    flat = lambda e: e.reshape(-1, W)
    np.testing.assert_array_equal(np.argmin(flat(errs), axis=0), np.argmin(flat(want), axis=0))

    single = search.frozen_objective(screen, xi_refine)
    refine = search.refine_blocked if blocked else search.refine_scalar
    params = refine(single, grid, want)
    if W == 1:
        jparams = np.array([[jres.regularizer, jres.regularizer_quad]] if blocked
                           else [jres.regularizer])
    else:
        jparams = np.asarray(jres.window_regularizers)
    np.testing.assert_allclose(single(params), single(jparams.reshape(params.shape)), rtol=2e-3)
    if name in PINNED:
        np.testing.assert_allclose(params, jparams.reshape(params.shape), rtol=1e-2)

    final = build(f64)
    p = _t(jparams, f64)
    means, frac = rollout.final_ensemble(final, p, _t(normals["xi_final"], f64))
    assert frac == pytest.approx(jres.stable_fraction, abs=1e-6)
    anchor = rollout.span_error(means, final)
    if W == 1:
        np.testing.assert_allclose(anchor, jres.train_error, rtol=2e-2)
        np.testing.assert_allclose(rollout.full_span(means).numpy(), jres.ensemble_mean,
                                   rtol=0, atol=1e-4 * np.abs(jres.ensemble_mean).max())
        return
    np.testing.assert_allclose(anchor, jres.window_error, rtol=2e-2)
    ohat = final.sample(p, _t(normals["xi_chain"], f64))
    by_mean = rollout.chain_mean(final, ohat)
    by_draws, _ = rollout.chain_draws(final, ohat)
    np.testing.assert_allclose(rollout.span_error(by_mean, final), jres.chained_error_mean,
                               rtol=2e-2)
    np.testing.assert_allclose(rollout.span_error(by_draws, final), jres.chained_error_draws,
                               rtol=2e-2)
    assert jres.chaining == "draws" and jres.train_error == jres.chained_error_draws
    np.testing.assert_allclose(rollout.full_span(by_draws).numpy(), jres.ensemble_mean,
                               rtol=0, atol=1e-3 * np.abs(jres.ensemble_mean).max())


@pytest.mark.slow
def test_search_and_ensemble_match_jax_at_production_widths(monkeypatch, capsys):
    """The same chain at the widths of the default run (30 modes, m = 512,
    m' = 2048, 32 restarts, low-rank roots, 256 draws, 16-point grid; the
    space cut to n = 600, which only the POD sees): ~3 minutes and ~2 GB.
    The grid to rtol 1e-5, the refined regularizer to rtol 1e-6, the train
    error to rtol 1e-5. Prints both sides: at these widths the reference
    itself rejects every lambda <= 1 and lands on the shrinkage floor
    (three of the 30 POD modes of the synthetic source are noise)."""
    import sys

    module = sys.modules[__name__]
    sizes = dict(N=600, K=10000, R=30, M=512, MP=2048, NRES=32, NDRAWS=256, G=16)
    for name, value in sizes.items():
        monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(module, "SIZES", dict(
        n_space=600, n_snapshots=10000, num_modes=30, num_gp_samples=512,
        num_regression_points=2048, n_restarts=32, ndraws=256, grid_size=16))
    for cached in (jax_gp_stage, jax_regression, jax_run):
        cached.cache_clear()
    try:
        jr = jax_regression("cA", 1, "lowrank")
        jres = jscaled.run_scaled(mesh=_mesh(), **SIZES)
        rom = GalerkinROM("cA", state_dimension=R, substeps=2)
        fac = convert.weighted_lstsq(jr["fac"], device="cpu")
        normals = _replayed(1, jr["d"], False)
        build = lambda dtype: search.build_problem(
            rom, fac, _t(jr["state_est"]), _t(jr["tw"]), "scalar", None, 0.02, dtype)
        screen, grid = build(f32), np.logspace(-12, 6, G)
        errs = search.grid_screen(screen, grid, _t(normals["xi_grid"]), False)[:, 0]
        want = _grid_errors(jres)
        single = search.frozen_objective(screen, _t(normals["xi_refine"]))
        lam = search.refine_scalar(single, grid, want[:, None])
        final = build(f64)
        means, frac = rollout.final_ensemble(final, _t([jres.regularizer], f64),
                                             _t(normals["xi_final"], f64))
        err = rollout.span_error(means, final)
        with capsys.disabled():
            print(f"\n[production widths, n = 600] JAX grid {want.tolist()}; port grid "
                  f"{errs.tolist()}; lambda {jres.regularizer:.8f} / {lam[0]:.8f}; stable "
                  f"{jres.stable_fraction} / {frac}; train error {jres.train_error:.8f} / {err:.8f}")
        np.testing.assert_array_equal(errs >= search.REJECTED, want >= search.REJECTED)
        ok = want < search.REJECTED
        np.testing.assert_allclose(errs[ok], want[ok], rtol=1e-5)
        np.testing.assert_allclose(lam[0], jres.regularizer, rtol=1e-6)
        assert frac == pytest.approx(jres.stable_fraction, abs=1e-6)
        np.testing.assert_allclose(err, jres.train_error, rtol=1e-5)
    finally:
        for cached in (jax_gp_stage, jax_regression, jax_run):
            cached.cache_clear()


# --- the port's own run ---------------------------------------------------------------


@pytest.mark.parametrize("chaining", ["draws", "mean", "anchor"])
def test_run_scaled_windowed_with_replayed_numbers(chaining):
    """The port's whole run, W = 2, every random number of the JAX run
    replayed: it rejects the grid candidates JAX rejects and scores the
    others within 40% (its own float64 GP fit and factorization stand
    between; the grid is flat across its stable candidates), and
    ``train_error`` and ``ensemble_mean`` are the chosen scheme's."""
    j, jres = jax_gp_stage(), jax_run("scalar-2")
    k_data, _, _ = _keys()
    k2, k3 = jax.random.split(k_data, 2)
    z0 = np.stack([np.asarray(_initial_z(JBox.from_bounds(*BOUNDS), k, NRES))
                   for k in jax.random.split(j["fit_key"], R)])
    normals = ScaledNormals(
        sample_idx=j["sample_idx"],
        lift=_t(np.asarray(jax.random.normal(k2, (N, R), dtype=jnp.float32))),
        noise=_t(np.asarray(jax.random.normal(k3, (N, K), dtype=jnp.float32))),
        sketch=_t(np.asarray(jax.random.normal(j["pod_key"], (K, R + 32), dtype=jnp.float32))),
        z0=_t(z0, f64),
        **{k: _t(v) for k, v in _replayed(2, R + 1, False).items()},
    )
    res = run_scaled(**SIZES, **CONFIGS["scalar-2"], window_chaining=chaining, normals=normals,
                     device="cpu")
    assert res.time_windows == 2 and res.chaining == chaining and res.weight_method == "chol"
    assert res.window_regularizers.shape == (2,) and res.grid_errors.shape == (G, 2)
    jerrs = _grid_errors(jres)
    np.testing.assert_array_equal(res.grid_errors >= search.REJECTED, jerrs >= search.REJECTED)
    ok = jerrs < search.REJECTED
    np.testing.assert_allclose(res.grid_errors[ok], jerrs[ok], rtol=0.4)
    chosen = {"draws": res.chained_error_draws, "mean": res.chained_error_mean,
              "anchor": res.window_error}[chaining]
    assert res.train_error == chosen and np.isfinite(chosen)
    jchosen = {"draws": jres.chained_error_draws, "mean": jres.chained_error_mean,
               "anchor": jres.window_error}[chaining]
    # The port's own float64 GP fit and factorization from here on: the
    # error in the neighbourhood of JAX's, not on it.
    assert 0.5 * jchosen < chosen < 2.0 * jchosen, (chosen, jchosen)
    assert res.ensemble_mean.shape == (R, MP) and np.isfinite(res.ensemble_mean).all()
    assert res.regularizer == pytest.approx(
        float(np.exp(np.mean(np.log(res.window_regularizers)))))
    assert set(res.stage_seconds) == {"data", "pod", "gp_fit", "estimate", "weighting",
                                      "factorization", "screening", "refinement", "ensemble",
                                      "chain"}


@pytest.mark.parametrize("extra", [
    dict(weight_method="lowrank"), dict(weight_method="eigh"),
    dict(modelform="cAH", regularization="blocked"),
    dict(regularization="gamma", tikhonov_gamma=np.full(R + 1, 0.5)),
    dict(data_source="euler", modelform="cAH", time_windows=2, envelope_floor=0.0),
], ids=["lowrank", "eigh", "blocked", "gamma-vector", "euler-windows"])
def test_run_scaled_on_its_own_streams(extra):
    """``run_scaled(device="cpu")`` from its seed in the other modes: a
    finite positive regularizer, stable draws, an ensemble near the GP
    estimates, and the result fields of the mode."""
    res = run_scaled(**SIZES, **extra, device="cpu")
    assert np.isfinite(res.regularizer) and res.regularizer > 0
    assert res.stable_fraction > 0.5 and res.train_error < 0.5
    assert np.all(np.diff(res.svdvals) <= 0) and np.isfinite(res.svdvals).all()
    assert (res.grid_errors < search.REJECTED).any()
    if extra.get("weight_method") == "lowrank":
        assert res.weight_method == "lowrank" and res.weight_ranks.shape == (1, R)
        assert (res.weight_ranks < MP).all()
        dense = run_scaled(**SIZES, weight_method="chol", device="cpu")
        assert dense.weight_ranks is None
        np.testing.assert_allclose(res.train_error, dense.train_error, rtol=0.1)
    if extra.get("weight_method") == "eigh":
        assert res.weight_method == "chol"
    if extra.get("regularization") == "blocked":
        assert res.regularizer_quad > 0 and res.grid_errors.shape == (G, G)
    if extra.get("time_windows") == 2:
        assert res.window_regularizers.shape == (2,)
        assert all(np.isfinite(e) for e in (res.window_error, res.chained_error_mean,
                                            res.chained_error_draws))


def test_lowrank_auto_threshold(monkeypatch):
    """"auto" takes the factored root from ``LOWRANK_MIN_POINTS`` points a
    window on (1024; lowered here)."""
    from gp_bayesopinf_torch.pipeline.scaled import run as run_module

    monkeypatch.setattr(run_module, "LOWRANK_MIN_POINTS", MP)
    assert run_scaled(**SIZES, device="cpu").weight_method == "lowrank"
    assert run_scaled(**SIZES, time_windows=2, device="cpu").weight_method == "chol"


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(regularization="ridge"), ValueError, "unknown regularization"),
    (dict(regularization="blocked"), ValueError, "no H operator"),
    (dict(regularization="gamma"), ValueError, "requires tikhonov_gamma"),
    (dict(time_windows=0), ValueError, "time_windows must be"),
    (dict(time_windows=5), ValueError, "must divide"),
    (dict(window_chaining="relay"), ValueError, "unknown window_chaining"),
    (dict(window_basis="nested"), ValueError, "unknown window_basis"),
    (dict(window_basis="local"), ValueError, "requires time_windows > 1"),
    (dict(data_source="heat"), ValueError, "unknown data_source"),
    (dict(window_basis="local", time_windows=16), ValueError, "n_snapshots must divide"),
    (dict(window_basis="local", time_windows=8), ValueError, "num_gp_samples must divide"),
    (dict(mesh=types.SimpleNamespace(mesh_dim_names=("draw", "mode"), size=(1, 3).__getitem__,
                                     device_type="cpu")),
     ValueError, "num_modes must divide the 'mode' mesh axis"),
])
def test_run_scaled_guards(kwargs, error, match):
    with pytest.raises(error, match=match):
        run_scaled(**SIZES, **kwargs, device="cpu")


def test_dead_grid_raises():
    """Every candidate unstable in a window: the search stops there."""
    jr = jax_regression("cA", 2)
    rom = GalerkinROM("cA", state_dimension=R, substeps=2)
    fac = convert.weighted_lstsq(jr["fac"], device="cpu")
    problem = search.build_problem(rom, fac, _t(jr["state_est"]), _t(jr["tw"]), "scalar", None,
                                   0.02, f32)
    problem.limits = problem.limits * 0.0  # no draw fits a zero-width envelope
    xi = _t(_replayed(2, R + 1, False)["xi_grid"])
    with pytest.raises(ValueError, match=r"every candidate unstable in window\(s\) \[0, 1\]"):
        search.grid_screen(problem, np.logspace(-12, 6, G), xi, False)


def test_scaled_cli(capsys, tmp_path, monkeypatch):
    """``scaled`` through parser and pipeline: the reference's flags, the
    JSON summary, and the refusals (``--devices`` above the card count)."""
    args = cli.build_parser().parse_args(["scaled"])
    assert (args.n_space, args.n_snapshots, args.num_modes, args.gp_samples, args.mprime,
            args.restarts, args.ndraws, args.grid_size, args.seed, args.modelform,
            args.data_source, args.regularization, args.time_windows, args.window_chaining,
            args.window_basis, args.weight_method, args.device) == (
        6000, 10000, 30, 512, 2048, 32, 256, 16, 0, "cA", "synthetic", "scalar", 1, "draws",
        "global", "auto", "cuda")
    assert args.devices == 0
    assert cli.build_parser().parse_args(["scaled", "--devices", "2"]).devices == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--devices 2 asks for 2 CUDA devices; "
                       r"torch.cuda.device_count\(\) is 1"):
        cli.run(["scaled", "--devices", "2"])
    np.save(tmp_path / "gamma.npy", np.full(R + 1, 0.5))
    small = ["scaled", "--n-space", str(N), "--k", str(K), "--modes", str(R), "--gp-samples",
             str(M), "--mprime", str(MP), "--restarts", str(NRES), "--ndraws", str(NDRAWS),
             "--grid-size", str(G), "--device", "cpu", "--quiet"]
    assert cli.main(small + ["--windows", "2", "--regularization", "gamma", "--gamma",
                             str(tmp_path / "gamma.npy"), "--chaining", "anchor"]) == 0
    import json

    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["time_windows"] == 2 and summary["chaining"] == "anchor"
    assert summary["train_error"] == summary["window_error"]
    assert len(summary["window_regularizers"]) == 2
    local = cli.run(small + ["--windows", "2", "--window-basis", "local"])
    assert local.window_basis == "local" and local.window_bases.shape == (2, N, R)
    assert np.isfinite(local.window_regularizers).all()
    first = cli.run(small + ["--checkpoint-dir", str(tmp_path)])
    resumed = cli.run(small + ["--checkpoint-dir", str(tmp_path)])
    assert {"data", "pod", "gp_fit"} <= set(first.stage_seconds)
    assert not {"data", "pod", "gp_fit"} & set(resumed.stage_seconds)
    assert resumed.regularizer == first.regularizer
    np.testing.assert_array_equal(resumed.ensemble_mean, first.ensemble_mean)
