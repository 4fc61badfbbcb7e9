"""Local window bases of the PyTorch port's production-scale pipeline
(``run_scaled(window_basis="local")``) against the JAX package's on the
CPU at a tiny size (n = 96, k = 200, 4 modes, m = 60, m' = 64, 2
restarts, 8 draws, a 6-point grid, W = 2 windows; a one-device mesh on the
JAX side).

The JAX front half (snapshots, each window's POD, samples and GP fit) is
composed here from the JAX package's own functions exactly as
``run_scaled``'s local branch composes them, from the same keys; every
random number of the JAX run is replayed into the port (noise, lift,
each window's sample indices, sketch and restart starts, and the
posterior normals of the grid, the refinement, the final ensemble and the
chained rollouts). Local bases' signs depend on the sketch, so bases are
compared up to sign and the transfer maps in the form that does not
depend on sign.
"""

import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.gp.fit import _initial_z, fit_gp_hyperparameters as j_fit
from gp_bayesopinf_tpu.gp.nlml import BoxTransform as JBox
from gp_bayesopinf_tpu.parallel import make_mesh
from gp_bayesopinf_tpu.parallel.sharded import randomized_pod as j_randomized_pod
from gp_bayesopinf_tpu.pipeline import scaled as jscaled
from gp_bayesopinf_tpu.utils.timing import TimedBlock as JTimedBlock
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.gp.fit import fit_gp_hyperparameters
from gp_bayesopinf_torch.gp.nlml import BoxTransform
from gp_bayesopinf_torch.pipeline import ScaledNormals, run_scaled
from gp_bayesopinf_torch.pipeline.scaled import estimate, search
from gp_bayesopinf_torch.pipeline.scaled import run as run_module
from gp_bayesopinf_torch.rom import GalerkinROM

N, K, R, M, MP, NRES, NDRAWS, G, W = 96, 200, 4, 60, 64, 2, 8, 6, 2
SIZES = dict(n_space=N, n_snapshots=K, num_modes=R, num_gp_samples=M,
             num_regression_points=MP, n_restarts=NRES, ndraws=NDRAWS, grid_size=G)
LOCAL = dict(modelform="cA", time_windows=W, window_basis="local")
BOUNDS = ((1e-5, 1e5), (1e-3, 1e2), (1e-10, 1e2))
f32, f64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _mesh():
    return make_mesh({"draw": 1, "mode": 1}, devices=jax.devices()[:1])


def _keys(seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), 3)


def _signs(a, b):
    """Column signs that turn the (..., n, r) bases ``a`` towards ``b``."""
    return np.sign(np.sum(a * b, axis=-2, keepdims=True))


@functools.lru_cache(maxsize=None)
def jax_local_front():
    """The local branch of ``run_scaled``'s front half, from its keys:
    (W, m/W) sample indices and times, each window's centre, POD basis,
    singular values and samples, the W GP fits and the random numbers
    behind them."""
    k_data, k_fit, _ = _keys()
    mesh = _mesh()
    states = jscaled._synthetic_states(k_data, N, K, R)
    kw, mws = K // W, M // W
    t_all = np.linspace(0.0, 1.0, K)
    idx = np.stack([
        np.sort(np.asarray(jax.random.choice(jax.random.fold_in(k_fit, 200 + w), kw, (mws,),
                                             replace=False)))
        for w in range(W)
    ])
    ts = np.stack([t_all[w * kw + idx[w]] for w in range(W)])
    out = dict(idx=idx, ts=ts, bases=[], mus=[], svdvals=[], Y=[], sketch=[], centered=[],
               z0=[], fit=[])
    box = JBox.from_bounds(*BOUNDS)
    for w in range(W):
        block = states[:, w * kw : (w + 1) * kw]
        mu = jnp.mean(block, axis=1, keepdims=True)
        centered = block - mu
        pod_key = jax.random.fold_in(k_data, 11 + w)
        basis, sv = j_randomized_pod(centered, R, mesh=mesh, row_axis=tuple(mesh.axis_names),
                                     key=pod_key)
        Yw = ((basis.T @ centered)[:, idx[w]]).astype(jnp.float32)
        fit_key = jax.random.fold_in(k_fit, 1 + w)
        out["bases"].append(np.asarray(basis, np.float32))
        out["mus"].append(np.asarray(mu[:, 0], np.float32))
        out["svdvals"].append(np.asarray(sv))
        out["Y"].append(Yw)
        out["centered"].append(np.asarray(centered))
        out["sketch"].append(np.asarray(jax.random.normal(pod_key, (kw, R + 32), jnp.float32)))
        out["z0"].append(np.stack([np.asarray(_initial_z(box, k, NRES))
                                   for k in jax.random.split(fit_key, R)]))
        out["fit"].append(j_fit(jnp.asarray(ts[w]), Yw, box, fit_key, n_restarts=NRES,
                                adam_steps=150, polish_iters=30))
    k2, k3 = jax.random.split(k_data, 2)
    out["lift"] = np.asarray(jax.random.normal(k2, (N, R), dtype=jnp.float32))
    out["noise"] = np.asarray(jax.random.normal(k3, (N, K), dtype=jnp.float32))
    out["hyper"] = [np.stack([np.asarray(getattr(f, name)) for f in out["fit"]])
                    for name in ("sigma2", "ell", "chi")]  # each (W, r)
    return out


def _replayed_normals(d):
    """Every random number of JAX's local run, as ``ScaledNormals``."""
    j = jax_local_front()
    _, _, k_draw = _keys()
    shape = (W * R, d)
    normal = lambda key, n: _t(jax.random.normal(key, (n,) + shape, dtype=jnp.float32))
    return ScaledNormals(
        sample_idx=j["idx"], lift=_t(j["lift"]), noise=_t(j["noise"]),
        sketch=_t(np.stack(j["sketch"])), z0=_t(np.stack(j["z0"]), f64),
        xi_grid=torch.stack([normal(k, 20) for k in jax.random.split(k_draw, G)]),
        xi_refine=normal(jax.random.fold_in(k_draw, 101), 20),
        xi_final=normal(jax.random.fold_in(k_draw, 7), NDRAWS),
        xi_chain=normal(jax.random.fold_in(k_draw, 8), NDRAWS),
    )


@functools.lru_cache(maxsize=None)
def jax_local_run(chaining="draws"):
    return jscaled.run_scaled(mesh=_mesh(), **SIZES, **LOCAL, window_chaining=chaining)


@functools.lru_cache(maxsize=None)
def port_local_run(chaining="draws"):
    return run_scaled(**SIZES, **LOCAL, window_chaining=chaining,
                      normals=_replayed_normals(R + 1), device="cpu")


def _no_stage(name, message):
    return contextlib.nullcontext()


def test_local_front_half_matches_jax():
    """The port's local front half on JAX's random numbers: each window's
    basis orthonormal to 1e-6 and, up to column signs, within 5e-3 of
    JAX's and 1e-4 of the exact singular vectors of JAX's centred block, singular values and the samples to
    1e-4 of their largest (float32 products), the sample times and
    centres exactly or to float32 roundoff; then each window's GP fit on
    JAX's samples from its restart starts, at the tolerances of
    ``test_torch_scaled.py::test_pod_and_gp_fit_match_jax``."""
    j = jax_local_front()
    gens = run_module.stage_generators(0, torch.device("cpu"), run_module.SCALED_STAGES)
    ts, Y, svdvals, fit, bases, mus = run_module._compress_and_fit_local(
        _no_stage, gens, _replayed_normals(R + 1), torch.device("cpu"), "synthetic", N, K, R, M,
        NRES, W,
    )
    assert ts.shape == (W, M // W) and Y.shape == (W, R, M // W) and Y.dtype == f64
    assert bases.shape == (W, N, R) and mus.shape == (W, N) and bases.dtype == f32
    assert fit.sigma2.shape == (W, R) and svdvals.shape == (W, R + 32)
    np.testing.assert_array_equal(ts.numpy(), j["ts"])
    np.testing.assert_allclose(mus.numpy(), np.stack(j["mus"]), rtol=0,
                               atol=1e-6 * np.abs(np.stack(j["mus"])).max())
    for w in range(W):
        jsv = j["svdvals"][w]
        np.testing.assert_allclose(svdvals[w, :R].numpy(), jsv[:R], rtol=0, atol=1e-4 * jsv[0])
        exact_U = np.linalg.svd(j["centered"][w].astype(np.float64), full_matrices=False)[0][:, :R]
        B = bases[w].numpy()
        np.testing.assert_allclose(B.T.astype(np.float64) @ B, np.eye(R), rtol=0, atol=1e-6)
        np.testing.assert_allclose(B * _signs(B, exact_U), exact_U, atol=1e-4)
        sign = _signs(B, j["bases"][w])
        np.testing.assert_allclose(B * sign, j["bases"][w], atol=5e-3)
        jY = np.asarray(j["Y"][w], np.float64)
        np.testing.assert_allclose(Y[w].numpy() * sign[0][:, None], jY, rtol=0,
                                   atol=5e-3 * np.abs(jY).max())

    box = BoxTransform.from_bounds(*BOUNDS, device="cpu", dtype=f64)
    logs = lambda f: np.log(np.stack([np.asarray(getattr(f, n), np.float64)
                                      for n in ("sigma2", "ell", "chi")], axis=1))
    for w in range(W):
        own = fit_gp_hyperparameters(_t(j["ts"][w]), _t(j["Y"][w], f64), box, n_restarts=NRES,
                                     adam_steps=150, polish_iters=30, z0=_t(j["z0"][w], f64))
        jfit = j["fit"][w]
        same = np.all(np.isclose(logs(own), logs(jfit), rtol=1e-3, atol=1e-3), axis=1)
        better = own.nlml.numpy() < np.asarray(jfit.nlml) - 1e-6
        assert same.sum() >= R - 1 and np.all(same | better), (w, logs(own), logs(jfit))


@pytest.mark.parametrize("weight_method", ["chol", "lowrank"])
def test_gp_estimate_windows_local_matches_jax(weight_method):
    """On JAX's per-window samples and hyperparameters: state and
    derivative estimates to 1e-7 of their scale, each window conditioned
    on its own samples only; the dense weights' C + eta I to 1e-7, the
    factored roots' weighted Gram matrices to 5e-3 (the roundoff-determined
    near-null space of C)."""
    j = jax_local_front()
    tw = np.linspace(0.0, 1.0, MP).reshape(W, MP // W)
    want_state, want_ddt, want_ctx = jscaled._gp_estimate_windows_local(
        j["ts"], jnp.stack(j["Y"]), *(jnp.asarray(h) for h in j["hyper"]), tw, weight_method,
        lambda msg: JTimedBlock(msg, silent=True))
    state, ddt, ctx = estimate.gp_estimate_windows_local(
        _t(j["ts"]), _t(np.stack(j["Y"]), f64), *(_t(h, f64) for h in j["hyper"]), _t(tw),
        weight_method)
    assert state.shape == (W, R, MP // W) and ctx[0] == weight_method
    for got, want in ((state, want_state), (ddt, want_ddt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7 * np.abs(want).max())
    # Window 1 differs from a global GP's estimate on the same grid.
    glob, _, _ = estimate.gp_estimate_windows(
        _t(j["ts"][0]), _t(j["Y"][0], f64), *(_t(h[0], f64) for h in j["hyper"]), _t(tw),
        weight_method)
    assert not torch.allclose(glob[1], state[1])
    if weight_method == "chol":
        LLt = ctx[1] @ ctx[1].transpose(-1, -2)
        jL = np.asarray(want_ctx[1])
        want = jL @ np.swapaxes(jL, -1, -2)
        np.testing.assert_allclose(LLt.numpy(), want, rtol=0, atol=1e-7 * np.abs(want).max())
        return
    rom = GalerkinROM("cA", state_dimension=R, substeps=2)
    jctx = ("lowrank", [[convert.lowrank_root(root, device="cpu") for root in row]
                        for row in want_ctx[1]])
    st, dd = _t(want_state), _t(want_ddt)
    got, _ = estimate.weight_windows(rom, st, dd, ctx)
    want, _ = estimate.weight_windows(rom, st, dd, jctx)
    gram = lambda A: np.einsum("wrmi,wrmj->wrij", A, A)
    want = gram(want.numpy())
    np.testing.assert_allclose(gram(got.numpy()), want, rtol=0, atol=5e-3 * np.abs(want).max())


def test_transfer_maps_match_jax():
    """T_w = B_{w+1}^T B_w and b_w = B_{w+1}^T (mu_w - mu_{w+1}) with the
    identity on the last window: on JAX's bases equal to the reference's
    formula (``run_scaled``'s chained rollouts) to float32 roundoff, and
    equal to the full-space map; on the port's own bases (replayed
    numbers) the full-space operators B_{w+1} T_w B_w^T and B_{w+1} b_w,
    which do not depend on the bases' signs, to 5e-4 of those of the exact
    singular vectors of JAX's centred blocks (JAX's float32 bases sit up
    to 5e-3 from them, ``test_local_front_half_matches_jax``)."""
    j = jax_local_front()
    jb, jm = jnp.asarray(np.stack(j["bases"])), jnp.asarray(np.stack(j["mus"]))
    jT = jnp.concatenate([jnp.einsum("wnr,wns->wrs", jb[1:], jb[:-1]),
                          jnp.eye(R, dtype=jnp.float32)[None]], axis=0)
    jbv = jnp.concatenate([jnp.einsum("wnr,wn->wr", jb[1:], jm[:-1] - jm[1:]),
                           jnp.zeros((1, R), jnp.float32)], axis=0)
    T, b = search.transfer_maps(_t(np.asarray(jb)), _t(np.asarray(jm)))
    assert T.shape == (W, R, R) and b.shape == (W, R)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jbv), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jbv)).max())
    q = np.random.default_rng(3).standard_normal(R)
    B, mu = np.stack(j["bases"]).astype(np.float64), np.stack(j["mus"]).astype(np.float64)
    full = B[1].T @ (mu[0] + B[0] @ q - mu[1])
    np.testing.assert_allclose(T[0].double().numpy() @ q + b[0].double().numpy(), full,
                               rtol=0, atol=1e-5 * np.abs(full).max())

    res = port_local_run()
    pB, pmu = _t(res.window_bases, f64), _t(res.window_means, f64)
    pT, pb = search.transfer_maps(pB, pmu)
    exact = _t(np.stack([np.linalg.svd(c.astype(np.float64), full_matrices=False)[0][:, :R]
                         for c in j["centered"]]))
    eT, eb = search.transfer_maps(exact, _t(mu))
    for w in range(W - 1):
        got, want = pB[w + 1] @ pT[w] @ pB[w].T, exact[w + 1] @ eT[w] @ exact[w].T
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-4)
        got, want = pB[w + 1] @ pb[w], exact[w + 1] @ eb[w]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=5e-4 * float(want.abs().max()))


def _grid_errors(jres):
    errs = np.asarray(jres.grid_errors)
    return np.where(errs >= np.float32(search.REJECTED), search.REJECTED, errs.astype(np.float64))


@pytest.mark.parametrize("chaining", ["draws", "anchor"])
def test_local_run_with_replayed_numbers(chaining):
    """The port's whole local run, every random number of the JAX run
    replayed, against JAX's ``run_scaled(window_basis="local")``: the same
    grid candidates rejected, the others scored within 40%, and the chosen
    scheme's error within a factor 2 of JAX's (the bounds of
    ``test_torch_scaled.py::test_run_scaled_windowed_with_replayed_numbers``:
    the port's own float64 fits and factorization stand between)."""
    jres, res = jax_local_run(chaining), port_local_run(chaining)
    assert res.window_basis == jres.window_basis == "local" and res.chaining == chaining
    assert res.window_regularizers.shape == (W,) and res.grid_errors.shape == (G, W)
    assert res.hyperparameters.shape == (W, R, 3) and res.samples.shape == (W, R, M // W)
    assert res.svdvals.shape == (W, R + 32)
    jerrs = _grid_errors(jres)
    np.testing.assert_array_equal(res.grid_errors >= search.REJECTED, jerrs >= search.REJECTED)
    ok = jerrs < search.REJECTED
    np.testing.assert_allclose(res.grid_errors[ok], jerrs[ok], rtol=0.4)
    for ours, theirs in ((res.train_error, jres.train_error),
                         (res.window_error, jres.window_error)):
        assert 0.5 * theirs < ours < 2.0 * theirs, (ours, theirs)
    assert res.stable_fraction == pytest.approx(jres.stable_fraction, abs=0.1)
    assert res.ensemble_mean.shape == (R, MP) and np.isfinite(res.ensemble_mean).all()


def test_local_checkpoint_resumes_to_the_bit(tmp_path):
    """A local run's front half (bases and centres included) resumes equal
    to the bit; a global run with the same sizes does not take it, nor a
    local run of another window count."""
    small = dict(SIZES, modelform="cA")
    first = run_scaled(**small, time_windows=W, window_basis="local",
                       checkpoint_dir=str(tmp_path), device="cpu")
    again = run_scaled(**small, time_windows=W, window_basis="local",
                       checkpoint_dir=str(tmp_path), device="cpu")
    front = {"data", "pod", "gp_fit"}
    assert front <= set(first.stage_seconds) and not front & set(again.stage_seconds)
    for name in ("grid_errors", "ensemble_mean", "window_bases", "window_means", "samples",
                 "hyperparameters", "window_regularizers"):
        np.testing.assert_array_equal(getattr(again, name), getattr(first, name))
    assert again.train_error == first.train_error
    glob = run_scaled(**small, time_windows=W, checkpoint_dir=str(tmp_path), device="cpu")
    assert front <= set(glob.stage_seconds) and glob.window_bases is None
    other = run_scaled(**small, time_windows=4, window_basis="local",
                       checkpoint_dir=str(tmp_path), device="cpu")
    assert front <= set(other.stage_seconds) and other.window_bases.shape == (4, N, R)
