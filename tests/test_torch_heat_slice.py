"""The heat-multi slice of the PyTorch port against the JAX package, on the
CPU at a small size (``SMALL``: L = 2 trajectories, 30 interior points, 11
prediction times, m = 12, m' = 16, r = 3, a 5-point grid, nd = 4, 16 GP
restarts, 20 ensemble draws).

Part 1 chains the stages: the JAX stages run as
``gp_bayesopinf_tpu.pipeline.pdes_multi.run_heat_multi`` composes them,
except that ``auto_regularize`` gets ``use_kernel=True`` so both sides
screen with kernel B's semantics (the XLA twin on the JAX side, the plain
PyTorch screen on the port's; without it the JAX CPU path takes the
generic objective with its 1e18 clip). Each JAX stage's output goes
through ``gp_bayesopinf_torch.convert`` into the port's next stage, with
JAX's random numbers replayed.

Part 2 holds ``refine_failure``. Part 3 runs the port's own
``run_heat_multi`` end to end with its own random streams and holds each
trajectory's ensemble error to within 2x of JAX's.

The chained check also runs at ex3's widths (``EX3_WIDTHS``, about 20
minutes on one CPU; marked slow, so the fast suite leaves it out):
``JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_heat_slice.py``.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.bayes import BayesianROM as JBayesianROM
from gp_bayesopinf_tpu.bayes import OperatorPosterior as JPosterior
from gp_bayesopinf_tpu.bayes import auto_regularize as j_auto_regularize
from gp_bayesopinf_tpu.gp import fit_gaussian_processes as j_fit_gps
from gp_bayesopinf_tpu.gp.fit import _initial_z
from gp_bayesopinf_tpu.gp.nlml import BoxTransform as JBox
from gp_bayesopinf_tpu.models.heat import CubicHeatBimodal as JCubic
from gp_bayesopinf_tpu.models.heat import HeatBimodal as JHeat
from gp_bayesopinf_tpu.models.heat import solve_host_stacked as j_solve_stacked
from gp_bayesopinf_tpu.pipeline.pdes_multi import input_func_factory as j_input_func
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.rom import QuadraticLiftedBasis as JBasis
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_tpu.utils import key_from_seed, split_tree
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.bayes import MAXOPTVAL, BayesianROM, OperatorPosterior
from gp_bayesopinf_torch.bayes import auto_regularize
from gp_bayesopinf_torch.gp import fit_gaussian_processes
from gp_bayesopinf_torch.models import CubicHeatBimodal, solve_host_stacked
from gp_bayesopinf_torch.pipeline import (
    GPBounds,
    HeatMultiConfig,
    ensemble_errors,
    run_heat_multi,
)
from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory, stacked_input_func
from gp_bayesopinf_torch.rom import GalerkinROM, QuadraticLiftedBasis
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

SPAN = (0.0, 1.0)
NOISE, TEST = 0.05, (1.5, 0.5)
BOUNDS = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))


class Size(NamedTuple):
    m: int  # samples per trajectory
    mprime: int  # GP estimation points
    r: int  # POD modes
    nres: int  # GP restarts
    nd: int  # screen draws per candidate
    ndraws: int  # ensemble draws
    space: np.ndarray
    time: np.ndarray
    params: tuple  # (a, b) per training trajectory
    grid: np.ndarray
    substeps: int

    @property
    def L(self):
        return len(self.params)


SMALL = Size(12, 16, 3, 16, 4, 20, np.linspace(0, 1, 32), np.linspace(0, 2, 11),
             ((-2, 0), (2, 2)), np.logspace(-1, 3, 5), 2)
# ex3's widths (5 trajectories, r = 5, m = 20, m' = 80, 100 restarts, the
# 81-point grid, 20 screen draws, 600 ensemble draws, 4 substeps) with its
# 500 spatial points and 500 times cut to 64 and 51.
EX3_WIDTHS = Size(20, 80, 5, 100, 20, 600, np.linspace(0, 1, 64), np.linspace(0, 2, 51),
                  ((-2, 0), (-1, -2), (0, 1), (1, -1), (2, 2)), np.logspace(-16, 4, 81), 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _config(S, seed=HeatMultiConfig.seed):
    return HeatMultiConfig(
        spatial_domain=S.space, time_domain=S.time, input_parameters=S.params,
        test_parameters=TEST, gp_bounds=GPBounds(*BOUNDS, S.nres), reg_grid=S.grid,
        fom_substeps=S.substeps, rom_substeps=S.substeps, seed=seed,
    )


def _rel_err(draws, valid, truth_c):
    mean = draws[valid].mean(0)
    return np.linalg.norm(mean - truth_c) / np.linalg.norm(truth_c)


def _jax_run(S, seed=HeatMultiConfig.seed):
    """The JAX stages of run_heat_multi, with use_kernel=True in the search.
    If every grid candidate fails the screen, the search raises and the
    run stops there, with ``res`` None."""
    cfg = _config(S, seed)
    L, R = S.L, S.r
    keys = split_tree(key_from_seed(cfg.seed),
                      ["sample", "noise", "fit", "search", "draws", "newparam"])
    q0 = np.asarray(JHeat.initial_conditions(S.space, cfg.left_bc, cfg.right_bc))
    foms = [JCubic(S.space, cfg.left_bc, cfg.right_bc, cfg.diffusion, a=a, b=b,
                   substeps=S.substeps) for a, b in S.params]
    t_s = np.sort(np.asarray(jax.random.uniform(keys["sample"], (S.m,), minval=SPAN[0],
                                                maxval=SPAN[1])))
    t_s[0], t_s[-1] = SPAN
    nkeys = jax.random.split(keys["noise"], L)
    true_states = j_solve_stacked(foms, q0, S.time)
    clean = j_solve_stacked(foms, q0, t_s)
    snaps = [np.asarray(f.noise(nkeys[ell], clean[ell], NOISE)) for ell, f in enumerate(foms)]
    basis = JBasis.fit(np.hstack(snaps), num_vectors=R)
    sc = np.stack([np.asarray(basis.compress(s)) for s in snaps])  # (L, r, m)
    t_est = np.linspace(SPAN[0], SPAN[1], S.mprime)
    gps = j_fit_gps(t_est, t_s, jnp.asarray(sc.reshape(L * R, S.m)), *BOUNDS,
                    n_restarts_optimizer=S.nres, key=keys["fit"])
    gps = [gps[ell * R : (ell + 1) * R] for ell in range(L)]
    rom = JROM("cAHBN", R, input_dimension=2, ivp_method="dirk2", substeps=S.substeps)
    funcs = [j_input_func(p) for p in S.params]
    st = jnp.stack([jnp.stack([g.state_estimate for g in gs]) for gs in gps])  # (L, r, m')
    D = jnp.stack([rom.data_matrix(st[ell], jnp.asarray(funcs[ell](jnp.asarray(t_est))))
                   for ell in range(L)])
    rhs = jnp.stack([jnp.stack([gps[ell][i].ddt_estimate for ell in range(L)]) for i in range(R)])
    sqrtW = jnp.stack([jnp.stack([gps[ell][i].sqrtW for ell in range(L)]) for i in range(R)])
    fac = j_lstsq_fit(D, sqrtW, rhs)
    predict_fns = [(lambda f: lambda O, q, t: rom.predict(O, q, t, input_func=f))(f)
                   for f in funcs]
    out = dict(keys=keys, q0=q0, true_states=np.asarray(true_states), t_s=t_s,
               clean=np.asarray(clean), snaps=np.stack(snaps), basis=basis, sc=sc,
               t_est=t_est, gps=gps, fac=fac, res=None)
    try:
        res = j_auto_regularize(
            fac, predict_fns, st[:, :, 0], S.time, t_est, st, keys["search"], grid=S.grid,
            ndraws=S.nd, verbose=False, refine_failure="raise", rom=rom, input_funcs=funcs,
            use_kernel=True,
        )
    except ValueError as exc:
        if "every candidate unstable" not in str(exc):
            raise
        return out
    post = JPosterior.from_lstsq(fac, res.regularizer)
    brom = JBayesianROM(rom, post, res.regularizer)
    qbar = jnp.mean(st, axis=2)
    bound = 5.0 * jnp.max(jnp.abs(st - qbar[..., None]), axis=2)
    dkeys = jax.random.split(keys["draws"], L)
    draws, valid, errs = [], [], []
    for ell in range(L):
        d_, v_ = brom.solution_posterior(dkeys[ell], st[ell][:, 0], S.time, ndraws=S.ndraws,
                                         input_func=funcs[ell],
                                         stability_envelope=(qbar[ell], bound[ell]))
        draws.append(np.asarray(d_))
        valid.append(np.asarray(v_))
        errs.append(_rel_err(draws[-1], valid[-1], np.asarray(basis.compress(true_states[ell]))))
    fom_new = JCubic(S.space, cfg.left_bc, cfg.right_bc, cfg.diffusion, a=TEST[0], b=TEST[1],
                     substeps=S.substeps)
    truth_new = np.asarray(fom_new.solve(q0, S.time))  # traced, as the JAX pipeline does
    comp_new = np.asarray(basis.compress(truth_new))
    d_new, v_new = brom.solution_posterior(keys["newparam"], comp_new[:, 0], S.time,
                                           ndraws=S.ndraws, input_func=j_input_func(TEST))
    err_new = _rel_err(np.asarray(d_new), np.asarray(v_new), comp_new)
    out.update(res=res, post=post, qbar=np.asarray(qbar), bound=np.asarray(bound),
               draws=np.stack(draws), valid=np.stack(valid), errs=errs, truth_new=truth_new,
               d_new=np.asarray(d_new), v_new=np.asarray(v_new), err_new=err_new)
    return out


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run(SMALL)


def _check_chained_stages(j, S):
    keys = j["keys"]
    cfg = _config(S)
    L, R, M, ND, NDRAWS, TIME = S.L, S.r, S.m, S.nd, S.ndraws, S.time

    # 1. Truth solves (host, stacked) and noise, the normals replayed.
    foms = [CubicHeatBimodal(S.space, cfg.left_bc, cfg.right_bc, cfg.diffusion, a=a, b=b,
                             substeps=S.substeps) for a, b in S.params]
    np.testing.assert_allclose(solve_host_stacked(foms, j["q0"], TIME), j["true_states"],
                               rtol=1e-13)
    for ell, key in enumerate(jax.random.split(keys["noise"], L)):
        normals = np.asarray(jax.random.normal(key, (S.space.size - 2, M - 1)))
        got = foms[ell].noise(_t(j["clean"][ell]), NOISE, normals=_t(normals))
        np.testing.assert_allclose(got.numpy(), j["snaps"][ell], rtol=1e-14)

    # 2. Joint lifted POD basis, up to column sign.
    basis = QuadraticLiftedBasis.fit(_t(np.hstack(list(j["snaps"]))), num_vectors=R)
    jentries = np.asarray(j["basis"].entries)
    signs = np.sign(np.sum(basis.entries.numpy() * jentries, axis=0))
    np.testing.assert_allclose(basis.entries.numpy() * signs, jentries, atol=1e-9)

    # 3. One batched fit of the L r GPs on JAX's compressed snapshots, JAX's
    # restart starts replayed; rtol 1e-4 on log hyperparameters, as the
    # Euler slice holds them (Cholesky roundoff grows over the Adam steps).
    jbox = JBox.from_bounds(*BOUNDS)
    z0 = np.stack([np.asarray(_initial_z(jbox, k, S.nres))
                   for k in jax.random.split(keys["fit"], L * R)])
    gps = fit_gaussian_processes(_t(j["t_est"]), _t(j["t_s"]), _t(j["sc"].reshape(L * R, M)),
                                 *BOUNDS, n_restarts_optimizer=S.nres, z0=_t(z0))
    jflat = [g for gs in j["gps"] for g in gs]
    for gp, jgp in zip(gps, jflat):
        np.testing.assert_allclose(
            np.log([gp.constant, gp.length_scale, gp.noise_level]),
            np.log([jgp.constant, jgp.length_scale, jgp.noise_level]), rtol=1e-4,
        )

    # 4. Stacked cAHBN regression on JAX's GP products, (r, L, m', m') roots.
    rom = GalerkinROM("cAHBN", R, input_dimension=2, ivp_method="dirk2", substeps=S.substeps)
    funcs = [input_func_factory(p) for p in S.params]
    jgps = [convert.gaussian_processes(gs, device="cpu") for gs in j["gps"]]
    st = torch.stack([torch.stack([g.state_estimate for g in gs]) for gs in jgps])
    t_est = _t(j["t_est"])
    D = torch.stack([rom.data_matrix(st[ell], funcs[ell](t_est)) for ell in range(L)])
    rhs = torch.stack([torch.stack([jgps[ell][i].ddt_estimate for ell in range(L)])
                       for i in range(R)])
    sqrtW = torch.stack([torch.stack([jgps[ell][i].sqrtW for ell in range(L)])
                         for i in range(R)])
    fac = weighted_lstsq_fit(D, sqrtW, rhs)
    np.testing.assert_allclose(fac.S.numpy(), np.asarray(j["fac"].S), rtol=1e-8,
                               atol=1e-10 * float(np.max(j["fac"].S)))

    # 5. The search on JAX's factorization and draws: the same rejections
    # and grid best, grid errors within rtol 1e-3 (float32 screens summed
    # in other orders), lambda within rtol 1e-2 (the bounded search stops
    # at its own tolerance).
    jfac = convert.weighted_lstsq(j["fac"], device="cpu")
    d = jfac.num_unknowns
    xi_grid = np.stack([np.asarray(jax.random.normal(k, (ND, R, d)))
                        for k in jax.random.split(keys["search"], S.grid.size)])
    xi_refine = np.asarray(jax.random.normal(jax.random.fold_in(keys["search"], 0x5EED),
                                             (ND, R, d)))
    search = dict(grid=S.grid, ndraws=ND, verbose=False, xi_grid=_t(xi_grid),
                  xi_refine=_t(xi_refine), input_funcs=funcs, refine_failure="raise")
    jres = j["res"]
    if jres is None:  # JAX's screen rejected every candidate: so must the port's
        with pytest.raises(ValueError, match="every candidate unstable"):
            auto_regularize(jfac, rom, st[:, :, 0], _t(TIME), t_est, st, **search)
        return
    res = auto_regularize(jfac, rom, st[:, :, 0], _t(TIME), t_est, st, **search)
    rejected = jres.grid_errors >= MAXOPTVAL
    np.testing.assert_array_equal(res.grid_errors >= MAXOPTVAL, rejected)
    assert (~rejected).sum() >= 2
    np.testing.assert_allclose(res.grid_errors[~rejected], jres.grid_errors[~rejected],
                               rtol=1e-3)
    assert res.grid_best == jres.grid_best
    np.testing.assert_allclose(res.regularizer, jres.regularizer, rtol=1e-2)

    # 6. The ensembles at JAX's lambda, the L trajectories as one batch, the
    # normals replayed: identical validity, means within rtol 1e-8.
    lam = jres.regularizer
    post = OperatorPosterior.from_lstsq(jfac, lam)
    brom = BayesianROM(rom, post, lam)
    xi = np.stack([np.asarray(jax.random.normal(k, (NDRAWS, R, d)))
                   for k in jax.random.split(keys["draws"], L)])
    draws, valid = brom.solution_posterior(
        st[:, :, 0], _t(TIME), xi=_t(xi), stability_envelope=(_t(j["qbar"]), _t(j["bound"])),
        input_func=stacked_input_func(S.params, "cpu"),
    )
    np.testing.assert_array_equal(valid.numpy(), j["valid"])
    for ell in range(L):
        np.testing.assert_allclose(draws[ell][valid[ell]].mean(0).numpy(),
                                   j["draws"][ell][j["valid"][ell]].mean(0),
                                   rtol=1e-8, atol=1e-12)

    # 7. The generalization test: the host truth solve against JAX's traced
    # one, and the ensemble at the test parameters.
    fom_new = CubicHeatBimodal(S.space, cfg.left_bc, cfg.right_bc, cfg.diffusion,
                               a=TEST[0], b=TEST[1], substeps=S.substeps)
    truth_new = fom_new.solve_host(j["q0"], TIME)
    np.testing.assert_allclose(truth_new, j["truth_new"], rtol=1e-10, atol=1e-12)
    comp_new = convert.quadratic_lifted_basis(j["basis"], device="cpu").compress(_t(truth_new))
    xi_new = np.asarray(jax.random.normal(keys["newparam"], (NDRAWS, R, d)))
    d_new, v_new = brom.solution_posterior(comp_new[:, 0], _t(TIME), xi=_t(xi_new),
                                           input_func=input_func_factory(TEST))
    np.testing.assert_array_equal(v_new.numpy(), j["v_new"])
    np.testing.assert_allclose(d_new[v_new].mean(0).numpy(), j["d_new"][j["v_new"]].mean(0),
                               rtol=1e-8, atol=1e-12)


def test_chained_stages_match_jax(jax_run):
    _check_chained_stages(jax_run, SMALL)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [HeatMultiConfig.seed, 1, 2, 3])
def test_chained_stages_match_jax_at_ex3_widths(seed):
    """The same chain at ex3's widths, where the 20-draw screen decides
    over 5 trajectories x 20 draws per candidate; at some seeds the JAX
    package's screen rejects every candidate, and then the port's must
    too. Prints the JAX package's own outcome (lambda, rejections, valid
    draws, errors) for the record."""
    j = _jax_run(EX3_WIDTHS, seed)
    res = j["res"]
    if res is None:
        print(f"\nJAX at ex3 widths, seed {seed}: every grid candidate rejected")
    else:
        print(f"\nJAX at ex3 widths, seed {seed}: lambda {res.regularizer:.6e}, grid best "
              f"{res.grid_best:.4e}, {int((res.grid_errors >= MAXOPTVAL).sum())}/"
              f"{res.grid_errors.size} rejected, valid {j['valid'].sum(axis=1).tolist()} and "
              f"{int(j['v_new'].sum())} at the test parameters, ensemble-mean errors vs "
              f"compressed truth {[round(float(e), 4) for e in j['errs']]}, test "
              f"{float(j['err_new']):.4f}")
    _check_chained_stages(j, EX3_WIDTHS)


def test_refine_failure_raises_or_falls_back():
    """A one-point grid whose draws all leave a zero-width envelope: the
    refinement fails, which raises under "raise" and returns the grid
    point under "fallback"."""
    rng = np.random.default_rng(5)
    rom = GalerkinROM("cAHBN", 2, input_dimension=1, ivp_method="dirk2", substeps=1)
    m = 12
    states, inputs = rng.standard_normal((2, m)), rng.standard_normal((1, m))
    D = rom.data_matrix(_t(states), _t(inputs))[None]
    fac = weighted_lstsq_fit(D, torch.eye(m, dtype=torch.float64).expand(2, 1, m, m),
                             _t(rng.standard_normal((2, 1, m))))
    t = _t(np.linspace(0, 0.2, 3))
    flat = torch.ones((1, 2, 3), dtype=torch.float64)  # a zero-width envelope
    kw = dict(grid=np.array([1e-2]), ndraws=3, verbose=False,
              generator=torch.Generator().manual_seed(0),
              input_funcs=[lambda tt: torch.sin(tt)[None]])
    with pytest.raises(RuntimeError, match="refinement failed"):
        auto_regularize(fac, rom, flat[:, :, 0], t, t, flat, refine_failure="raise", **kw)
    res = auto_regularize(fac, rom, flat[:, :, 0], t, t, flat, **kw)
    assert res.regularizer == 1e-2 and not res.refined
    with pytest.raises(ValueError, match="input_funcs"):
        auto_regularize(fac, rom, flat[:, :, 0], t, t, flat, grid=np.array([1e-2]), ndraws=3)


def test_run_heat_multi_end_to_end(jax_run):
    S = SMALL
    res = run_heat_multi(SPAN, S.m, NOISE, S.mprime, S.r, ndraws=S.ndraws, config=_config(S),
                         device="cpu", verbose=False)
    assert np.isfinite(res.regularizer) and res.regularizer > 0
    assert res.draws_compressed.shape == (S.L, S.ndraws, S.r, S.time.size)
    assert res.valid.shape == (S.L, S.ndraws) and bool((res.valid.sum(dim=1) > 0).all())
    assert torch.isfinite(res.draws_compressed[res.valid]).all()
    assert set(res.stage_seconds) == {"data", "pod", "gp_fit", "regression", "ensemble",
                                      "newparam"}
    errs, err_new = ensemble_errors(res)
    for err, jerr in zip(errs, jax_run["errs"]):
        assert err <= 2.0 * jerr, (errs, jax_run["errs"])
    assert err_new <= 2.0 * jax_run["err_new"], (err_new, jax_run["err_new"])
