"""The Euler slice of the PyTorch port against the JAX package, on the CPU
at a small size (nx = 40, m = 40, m' = 60, r = 3, a 9-point grid, nd = 5,
16 GP restarts, 50 draws).

Part 1 chains the stages: the JAX stages run exactly as
``gp_bayesopinf_tpu.pipeline.pdes.run_euler`` composes them, except that
``auto_regularize`` gets ``use_kernel=True`` so both sides screen with the
kernel's semantics (the XLA twin on the JAX side, the plain PyTorch
screen on the port's). Each JAX stage's output goes through
``gp_bayesopinf_torch.convert`` into the port's next stage, with JAX's
random numbers replayed. Carrying JAX's factorization across also keeps
the singular vectors' signs, which the replayed normals depend on.

Part 2 runs the port's own ``run_euler`` end to end with its own random
streams and holds its ensemble error to within 2x of JAX's.

Part 3 holds the derivative comparison data (``--ddtdata``) against the
JAX package's on JAX's GP products and basis, the normals replayed, and
runs the ``euler`` command line with ``--ddtdata --weights chol``.
"""

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
from gp_bayesopinf_tpu.models import Euler as JEuler
from gp_bayesopinf_tpu.pipeline.configs import EulerConfig as JConfig
from gp_bayesopinf_tpu.pipeline.configs import GPBounds as JGPBounds
from gp_bayesopinf_tpu.pipeline.pdes import _derivative_comparison_data
from gp_bayesopinf_tpu.rom import EulerScaledBasis as JBasis
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_tpu.utils import key_from_seed, split_tree
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.bayes import MAXOPTVAL, BayesianROM, OperatorPosterior
from gp_bayesopinf_torch.bayes import auto_regularize
from gp_bayesopinf_torch.gp import fit_gaussian_processes
from gp_bayesopinf_torch.models import Euler
from gp_bayesopinf_torch.pipeline import (
    EulerConfig, GPBounds, cli, derivative_comparison_data, ensemble_error, pdes, run_euler,
)
from gp_bayesopinf_torch.rom import EulerScaledBasis, GalerkinROM
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

SPAN = (0.0, 0.06)
M, NOISE, MPRIME, R, NRES, ND, NDRAWS = 40, 0.01, 60, 3, 16, 5, 50
SPACE = np.linspace(0, 2, 41)[:-1]
TIME = np.linspace(0, 0.09, 61)
GRID = np.logspace(-10, 4, 9)
BOUNDS = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX stages of run_euler, with use_kernel=True in the search."""
    cfg = JConfig(spatial_domain=SPACE, time_domain=TIME,
                  gp_bounds=JGPBounds(*BOUNDS, NRES), reg_grid=GRID)
    keys = split_tree(key_from_seed(cfg.seed), ["sample", "noise", "fit", "search", "draws"])
    model = JEuler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    q0 = np.asarray(model.initial_conditions(np.asarray(cfg.init_params)))
    true_states = model.solve(q0, TIME)
    t_s = np.sort(np.asarray(jax.random.uniform(keys["sample"], (M,), minval=SPAN[0],
                                                maxval=SPAN[1])))
    t_s[0], t_s[-1] = SPAN
    clean = model.solve(q0, t_s)
    snaps = model.noise(keys["noise"], clean, NOISE)
    basis = JBasis.fit(snaps, num_vectors=R, v_ref=cfg.v_ref, rho_ref=cfg.rho_ref)
    sc = basis.compress(snaps)
    t_est = np.linspace(SPAN[0], SPAN[1], MPRIME)
    gps = j_fit_gps(t_est, t_s, sc, *BOUNDS, n_restarts_optimizer=NRES, key=keys["fit"])
    rom = JROM("cAH", state_dimension=R, substeps=cfg.rom_substeps)
    st = jnp.stack([g.state_estimate for g in gps])
    fac = j_lstsq_fit(
        rom.data_matrix(st)[None],
        jnp.stack([g.sqrtW for g in gps])[:, None],
        jnp.stack([g.ddt_estimate for g in gps])[:, None],
    )
    res = j_auto_regularize(
        fac, [lambda O, q, t: rom.predict(O, q, t)], st[:, 0][None], TIME, t_est,
        st[None], keys["search"], grid=GRID, ndraws=ND, verbose=False, rom=rom,
        use_kernel=True,
    )
    post = JPosterior.from_lstsq(fac, res.regularizer)
    brom = JBayesianROM(rom, post, res.regularizer)
    qbar = jnp.mean(sc, axis=1)
    bound = 5.0 * jnp.max(jnp.abs(sc - qbar[:, None]), axis=1)
    draws, valid = brom.solution_posterior(
        keys["draws"], sc[:, 0], TIME, ndraws=NDRAWS, stability_envelope=(qbar, bound)
    )
    draws, valid = np.asarray(draws), np.asarray(valid)
    truth_c = np.asarray(basis.compress(true_states))
    err = np.linalg.norm(draws[valid].mean(0) - truth_c) / np.linalg.norm(truth_c)
    return dict(cfg=cfg, keys=keys, q0=q0, true_states=np.asarray(true_states), t_s=t_s,
                clean=np.asarray(clean), snaps=np.asarray(snaps), basis=basis,
                sc=np.asarray(sc), t_est=t_est, gps=gps, fac=fac, res=res, post=post,
                qbar=np.asarray(qbar), bound=np.asarray(bound), draws=draws,
                valid=valid, err=err)


def test_chained_stages_match_jax(jax_run):
    j = jax_run
    cfg, keys = j["cfg"], j["keys"]

    # 1. Truth model and noise, the normals replayed.
    model = Euler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    q0 = model.initial_conditions(cfg.init_params, device="cpu")
    truth = model.solve(q0, TIME).numpy()
    np.testing.assert_allclose(truth, j["true_states"], rtol=1e-10,
                               atol=1e-12 * np.abs(j["true_states"]).max())
    normals = np.asarray(jax.random.normal(keys["noise"], (SPACE.size * 3, M - 1)))
    snaps = model.noise(_t(j["clean"]), NOISE, normals=_t(normals)).numpy()
    np.testing.assert_allclose(snaps, j["snaps"], rtol=1e-10)

    # 2. POD basis, up to column sign.
    basis = EulerScaledBasis.fit(_t(j["snaps"]), num_vectors=R,
                                 v_ref=cfg.v_ref, rho_ref=cfg.rho_ref)
    jentries = np.asarray(j["basis"].entries)
    signs = np.sign(np.sum(basis.entries.numpy() * jentries, axis=0))
    np.testing.assert_allclose(basis.entries.numpy() * signs, jentries, atol=1e-9)

    # 3. GP fit on JAX's compressed snapshots, JAX's restart starts replayed.
    jbox = JBox.from_bounds(*BOUNDS)
    z0 = np.stack([np.asarray(_initial_z(jbox, k, NRES))
                   for k in jax.random.split(keys["fit"], R)])
    gps = fit_gaussian_processes(
        _t(j["t_est"]), _t(j["t_s"]), _t(j["sc"]), *BOUNDS,
        n_restarts_optimizer=NRES, z0=_t(z0),
    )
    # rtol 1e-4 on log hyperparameters: Cholesky roundoff of two LAPACK/XLA
    # factorizations grows over 60 Adam steps (see tests/test_torch_gp.py).
    for gp, jgp in zip(gps, j["gps"]):
        np.testing.assert_allclose(
            np.log([gp.constant, gp.length_scale, gp.noise_level]),
            np.log([jgp.constant, jgp.length_scale, jgp.noise_level]), rtol=1e-4,
        )

    # 4. Regression on JAX's GP products.
    jgps = convert.gaussian_processes(j["gps"], device="cpu")
    rom = GalerkinROM("cAH", state_dimension=R, substeps=cfg.rom_substeps)
    st = torch.stack([g.state_estimate for g in jgps])
    fac = weighted_lstsq_fit(
        rom.data_matrix(st)[None],
        torch.stack([g.sqrtW for g in jgps])[:, None],
        torch.stack([g.ddt_estimate for g in jgps])[:, None],
    )
    # The same weighted matrix through two SVD codes; sqrtW's condition
    # number (~1e12) leaves the small singular values fewer digits.
    np.testing.assert_allclose(fac.S.numpy(), np.asarray(j["fac"].S), rtol=1e-8,
                               atol=1e-10 * float(np.max(j["fac"].S)))

    # 5. The regularization search on JAX's factorization and draws.
    jfac = convert.weighted_lstsq(j["fac"], device="cpu")
    d = jfac.num_unknowns
    xi_grid = np.stack([np.asarray(jax.random.normal(k, (ND, R, d)))
                        for k in jax.random.split(keys["search"], GRID.size)])
    xi_refine = np.asarray(jax.random.normal(jax.random.fold_in(keys["search"], 0x5EED),
                                             (ND, R, d)))
    res = auto_regularize(jfac, rom, st[:, 0], _t(TIME), _t(j["t_est"]), st,
                          grid=GRID, ndraws=ND, verbose=False,
                          xi_grid=_t(xi_grid), xi_refine=_t(xi_refine))
    jres = j["res"]
    rejected = jres.grid_errors >= MAXOPTVAL
    np.testing.assert_array_equal(res.grid_errors >= MAXOPTVAL, rejected)
    assert (~rejected).sum() >= 2
    np.testing.assert_allclose(res.grid_errors[~rejected], jres.grid_errors[~rejected],
                               rtol=1e-3)
    assert np.argmin(res.grid_errors) == np.argmin(jres.grid_errors)
    assert res.grid_best == jres.grid_best
    np.testing.assert_allclose(res.regularizer, jres.regularizer, rtol=1e-2)

    # 6. The ensemble at JAX's lambda, its normals replayed.
    lam = jres.regularizer
    post = OperatorPosterior.from_lstsq(jfac, lam)
    jpost = convert.operator_posterior(j["post"], device="cpu")
    np.testing.assert_allclose(post.means.numpy(), jpost.means.numpy(), rtol=1e-10)
    np.testing.assert_allclose(post.cov_factors.numpy(), jpost.cov_factors.numpy(),
                               rtol=1e-10, atol=1e-12 * jpost.cov_factors.abs().max().item())
    brom = BayesianROM(rom, post, lam)
    xi = np.asarray(jax.random.normal(keys["draws"], (NDRAWS, R, d)))
    draws, valid = brom.solution_posterior(
        _t(j["sc"][:, 0]), _t(TIME), xi=_t(xi),
        stability_envelope=(_t(j["qbar"]), _t(j["bound"])),
    )
    np.testing.assert_array_equal(valid.numpy(), j["valid"])
    np.testing.assert_allclose(draws[valid].mean(0).numpy(), j["draws"][j["valid"]].mean(0),
                               rtol=1e-8, atol=1e-12)


def test_run_euler_end_to_end(jax_run):
    cfg = EulerConfig(spatial_domain=SPACE, time_domain=TIME,
                      gp_bounds=GPBounds(*BOUNDS, NRES), reg_grid=GRID)
    res = run_euler(SPAN, M, NOISE, MPRIME, R, ndraws=NDRAWS, config=cfg,
                    device="cpu", verbose=False)
    assert np.isfinite(res.regularizer) and res.regularizer > 0
    n_valid = int(res.valid.sum())
    assert n_valid > 0
    assert res.draws.shape == (n_valid, 3 * SPACE.size, TIME.size)
    assert torch.isfinite(res.draws).all()
    assert set(res.stage_seconds) == {"data", "pod", "gp_fit", "regression",
                                      "ensemble", "decompress"}
    err = ensemble_error(res)
    assert err <= 2.0 * jax_run["err"], (err, jax_run["err"])


def test_lift_ddts_matches_jax(rng):
    cons = np.abs(rng.standard_normal((3 * 7, 4))) + 1.0
    ddts = rng.standard_normal((3 * 7, 4))
    np.testing.assert_allclose(
        Euler.lift_ddts(_t(cons), _t(ddts)).numpy(),
        np.asarray(JEuler.lift_ddts(jnp.asarray(cons), jnp.asarray(ddts))), rtol=1e-13,
    )


def test_derivative_comparison_data_matches_jax(jax_run):
    """Every array of the comparison data against the reference's. The
    finite differences and the GP means are the same arithmetic (rtol
    1e-12); the truth derivatives go through a 1000-point solve in each
    package (rtol 1e-8 of their scale); the sample standard deviations
    through each package's eigh of the rank-deficient covariance (rtol
    1e-6 of each mode's largest)."""
    j = jax_run
    cfg, ndraws = j["cfg"], 30
    jmodel = JEuler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    want = _derivative_comparison_data(
        jmodel, j["basis"], j["gps"], cfg, j["t_s"], jnp.asarray(j["sc"]), j["t_est"],
        j["keys"]["draws"], ndraws,
    )
    normals = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(j["keys"]["draws"], i),
                                                     (ndraws, MPRIME))) for i in range(R)])
    model = Euler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    got = derivative_comparison_data(
        model, convert.euler_scaled_basis(j["basis"], device="cpu"),
        convert.gaussian_processes(j["gps"], device="cpu"),
        model.initial_conditions(cfg.init_params, device="cpu"), j["t_s"], _t(j["sc"]),
        j["t_est"], ndraws, normals=_t(normals),
    )
    assert set(got) == set(want)
    for name in ("time_domain_FD", "time_domain_GP", "time_domain_truth"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))
    for name in ("ddts_finitedifferences", "ddts_GPmean"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=1e-12)
    truth = np.asarray(want["ddts_truth"])
    assert truth.shape == (R, 1000)
    np.testing.assert_allclose(got["ddts_truth"], truth, rtol=0, atol=1e-8 * np.abs(truth).max())
    std = np.asarray(want["ddts_GPstd"])
    assert std.shape == (R, MPRIME) and np.all(std.max(axis=1) > 0)
    rel = np.abs(got["ddts_GPstd"] - std).max(axis=1) / std.max(axis=1)
    assert np.all(rel < 1e-6), rel
    # Drawn from a generator instead: the same statistics, other samples.
    drawn = derivative_comparison_data(
        model, convert.euler_scaled_basis(j["basis"], device="cpu"),
        convert.gaussian_processes(j["gps"], device="cpu"),
        model.initial_conditions(cfg.init_params, device="cpu"), j["t_s"], _t(j["sc"]),
        j["t_est"], 400, generator=torch.Generator().manual_seed(2),
    )
    np.testing.assert_allclose(drawn["ddts_GPstd"].max(axis=1), std.max(axis=1), rtol=0.3)


def test_euler_cli_ddtdata_and_chol_weights(monkeypatch, capsys):
    """``euler ... --ddtdata --weights chol`` through parser and pipeline
    at the small configuration in place of the default one."""
    small = EulerConfig(spatial_domain=SPACE, time_domain=TIME,
                        gp_bounds=GPBounds(*BOUNDS, NRES), reg_grid=GRID)
    monkeypatch.setattr(pdes, "EulerConfig", lambda: small)
    argv = ["euler", "0.06", str(M), str(NOISE), str(MPRIME), str(R), "--ndraws", "20",
            "--device", "cpu", "--ddtdata", "--weights", "chol"]
    res = cli.run(argv)
    assert res.gps[0].weight_method == "chol"
    assert bool(torch.equal(res.gps[0].sqrtW, torch.tril(res.gps[0].sqrtW)))
    assert np.isfinite(res.regularizer) and int(res.valid.sum()) > 0
    assert res.ddtdata["ddts_GPstd"].shape == (R, MPRIME)
    assert res.ddtdata["ddts_truth"].shape == (R, 1000)
    assert "ddtdata" in res.stage_seconds
    # The GP derivative means track the truth's derivatives on the span.
    truth_at_est = np.stack([np.interp(res.t_estimation, res.ddtdata["time_domain_truth"], row)
                             for row in res.ddtdata["ddts_truth"]])
    rel = np.linalg.norm(res.ddtdata["ddts_GPmean"] - truth_at_est) / np.linalg.norm(truth_at_est)
    assert rel < 0.5, rel
    args = cli.build_parser().parse_args(["euler", "0.06", "200", "0.03", "400", "6"])
    assert (args.weights, args.ddtdata) == ("auto", False)
    with pytest.raises(NotImplementedError, match="low-rank"):
        cli.run(argv[:-1] + ["lowrank"])
    with pytest.raises(NotImplementedError, match="1024"):
        run_euler(SPAN, M, NOISE, 1024, R, config=small, weight_method="auto", device="cpu",
                  verbose=False)
