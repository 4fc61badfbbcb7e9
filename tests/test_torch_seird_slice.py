"""The SEIRD slice of the PyTorch port against the JAX package, on the CPU
at a small size (T = 60, m = 24 integer-day samples per variable at
times of each variable's own, m' = 48, a 6-point grid, 4 draws a
candidate, 8 GP restarts, a 40-draw ensemble over [0, 90]).

Part 1 chains the stages: the JAX stages run as
``gp_bayesopinf_tpu.pipeline.odes.run_seird`` composes them, except that
``auto_regularize`` gets ``use_kernel=True`` so both sides screen with the
kernel's semantics (the XLA twin on the JAX side, the plain PyTorch
screen on the port's; without it the JAX CPU path takes the generic
objective with its 1e18 clip). Each JAX stage's output goes through
``gp_bayesopinf_torch.convert`` into the port's next stage, with JAX's
random numbers replayed: the restart starts, the grid's and the
refinement's normals, and both ensembles' normals.

Part 2 runs the port's own ``run_seird`` and its ``seird`` command line
end to end with their own random streams.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.bayes import BayesianODE as JBayesianODE
from gp_bayesopinf_tpu.bayes import KernelScreenSpec as JSpec
from gp_bayesopinf_tpu.bayes import OperatorPosterior as JPosterior
from gp_bayesopinf_tpu.bayes import auto_regularize as j_auto_regularize
from gp_bayesopinf_tpu.gp import fit_gaussian_processes as j_fit_gps
from gp_bayesopinf_tpu.gp.fit import _initial_z
from gp_bayesopinf_tpu.gp.nlml import BoxTransform as JBox
from gp_bayesopinf_tpu.models import SEIRD2 as JSEIRD2
from gp_bayesopinf_tpu.pipeline.configs import GPBounds as JGPBounds
from gp_bayesopinf_tpu.pipeline.configs import SEIRDConfig as JConfig
from gp_bayesopinf_tpu.pipeline.odes import sample_trajectory as j_sample_trajectory
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_tpu.utils import key_from_seed, split_tree
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.bayes import (
    MAXOPTVAL, BayesianODE, KernelScreenSpec, OperatorPosterior, auto_regularize,
)
from gp_bayesopinf_torch.gp import fit_gaussian_processes
from gp_bayesopinf_torch.pipeline import GPBounds, SEIRDConfig, cli, odes, run_seird
from gp_bayesopinf_torch.solve import weighted_lstsq_fit

SPAN = (0.0, 60.0)
M, NOISE, MPRIME, NRES, ND, NDRAWS = 24, 0.05, 48, 8, 4, 40
TIME = np.linspace(0, 90, 61)
GRID = np.logspace(-10, 2, 6)
BOUNDS = ((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5))
R, D = 5, 4  # state variables; regression unknowns (one row of 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX stages of run_seird, with use_kernel=True in the search."""
    cfg = JConfig(time_domain=TIME, gp_bounds=JGPBounds(*BOUNDS, NRES), reg_grid=GRID)
    keys = split_tree(key_from_seed(cfg.seed), ["sample", "fit", "search", "draws", "newic"])
    model = JSEIRD2(
        parameters=tuple(np.asarray(JSEIRD2.convert_parameters(cfg.true_parameters6))),
        substeps=cfg.substeps,
    )
    q0 = np.asarray(cfg.initial_conditions)
    true_states = np.asarray(model.solve_host(q0, TIME))
    t_s, snaps = j_sample_trajectory(keys["sample"], model, cfg, SPAN, M, NOISE)
    t_est = np.linspace(SPAN[0], SPAN[1], MPRIME)
    gps = j_fit_gps(t_est, t_s, snaps, *BOUNDS, n_restarts_optimizer=NRES, key=keys["fit"])
    assert gps[0].weight_method == "eigh"
    st = jnp.stack([g.state_estimate for g in gps])
    fac = j_lstsq_fit(
        model.data_matrix_blocks(st),
        jnp.stack([g.sqrtW for g in gps])[None],
        jnp.stack([g.ddt_estimate for g in gps])[None],
    )
    res = j_auto_regularize(
        fac, [lambda O, q, t: model.solve(q, t, parameters=O[0])], st[:, 0][None], TIME,
        t_est, st[None], keys["search"], grid=GRID, ndraws=ND, verbose=False,
        rom=JSpec(structure="cAH", state_dimension=R, substeps=model.substeps),
        operator_map=model.cah_operators, use_kernel=True,
    )
    post = JPosterior.from_lstsq(fac, res.regularizer)
    bode = JBayesianODE(model, post, res.regularizer)
    shift = jnp.mean(st, axis=1)
    limits = 5.0 * jnp.max(jnp.abs(st - shift[:, None]), axis=1)
    draws, valid = bode.solution_posterior(
        keys["draws"], q0, TIME, ndraws=NDRAWS, stability_envelope=(shift, limits)
    )
    q0_new = np.asarray(cfg.test_initial_conditions)
    newic, newic_valid = bode.solution_posterior(keys["newic"], q0_new, TIME, ndraws=NDRAWS)
    draws, valid = np.asarray(draws), np.asarray(valid)
    err = np.linalg.norm(draws[valid].mean(0) - true_states) / np.linalg.norm(true_states)
    return dict(cfg=cfg, keys=keys, model=model, q0=q0, q0_new=q0_new, true_states=true_states,
                t_s=np.asarray(t_s), snaps=np.asarray(snaps), t_est=t_est, gps=gps, fac=fac,
                res=res, post=post, shift=np.asarray(shift), limits=np.asarray(limits),
                draws=draws, valid=valid, newic=np.asarray(newic),
                newic_valid=np.asarray(newic_valid), err=err)


def test_chained_stages_match_jax(jax_run):
    j = jax_run
    keys = j["keys"]
    model = convert.seird_model(j["model"])

    # 1. Truth solve on the host: the reference may use its C++ core.
    np.testing.assert_allclose(model.solve_host(j["q0"], TIME), j["true_states"], rtol=1e-12,
                               atol=1e-16)

    # 2. GP fit on JAX's snapshots at each variable's own (5, 24) sample
    #    times, JAX's restart starts replayed. rtol 1e-4 on the log
    #    hyperparameters, as tests/test_torch_gp.py holds the fit.
    assert j["t_s"].shape == (R, M) and np.any(j["t_s"][0] != j["t_s"][1])
    jbox = JBox.from_bounds(*BOUNDS)
    z0 = np.stack([np.asarray(_initial_z(jbox, k, NRES))
                   for k in jax.random.split(keys["fit"], R)])
    gps = fit_gaussian_processes(
        _t(j["t_est"]), _t(j["t_s"]), _t(j["snaps"]), *BOUNDS,
        n_restarts_optimizer=NRES, z0=_t(z0),
    )
    for gp, jgp in zip(gps, j["gps"]):
        np.testing.assert_allclose(
            np.log([gp.constant, gp.length_scale, gp.noise_level]),
            np.log([jgp.constant, jgp.length_scale, jgp.noise_level]), rtol=1e-4,
        )
        np.testing.assert_array_equal(gp.t_training.numpy(), np.asarray(jgp.t_training))

    # 3. The block regression on JAX's GP products: D_blocks (5, m', 4),
    #    weight roots (1, 5, m', m'), right-hand sides (1, 5, m').
    jgps = convert.gaussian_processes(j["gps"], device="cpu")
    st = torch.stack([g.state_estimate for g in jgps])
    D_blocks = model.data_matrix_blocks(st)
    roots = torch.stack([g.sqrtW for g in jgps])[None]
    rhs = torch.stack([g.ddt_estimate for g in jgps])[None]
    assert D_blocks.shape == (R, MPRIME, D) and roots.shape == (1, R, MPRIME, MPRIME)
    fac = weighted_lstsq_fit(D_blocks, roots, rhs)
    assert (fac.num_problems, fac.num_unknowns) == (1, D)
    # The same weighted matrix through two SVD codes (as in
    # tests/test_torch_slice.py).
    np.testing.assert_allclose(fac.S.numpy(), np.asarray(j["fac"].S), rtol=1e-8,
                               atol=1e-10 * float(np.max(j["fac"].S)))
    np.testing.assert_allclose(fac.solve(1e-3).numpy(), np.asarray(j["fac"].solve(1e-3)),
                               rtol=1e-6)

    # 4. The search on JAX's factorization and normals, through the plain
    #    version of the quadratic screen with cah_operators as the map.
    jfac = convert.weighted_lstsq(j["fac"], device="cpu")
    xi_grid = np.stack([np.asarray(jax.random.normal(k, (ND, 1, D)))
                        for k in jax.random.split(keys["search"], GRID.size)])
    xi_refine = np.asarray(jax.random.normal(jax.random.fold_in(keys["search"], 0x5EED),
                                             (ND, 1, D)))
    spec = KernelScreenSpec("cAH", R, substeps=model.substeps)
    res = auto_regularize(jfac, spec, st[:, 0], _t(TIME), _t(j["t_est"]), st,
                          grid=GRID, ndraws=ND, verbose=False, xi_grid=_t(xi_grid),
                          xi_refine=_t(xi_refine), operator_map=model.cah_operators)
    jres = j["res"]
    rejected = jres.grid_errors >= MAXOPTVAL
    np.testing.assert_array_equal(res.grid_errors >= MAXOPTVAL, rejected)
    assert 1 <= rejected.sum() <= GRID.size - 2  # both outcomes occur
    np.testing.assert_allclose(res.grid_errors[~rejected], jres.grid_errors[~rejected],
                               rtol=5e-4)
    assert res.grid_best == jres.grid_best and res.refined == jres.refined
    np.testing.assert_allclose(res.regularizer, jres.regularizer, rtol=1e-2)

    # 5. Both ensembles at JAX's lambda, their normals replayed.
    lam = jres.regularizer
    post = OperatorPosterior.from_lstsq(jfac, lam)
    np.testing.assert_allclose(post.means.numpy(), np.asarray(j["post"].means), rtol=1e-10)
    bode = BayesianODE(model, post, lam)
    xi = np.asarray(jax.random.normal(keys["draws"], (NDRAWS, 1, D)))
    draws, valid = bode.solution_posterior(
        _t(j["q0"]), _t(TIME), xi=_t(xi),
        stability_envelope=(_t(j["shift"]), _t(j["limits"])),
    )
    np.testing.assert_array_equal(valid.numpy(), j["valid"])
    np.testing.assert_allclose(draws.numpy(), j["draws"], rtol=1e-6, atol=1e-12)
    xi = np.asarray(jax.random.normal(keys["newic"], (NDRAWS, 1, D)))
    newic, newic_valid = bode.solution_posterior(_t(j["q0_new"]), _t(TIME), xi=_t(xi))
    np.testing.assert_array_equal(newic_valid.numpy(), j["newic_valid"])
    np.testing.assert_allclose(newic.numpy(), j["newic"], rtol=1e-6, atol=1e-12)


def test_padded_chunks_do_not_change_the_search(jax_run):
    """A 22-point grid is 16 + 6: the second chunk wraps ten padded
    candidates. Every candidate's objective equals its value when the
    grid is evaluated one candidate at a time (chunks of 1, no padding)."""
    from gp_bayesopinf_torch.bayes import regsearch

    j = jax_run
    model = convert.seird_model(j["model"])
    jfac = convert.weighted_lstsq(j["fac"], device="cpu")
    st = torch.stack([_t(g.state_estimate) for g in j["gps"]])
    grid = np.logspace(-16, 5, 22)
    xi_grid = torch.randn((22, ND, 1, D), generator=torch.Generator().manual_seed(5),
                          dtype=torch.float64)
    objective = regsearch._kernel_objective(
        jfac, KernelScreenSpec("cAH", R, substeps=model.substeps), st[:, 0][None],
        _t(TIME), _t(j["t_est"]), st[None], ND, None, model.cah_operators,
    )
    alone = np.concatenate([objective(_t(grid[i : i + 1]), xi_grid[i : i + 1])
                            for i in range(22)])
    res = auto_regularize(
        jfac, KernelScreenSpec("cAH", R, substeps=model.substeps), st[:, 0], _t(TIME),
        _t(j["t_est"]), st, grid=grid, ndraws=ND, verbose=False, xi_grid=xi_grid,
        xi_refine=xi_grid[0], operator_map=model.cah_operators,
    )
    np.testing.assert_array_equal(res.grid_errors, alone)
    assert res.grid_best == grid[np.argmin(alone)]


def _small_config():
    return SEIRDConfig(time_domain=TIME, gp_bounds=GPBounds(*BOUNDS, NRES), reg_grid=GRID)


@pytest.mark.parametrize("weight_method", ["eigh", "chol"])
def test_run_seird_end_to_end(jax_run, weight_method):
    res = run_seird(SPAN, M, NOISE, MPRIME, ndraws=NDRAWS, config=_small_config(),
                    weight_method=weight_method, device="cpu", verbose=False)
    assert np.isfinite(res.regularizer) and res.regularizer > 0
    assert res.draws.shape == res.newic_draws.shape == (NDRAWS, R, TIME.size)
    assert int(res.valid.sum()) >= NDRAWS // 2 and int(res.newic_valid.sum()) >= NDRAWS // 2
    assert bool(torch.isfinite(res.draws[res.valid]).all())
    assert res.sample_times.shape == res.snapshots.shape == (R, M)
    assert res.gps[0].weight_method == weight_method
    assert set(res.stage_seconds) == {"data", "gp_fit", "regression", "ensemble", "newic"}
    # Another data instance than JAX's (other random streams): the error
    # within 3x of JAX's, and every parameter's posterior mean within the
    # reference's backend tolerance idea of the truth, rtol 0.5.
    err = odes.ensemble_error(res)
    assert err <= max(3.0 * jax_run["err"], 0.1), (err, jax_run["err"])
    assert odes.ensemble_error(res, newic=True) < 0.2
    np.testing.assert_allclose(res.bayesian_model.mean.numpy(), res.model.parameters, rtol=0.5)


def test_run_seird_crosscheck():
    res = run_seird(SPAN, M, NOISE, MPRIME, ndraws=4, config=_small_config(), crosscheck=True,
                    device="cpu", verbose=False)
    x = res.crosscheck
    assert x["state_estimate"] < 1e-10 and x["ddt_estimate"] < 1e-10 and x["sqrtW"] < 1e-6
    assert x["posterior_mean_allclose"] and x["posterior_std_allclose"]
    assert "crosscheck" in res.stage_seconds


def test_seird_cli_end_to_end(monkeypatch, capsys, tmp_path):
    """The ``seird`` subcommand through parser, pipeline and printout, at
    the small configuration in place of the default one; its records go
    to the working directory, here a temporary one."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(odes, "SEIRDConfig", _small_config)
    argv = ["seird", "60", str(M), str(NOISE), str(MPRIME), "--ndraws", "12", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "chosen regularizer:" in out and "stable draws:" in out and "/12" in out
    assert (tmp_path / "log.log").is_file() and "POSTERIOR DISTRIBUTION" in out
    args = cli.build_parser().parse_args(["seird", "90", "90", "0.10", "360"])
    assert (args.device, args.ndraws, args.crosscheck) == ("cuda", 100, False)
    with pytest.raises(SystemExit):  # seird takes no POD-mode count
        cli.build_parser().parse_args(["seird", "90", "90", "0.10", "360", "5"])
