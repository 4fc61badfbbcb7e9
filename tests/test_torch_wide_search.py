"""The Euler regularization search at r = 16, above kernel A's templated
instances (r <= 12), against the JAX package.

Both sides screen with the kernel's semantics: the JAX package's grid
objective is the one ``auto_regularize(use_kernel=True)`` builds (the XLA
twin on the CPU), the port's is its kernel objective (the plain screen on
the CPU), and the port runs on the JAX package's factorization with the
JAX package's random numbers replayed, as ``tests/test_torch_slice.py``
does at r = 3.

At r = 16 the POD modes past the signal are noise, and a GP fit to noise
estimates a state that is flat to roundoff: its screen envelope (5 times
the largest deviation of the estimate from its mean) is ~1e-9 of the
leading modes', so the coupling in any posterior operator draw carries
it out of its envelope unless the operator is shrunk to nothing. Every
grid candidate but those at the largest lambda is rejected, in both
packages.

The tier-1 test runs at the smallest size that still decides: nx 40, m
40, m' 160 (at least d = 153), 8 restarts, 1% noise, 5 draws and a
9-point grid from 1e-2 to 1e8, where eight candidates are rejected and
one is accepted: the same rejections, the accepted error to rtol 1e-6.

The slow test runs the JAX package's Euler pipeline stages at ex1a's
widths with r = 16 (``euler 0.06 200 0.03 400 16``: nx 200, m 200, m'
400, 100 restarts, the 81-point grid, 20 draws), seeds 0 and 1: the
reference's search rejects every grid candidate (ValueError, "every
candidate unstable"), and the port's search on the reference's
factorization and draws does the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_bayesopinf_tpu.bayes import auto_regularize as j_auto_regularize
from gp_bayesopinf_tpu.bayes.regsearch import _make_kernel_objective
from gp_bayesopinf_tpu.gp import fit_gaussian_processes as j_fit_gps
from gp_bayesopinf_tpu.models import Euler as JEuler
from gp_bayesopinf_tpu.pipeline.configs import EulerConfig as JConfig
from gp_bayesopinf_tpu.rom import EulerScaledBasis as JBasis
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.solve import weighted_lstsq_fit as j_lstsq_fit
from gp_bayesopinf_tpu.utils import key_from_seed, split_tree
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.bayes import MAXOPTVAL, auto_regularize, regsearch
from gp_bayesopinf_torch.rom import GalerkinROM

R = 16
SPAN = (0.0, 0.06)
BOUNDS = ((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_stages(space, time, m, noise, mprime, n_restarts, seed):
    """The JAX stages of ``run_euler`` up to the weighted regression, as
    ``gp_bayesopinf_tpu.pipeline.pdes.run_euler`` composes them."""
    cfg = JConfig(spatial_domain=space, time_domain=time, seed=seed)
    keys = split_tree(key_from_seed(seed), ["sample", "noise", "fit", "search", "draws"])
    model = JEuler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    q0 = np.asarray(model.initial_conditions(np.asarray(cfg.init_params)))
    t_s = np.sort(np.asarray(jax.random.uniform(keys["sample"], (m,), minval=SPAN[0],
                                                maxval=SPAN[1])))
    t_s[0], t_s[-1] = SPAN
    snaps = model.noise(keys["noise"], model.solve(q0, t_s), noise)
    basis = JBasis.fit(snaps, num_vectors=R, v_ref=cfg.v_ref, rho_ref=cfg.rho_ref)
    t_est = np.linspace(SPAN[0], SPAN[1], mprime)
    gps = j_fit_gps(t_est, t_s, basis.compress(snaps), *BOUNDS,
                    n_restarts_optimizer=n_restarts, key=keys["fit"])
    rom = JROM("cAH", state_dimension=R, substeps=cfg.rom_substeps)
    st = jnp.stack([g.state_estimate for g in gps])
    fac = j_lstsq_fit(rom.data_matrix(st)[None], jnp.stack([g.sqrtW for g in gps])[:, None],
                      jnp.stack([g.ddt_estimate for g in gps])[:, None])
    return dict(keys=keys, t_est=t_est, rom=rom, st=st, fac=fac, time=time)


def _port_inputs(j, grid, nd):
    """The port's ROM, GP estimates and JAX's factorization, and JAX's
    per-candidate standard normals of the grid phase (one key a
    candidate, ``jax.random.split(key, G)``) and of the refinement."""
    fac = convert.weighted_lstsq(j["fac"], device="cpu")
    d = fac.num_unknowns
    keys = jax.random.split(j["keys"]["search"], len(grid))
    xi_grid = np.stack([np.asarray(jax.random.normal(k, (nd, R, d))) for k in keys])
    xi_refine = np.asarray(jax.random.normal(jax.random.fold_in(j["keys"]["search"], 0x5EED),
                                             (nd, R, d)))
    rom = GalerkinROM("cAH", state_dimension=R, substeps=j["rom"].substeps)
    return fac, rom, _t(j["st"]), _t(xi_grid), _t(xi_refine)


def _flat_mode_envelopes(st):
    """The screen's envelope of each mode, relative to the widest one."""
    st = np.asarray(st)
    limits = 5.0 * np.abs(st - st.mean(axis=1)[:, None]).max(axis=1)
    return limits / limits.max()


def test_grid_decisions_match_jax_at_r16():
    grid, nd = np.logspace(-2, 8, 9), 5
    j = _jax_stages(np.linspace(0, 2, 41)[:-1], np.linspace(0, 0.09, 61), 40, 0.01, 160, 8,
                    27092023)
    objective = _make_kernel_objective(j["fac"], j["rom"], j["st"][:, 0][None],
                                       jnp.asarray(j["time"]), jnp.asarray(j["t_est"]),
                                       j["st"][None], nd, use_pallas=False)
    want = np.asarray(objective(jnp.asarray(grid), jax.random.split(j["keys"]["search"],
                                                                     len(grid))))
    fac, rom, st, xi_grid, _ = _port_inputs(j, grid, nd)
    got = regsearch._kernel_objective(fac, rom, st[:, 0][None], _t(j["time"]),
                                      _t(j["t_est"]), st[None], nd, None)(_t(grid), xi_grid)
    rejected = want >= MAXOPTVAL
    np.testing.assert_array_equal(got >= MAXOPTVAL, rejected)
    assert rejected[:-1].all() and not rejected[-1]  # decided: eight rejected, one accepted
    np.testing.assert_allclose(got[~rejected], want[~rejected], rtol=1e-6)
    # The rejections' cause: a mode whose GP estimate is flat to roundoff.
    assert _flat_mode_envelopes(j["st"]).min() < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_search_matches_jax_at_ex1a_widths_r16(seed):
    """``euler 0.06 200 0.03 400 16`` in the JAX package (search with
    ``use_kernel=True``) and the port's search on its factorization and
    draws: both reject every candidate of the 81-point grid."""
    cfg = JConfig()
    grid, nd = np.asarray(cfg.reg_grid), 20
    j = _jax_stages(cfg.spatial_domain, cfg.time_domain, 200, 0.03, 400,
                    cfg.gp_bounds.n_restarts, seed)
    rom = j["rom"]
    with pytest.raises(ValueError, match="every candidate unstable"):
        j_auto_regularize(j["fac"], [lambda O, q, t: rom.predict(O, q, t)], j["st"][:, 0][None],
                          cfg.time_domain, j["t_est"], j["st"][None], j["keys"]["search"],
                          grid=grid, ndraws=nd, verbose=False, rom=rom, use_kernel=True)
    fac, prom, st, xi_grid, xi_refine = _port_inputs(j, grid, nd)
    with pytest.raises(ValueError, match="every candidate unstable"):
        auto_regularize(fac, prom, st[:, 0], _t(cfg.time_domain), _t(j["t_est"]), st,
                        grid=grid, ndraws=nd, verbose=False, xi_grid=xi_grid,
                        xi_refine=xi_refine)
    assert _flat_mode_envelopes(j["st"]).min() < 1e-6
