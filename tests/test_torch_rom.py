"""The port's truth model, POD basis, ROM pieces, integrator and weighted
least squares against the JAX package's on the CPU, on the same inputs
and the same (injected) random numbers.

Tolerance: rtol 1e-10 in float64 unless a test says why otherwise.
Singular vectors are compared up to column sign: ``torch.linalg.svd``
may flip columns relative to JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.models import Euler as JEuler
from gp_bayesopinf_tpu.rom import EulerScaledBasis as JBasis
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.rom import operators as jops
from gp_bayesopinf_tpu.solve import ivp as jivp
from gp_bayesopinf_tpu.solve import lstsq as jlstsq
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.models import Euler as TEuler
from gp_bayesopinf_torch.rom import EulerScaledBasis as TBasis
from gp_bayesopinf_torch.rom import GalerkinROM as TROM
from gp_bayesopinf_torch.rom import operators as tops
from gp_bayesopinf_torch.solve import ivp as tivp
from gp_bayesopinf_torch.solve import lstsq as tlstsq

RTOL = 1e-10
INIT = (22, 20, 24, 95, 105, 100)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def euler():
    x = np.linspace(0, 2, 41)[:-1]
    jm, tm = JEuler(x, substeps=12), TEuler(x, substeps=12)
    q0_j = jm.initial_conditions(np.asarray(INIT))
    q0_t = tm.initial_conditions(INIT, device="cpu")
    t = np.linspace(0, 0.01, 11)
    return jm, tm, q0_j, q0_t, t


def test_euler_transforms_and_initial_conditions(euler, rng):
    jm, tm, q0_j, q0_t, _ = euler
    _close(q0_t, q0_j, rtol=1e-14)
    cons = np.asarray(JEuler.unlift(q0_j)) * (1 + 0.01 * rng.standard_normal(q0_j.shape))
    _close(TEuler.lift(_t(cons)), JEuler.lift(jnp.asarray(cons)), rtol=1e-13)
    _close(TEuler.unlift(TEuler.lift(_t(cons))), cons, rtol=1e-12)
    _close(tm.derivative(0.0, _t(cons)), jm.derivative(0.0, jnp.asarray(cons)), rtol=1e-12,
           atol=1e-9 * np.abs(np.asarray(jm.derivative(0.0, jnp.asarray(cons)))).max())


def test_euler_solve_matches_jax(euler):
    jm, tm, q0_j, q0_t, t = euler
    want = np.asarray(jm.solve(q0_j, t))
    got = tm.solve(q0_t, t)
    assert got.shape == want.shape
    _close(got, want, atol=1e-12 * np.abs(want).max())


def test_euler_noise_matches_jax_on_injected_normals(euler):
    jm, tm, q0_j, q0_t, t = euler
    states = np.asarray(jm.solve(q0_j, t))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.noise(key, jnp.asarray(states), 0.03))
    normals = np.asarray(jax.random.normal(key, (states.shape[0], states.shape[1] - 1)))
    got = tm.noise(_t(states), 0.03, normals=_t(normals))
    _close(got, want)
    np.testing.assert_array_equal(got[:, 0].numpy(), states[:, 0])


def _column_signs(a, b):
    """Signs s with a * s ~ b, per column."""
    return np.sign(np.sum(np.asarray(a) * np.asarray(b), axis=0))


def test_pod_basis_matches_jax_up_to_sign(euler, rng):
    jm, _, q0_j, _, t = euler
    snaps = np.asarray(jm.solve(q0_j, np.linspace(0, 0.02, 30)))
    jb = JBasis.fit(jnp.asarray(snaps), num_vectors=4)
    tb = TBasis.fit(_t(snaps), num_vectors=4)
    s = _column_signs(tb.entries, jb.entries)
    assert np.all(np.abs(s) == 1)
    _close(tb.entries.numpy() * s, jb.entries, atol=1e-10)
    _close(tb.svdvals, jb.svdvals, atol=1e-12 * float(jb.svdvals[0]))
    _close(tb.shift_vec, jb.shift_vec)
    comp_t = tb.compress(_t(snaps)).numpy()
    comp_j = np.asarray(jb.compress(jnp.asarray(snaps)))
    _close(comp_t * s[:, None], comp_j, atol=1e-9 * np.abs(comp_j).max())
    # Decompression of the same coordinates through the converted basis.
    cb = convert.euler_scaled_basis(jb)
    _close(cb.decompress(_t(comp_j)), jb.decompress(jnp.asarray(comp_j)))
    batch = np.stack([comp_j, 0.5 * comp_j])
    _close(cb.decompress(_t(batch))[1], jb.decompress(jnp.asarray(batch[1])))


@pytest.fixture
def rom_case(rng):
    r, G = 3, 4
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.2 * rng.standard_normal((G, r, d))
    Ohat[:, :, 1 : 1 + r] -= 0.8 * np.eye(r)
    return r, Ohat, 0.3 * rng.standard_normal(r), np.linspace(0, 1.5, 16)


def test_rom_pieces_match_jax(rom_case, rng):
    r, Ohat, q0, t = rom_case
    assert tops.operator_dims("cAH", r) == jops.operator_dims("cAH", r)
    states = rng.standard_normal((r, 9))
    _close(tops.assemble_data_matrix(_t(states), "cAH"),
           jops.assemble_data_matrix(jnp.asarray(states), None, "cAH"))
    for name, block in tops.extract_operators(_t(Ohat[0]), "cAH", r).items():
        _close(block, jops.extract_operators(jnp.asarray(Ohat[0]), "cAH", r)[name])
    _close(tops.rom_rhs(_t(Ohat[0]), _t(q0), "cAH"),
           jops.rom_rhs(jnp.asarray(Ohat[0]), jnp.asarray(q0), None, "cAH", r))
    with pytest.raises(ValueError):
        tops.operator_dims("cAHB", r)


def test_rom_predict_matches_jax_batched(rom_case):
    r, Ohat, q0, t = rom_case
    jrom, trom = JROM("cAH", r, substeps=4), TROM("cAH", r, substeps=4)
    got = trom.predict(_t(Ohat), _t(q0), _t(t))
    assert got.shape == (Ohat.shape[0], r, t.size)
    for g in range(Ohat.shape[0]):
        _close(got[g], jrom.predict(jnp.asarray(Ohat[g]), jnp.asarray(q0), jnp.asarray(t)))


def test_rk4_and_masks_match_jax(rom_case):
    r, Ohat, q0, t = rom_case
    Ohat = Ohat.copy()
    Ohat[-1, :, 1 : 1 + r] += 40.0 * np.eye(r)  # blows up to the clamp
    trom = TROM("cAH", r, substeps=8)
    jrom = JROM("cAH", r, substeps=8)
    got = trom.predict(_t(Ohat), _t(q0), _t(t))
    want = np.stack([np.asarray(jrom.predict(jnp.asarray(O), jnp.asarray(q0), jnp.asarray(t)))
                     for O in Ohat])
    _close(got, want)
    assert np.abs(want[-1]).max() >= jivp.DIVERGED
    shift, limits = np.zeros(r), np.full(r, 1.0)
    np.testing.assert_array_equal(
        tivp.stability_mask(got, _t(shift), _t(limits)).numpy(),
        np.asarray(jivp.stability_mask(jnp.asarray(want), jnp.asarray(shift), jnp.asarray(limits))),
    )
    np.testing.assert_array_equal(tivp.finite_mask(got).numpy(),
                                  np.asarray(jivp.finite_mask(jnp.asarray(want))))
    assert not tivp.finite_mask(got)[-1]


@pytest.fixture
def lstsq_case(rng):
    r, m, d = 3, 30, 10
    D = rng.standard_normal((1, m, d))
    A = rng.standard_normal((r, 1, m, m)) / np.sqrt(m)
    roots = A @ np.swapaxes(A, -1, -2) + np.eye(m)  # symmetric weight roots
    rhs = rng.standard_normal((r, 1, m))
    return D, roots, rhs


def test_weighted_lstsq_matches_jax(lstsq_case):
    D, roots, rhs = lstsq_case
    jf = jlstsq.weighted_lstsq_fit(jnp.asarray(D), jnp.asarray(roots), jnp.asarray(rhs))
    tf = tlstsq.weighted_lstsq_fit(_t(D), _t(roots), _t(rhs))
    _close(tf.S, jf.S)
    _close(tf.Dt, jf.Dt)
    _close(tf.zt, jf.zt)
    for lam in (1e-8, 0.3):
        _close(tf.solve(lam), jf.solve(lam))
        _close(tf.precision_eigs(lam), jf.precision_eigs(lam))
        _close(tf.covariances(lam), jf.covariances(lam), atol=1e-12)
        assert bool(tf.posterior_spd(lam)) == bool(jf.posterior_spd(lam))
    # A batch of candidates gives each candidate's scalar result.
    lams = _t([1e-8, 0.3])
    _close(tf.solve(lams)[1], jf.solve(0.3))
    assert tf.posterior_spd(lams).shape == (2,)


def test_weighted_lstsq_sample_on_injected_normals(lstsq_case):
    D, roots, rhs = lstsq_case
    jf = jlstsq.weighted_lstsq_fit(jnp.asarray(D), jnp.asarray(roots), jnp.asarray(rhs))
    tf = tlstsq.weighted_lstsq_fit(_t(D), _t(roots), _t(rhs))
    key, n, lam = jax.random.PRNGKey(5), 6, 0.05
    want = np.asarray(jf.sample(lam, key, n))
    xi = np.asarray(jax.random.normal(key, (n, tf.num_problems, tf.num_unknowns)))
    # The JAX factorization carried across reproduces the draws exactly.
    _close(convert.weighted_lstsq(jf).sample(lam, xi=_t(xi)), want)
    # The port's own SVD may flip V's columns: flip xi's components to
    # match, which is the same draw in the other sign convention.
    s = np.sign(np.einsum("rij,rij->rj", tf.V.numpy(), np.asarray(jf.V)))
    _close(tf.sample(lam, xi=_t(xi * s[None])), want)
    gen = torch.Generator().manual_seed(0)
    assert tf.sample(lam, n, generator=gen).shape == (n, 3, 10)
