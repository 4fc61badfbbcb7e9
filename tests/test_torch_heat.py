"""The heat-multi pieces of the PyTorch port against the JAX package on the
CPU: the cAHBN operators, the SDIRK2 integrators, the heat truth models,
the lifted POD basis and the implicit ensemble screen (kernel B's plain
version against the XLA twin; the Pallas kernel in interpret mode takes
~10 s here and is left to tests/test_ensemble_pallas.py, which holds it
to the twin).

Tolerances, float64 unless a test says otherwise: rtol 1e-12 where both
sides do the same arithmetic in another order; rtol 1e-10 over an
integration, where roundoff compounds over the steps and the port's
pivoted LU replaces the reference's unpivoted elimination.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.models import heat as jheat
from gp_bayesopinf_tpu.ops import quadratic as jquad
from gp_bayesopinf_tpu.ops.ensemble_pallas import (
    _input_stage_times,
    cahbn_ensemble_screen_xla as xla_screen,
)
from gp_bayesopinf_tpu.rom import GalerkinROM as JROM
from gp_bayesopinf_tpu.rom import QuadraticLiftedBasis as JBasis
from gp_bayesopinf_tpu.rom import operators as jops
from gp_bayesopinf_tpu.solve import ivp as jivp
from gp_bayesopinf_torch import convert
from gp_bayesopinf_torch.models import heat as theat
from gp_bayesopinf_torch.ops import cahbn_screen, quadratic as tquad
from gp_bayesopinf_torch.ops.cahbn_screen import (
    cahbn_ensemble_screen,
    cahbn_ensemble_screen_torch,
    input_stage_times,
)
from gp_bayesopinf_torch.pipeline.pdes_multi import stacked_input_func
from gp_bayesopinf_torch.rom import GalerkinROM as TROM
from gp_bayesopinf_torch.rom import QuadraticLiftedBasis as TBasis
from gp_bayesopinf_torch.rom import operators as tops
from gp_bayesopinf_torch.solve import ivp as tivp

R, NU = 3, 2
D = 1 + R + R * (R + 1) // 2 + NU + NU * R
SPACE = np.linspace(0, 1, 32)  # 30 interior points


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _operators(rng, n):
    """n stable-ish cAHBN operator draws (r = 3, nu = 2)."""
    Ohat = 0.2 * rng.standard_normal((n, R, D))
    Ohat[:, :, 1 : 1 + R] -= 1.2 * np.eye(R)
    return Ohat


# -- operators -------------------------------------------------------------------
def test_cahbn_operators_match_jax(rng):
    Ohat = _operators(rng, 4)
    states, inputs = rng.standard_normal((R, 9)), rng.standard_normal((NU, 9))
    assert tops.operator_dims("cAHBN", R, NU) == jops.operator_dims("cAHBN", R, NU)
    _close(tquad.state_input_kron(_t(inputs), _t(states)),
           jquad.state_input_kron(jnp.asarray(inputs), jnp.asarray(states)))
    _close(tops.assemble_data_matrix(_t(states), _t(inputs), "cAHBN"),
           jops.assemble_data_matrix(jnp.asarray(states), jnp.asarray(inputs), "cAHBN"))
    for name, block in tops.extract_operators(_t(Ohat[0]), "cAHBN", R, NU).items():
        _close(block, jops.extract_operators(jnp.asarray(Ohat[0]), "cAHBN", R, NU)[name])
    # Batched over draws, with one input shared by the batch.
    q, u = rng.standard_normal((4, R)), rng.standard_normal(NU)
    rhs = tops.rom_rhs(_t(Ohat), _t(q), _t(u), "cAHBN")
    jac = tops.rom_rhs_jacobian(_t(Ohat), _t(q), _t(u), "cAHBN")
    for n in range(4):
        args = (jnp.asarray(Ohat[n]), jnp.asarray(q[n]), jnp.asarray(u), "cAHBN", R, NU)
        _close(rhs[n], jops.rom_rhs(*args))
        _close(jac[n], jops.rom_rhs_jacobian(*args))
    with pytest.raises(ValueError, match="needs inputs"):
        tops.rom_rhs(_t(Ohat), _t(q), None, "cAHBN")


# -- integrators -------------------------------------------------------------------
def test_solve_small_matches_jax(rng):
    A = np.eye(5) + 0.1 * rng.standard_normal((6, 5, 5))
    b = rng.standard_normal((6, 5))
    got = tivp.solve_small(_t(A), _t(b))
    for n in range(6):
        _close(got[n], jivp.solve_small(jnp.asarray(A[n]), jnp.asarray(b[n])))


def test_dirk2_predict_matches_jax_vmap(rng):
    """Batched dirk2 ``GalerkinROM.predict`` against JAX's vmapped one,
    r = 3, k = 25, 2 substeps, with the heat inputs."""
    Ohat = _operators(rng, 5)
    q0, t = 0.3 * rng.standard_normal(R), np.linspace(0, 1.5, 25)
    a, b = 1.0, -2.0
    jrom = JROM("cAHBN", R, input_dimension=NU, ivp_method="dirk2", substeps=2)
    want = jax.vmap(lambda O: jrom.predict(
        O, jnp.asarray(q0), jnp.asarray(t),
        input_func=lambda tt: jheat.HeatBimodal.oscillators(tt, a, b),
    ))(jnp.asarray(Ohat))
    trom = TROM("cAHBN", R, input_dimension=NU, ivp_method="dirk2", substeps=2)
    got = trom.predict(_t(Ohat), _t(q0), _t(t),
                       input_func=lambda tt: theat.HeatBimodal.oscillators(tt, a, b))
    assert got.shape == (5, R, t.size)
    _close(got, want, rtol=1e-10, atol=1e-14)

    # Two trajectories in one batch, each with its own inputs and initial
    # state, give each trajectory's own integration.
    params = ((a, b), (-1.0, 0.5))
    q0s = np.stack([q0, -q0])
    both = trom.predict(_t(np.stack([Ohat, Ohat])), _t(q0s)[:, None], _t(t),
                        input_func=stacked_input_func(params, "cpu"))
    want2 = jax.vmap(lambda O: jrom.predict(
        O, jnp.asarray(-q0), jnp.asarray(t),
        input_func=lambda tt: jheat.HeatBimodal.oscillators(tt, -1.0, 0.5),
    ))(jnp.asarray(Ohat))
    _close(both[0], got, rtol=1e-14)
    _close(both[1], want2, rtol=1e-10, atol=1e-14)


def test_input_stage_times_match_jax():
    t = np.sort(np.random.default_rng(3).uniform(0, 2, 13))
    want = np.asarray(_input_stage_times(jnp.asarray(t), 4))
    np.testing.assert_array_equal(input_stage_times(_t(t), 4).numpy(), want)


# -- heat truth models ----------------------------------------------------------------
def _foms(cls_j, cls_t, params):
    kw = dict(left_bc=0.0, right_bc=1.0, diffusion=1e-2, substeps=2)
    return ([cls_j(SPACE, a=a, b=b, **kw) for a, b in params],
            [cls_t(SPACE, a=a, b=b, **kw) for a, b in params])


def test_heat_models_match_jax(rng):
    q0 = theat.HeatBimodal.initial_conditions(SPACE, 0.0, 1.0)
    _close(q0, jheat.HeatBimodal.initial_conditions(SPACE, 0.0, 1.0), rtol=1e-14)
    t = np.linspace(0, 0.6, 13)
    for cls_j, cls_t in ((jheat.HeatBimodal, theat.HeatBimodal),
                         (jheat.CubicHeatBimodal, theat.CubicHeatBimodal)):
        (jm,), (tm,) = _foms(cls_j, cls_t, [(1.5, -0.5)])
        q = q0[1:-1] + 0.1 * rng.standard_normal(tm.N)
        _close(tm.derivative(0.3, q), jm.derivative(0.3, jnp.asarray(q)))
        dl, dg, du = tm.jacobian_tridiag(0.3, q)
        _close(np.diag(dl[1:], -1) + np.diag(dg) + np.diag(du[:-1], 1),
               jm.jacobian(0.3, jnp.asarray(q)))
        want_host = jm.solve_host(q0, t)
        got = tm.solve_host(q0, t)
        _close(got, want_host, rtol=1e-13)
        # The traced reference runs every Newton iteration; the host solve
        # stops once a step is below 1e-9 relative.
        _close(got, jm.solve(jnp.asarray(q0), jnp.asarray(t)), rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="boundary"):
        tm.solve_host(q0 + 1.0, t)

    states = theat.HeatBimodal(SPACE).solve_host(q0, t)
    key = jax.random.PRNGKey(7)
    want = jheat.HeatBimodal(SPACE).noise(key, jnp.asarray(states), 0.05)
    normals = jax.random.normal(key, (SPACE.size - 2, t.size - 1))
    got = theat.HeatBimodal(SPACE).noise(_t(states), 0.05, normals=_t(normals))
    _close(got, want, rtol=1e-14)
    np.testing.assert_array_equal(got[:, 0].numpy(), states[:, 0])


def test_solve_host_stacked_matches_jax():
    params = [(-2.0, 0.0), (2.0, 2.0)]
    jf, tf = _foms(jheat.CubicHeatBimodal, theat.CubicHeatBimodal, params)
    q0 = theat.HeatBimodal.initial_conditions(SPACE, 0.0, 1.0)
    t = np.linspace(0, 2, 21)
    got = theat.solve_host_stacked(tf, q0, t)
    assert got.shape == (2, SPACE.size, t.size)
    _close(got, jheat.solve_host_stacked(jf, q0, t), rtol=1e-13)
    for ell in range(2):
        _close(got[ell], tf[ell].solve_host(q0, t), rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="homogeneous"):
        theat.solve_host_stacked([tf[0], theat.HeatBimodal(SPACE)], q0, t)


def test_quadratic_lifted_basis_matches_jax_up_to_sign():
    (jm,), (tm,) = _foms(jheat.CubicHeatBimodal, theat.CubicHeatBimodal, [(1.0, -1.0)])
    q0 = theat.HeatBimodal.initial_conditions(SPACE, 0.0, 1.0)
    snaps = tm.solve_host(q0, np.linspace(0, 1, 30))
    jb = JBasis.fit(jnp.asarray(snaps), num_vectors=4)
    tb = TBasis.fit(_t(snaps), num_vectors=4)
    s = np.sign(np.sum(tb.entries.numpy() * np.asarray(jb.entries), axis=0))
    assert np.all(np.abs(s) == 1)
    _close(tb.entries.numpy() * s, jb.entries, atol=1e-10)
    _close(tb.svdvals, jb.svdvals, atol=1e-12 * float(jb.svdvals[0]))
    comp_j = np.asarray(jb.compress(jnp.asarray(snaps)))
    _close(tb.compress(_t(snaps)).numpy() * s[:, None], comp_j, atol=1e-9 * np.abs(comp_j).max())
    cb = convert.quadratic_lifted_basis(jb, device="cpu")
    dec = cb.decompress(_t(comp_j))
    assert dec.shape == snaps.shape
    _close(dec, jb.decompress(jnp.asarray(comp_j)))


# -- kernel B's plain version ----------------------------------------------------------
def _screen_case(rng, G, nd, k, substeps=2, nan_draw=None):
    """The JAX tests' cAHBN screen inputs (tests/test_ensemble_pallas.py):
    a stable linear part, the last candidate sabotaged to diverge."""
    Ohat = _operators(rng, G * nd)
    Ohat[-nd:, :, 1 : 1 + R] += 4.0 * np.eye(R)
    if nan_draw is not None:
        Ohat[nan_draw, 0, 0] = np.nan
    t = np.linspace(0, 1.5, k)
    ts = _input_stage_times(jnp.asarray(t), substeps)
    u = np.asarray(jnp.stack([jnp.sin(2 * jnp.pi * ts), jnp.cos(4 * jnp.pi * ts)], axis=-1))
    return dict(Ohat=Ohat, q0=0.3 * rng.standard_normal(R), t_eval=t, shift=np.zeros(R),
                limits=np.full(R, 8.0), u_stages=u, snapshots=rng.standard_normal((R, k)))


NAMES = ("Ohat", "q0", "t_eval", "shift", "limits", "u_stages")


@pytest.mark.parametrize("G,nd,k,nan_draw", [
    (4, 4, 16, 5),  # the JAX tests' shapes, with a NaN operator draw
    (3, 7, 10, None),  # a draw count that is not a power of two
])
def test_plain_screen_matches_xla_twin(rng, G, nd, k, nan_draw):
    """Flags identical; err_sq within rtol 5e-4 on the candidates whose
    draws are all stable (float32 sums in other orders). The port's run
    without the error term gives the same flags and zero errors."""
    case = _screen_case(rng, G, nd, k, nan_draw=nan_draw)
    jargs = [jnp.asarray(case[n]) for n in NAMES] + [jnp.asarray(case["snapshots"])]
    s_x, e_x = (np.asarray(a) for a in xla_screen(*jargs, nd=nd, substeps=2))
    targs = [_t(case[n]) for n in NAMES]
    s_t, e_t = cahbn_ensemble_screen(*targs, _t(case["snapshots"]), nd=nd, substeps=2)
    assert s_t.dtype == torch.bool and e_t.dtype == torch.float32
    np.testing.assert_array_equal(s_t.numpy(), s_x)
    ok = s_x.reshape(G, nd).all(axis=1)
    assert ok[0] and not s_x[-nd:].any()
    np.testing.assert_allclose(e_t.numpy()[ok], e_x[ok], rtol=5e-4)
    if nan_draw is not None:
        assert not s_x[nan_draw]
        # The NaN stays inside its own candidate, as in the XLA twin.
        assert not torch.isfinite(e_t[nan_draw // nd]) and torch.isfinite(e_t[ok]).all()
    s_n, e_n = cahbn_ensemble_screen(*targs, None, nd=nd, substeps=2, track_error=False)
    np.testing.assert_array_equal(s_n.numpy(), s_x)
    assert bool((e_n == 0.0).all())


def test_cpu_tensors_take_the_plain_version(rng):
    case = _screen_case(rng, 2, 3, 6)
    args = [_t(case[n]) for n in NAMES] + [_t(case["snapshots"])]
    before = cahbn_screen.launches
    s1, e1 = cahbn_ensemble_screen(*args, nd=3)
    s2, e2 = cahbn_ensemble_screen_torch(*args, nd=3)
    assert cahbn_screen.launches == before
    assert torch.equal(s1, s2) and torch.equal(e1, e2)
    f32 = [a.float() for a in args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        cahbn_screen.cahbn_ensemble_screen_cuda(*f32, nd=3)
