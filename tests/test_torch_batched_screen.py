"""The batched form of the port's two ensemble screens: L problems (one
per trajectory) sharing the operator draws and the time grid, a leading L
on q0, shift, limits, u_stages and snapshots.

On the CPU the screens take their plain versions, which screen the L
problems one after another; so the batched results must equal a loop of
single-problem calls bit for bit, and each trajectory must match the JAX
package's XLA twin with the tolerances of ``test_torch_screen.py`` (rtol
2e-4, atol 1e-4 for the RK4 screen) and ``test_torch_heat.py`` (rtol 5e-4
for the SDIRK2 screen): float32 sums in other orders. The objective of
the regularization search, which makes one screen call per time grid for
all trajectories, must give the values of the per-trajectory loop it
replaced, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.ops.ensemble_pallas import (
    _input_stage_times,
    cahbn_ensemble_screen_xla,
    quadratic_ensemble_screen_xla,
)
from gp_bayesopinf_torch.bayes.regsearch import MAXOPTVAL, _kernel_objective
from gp_bayesopinf_torch.ops.cahbn_screen import (
    cahbn_ensemble_screen,
    cahbn_ensemble_screen_torch,
    input_stage_times,
)
from gp_bayesopinf_torch.ops.ensemble_screen import (
    quadratic_ensemble_screen,
    quadratic_ensemble_screen_torch,
)
from gp_bayesopinf_torch.rom import GalerkinROM
from gp_bayesopinf_torch.solve.lstsq import weighted_lstsq_fit

NU = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _operators(rng, r, G, nd, nu=0):
    """Stable-ish draws; the last candidate's draws diverge."""
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    Ohat = 0.2 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 1.2 * np.eye(r)
    Ohat[-nd:, :, 1 : 1 + r] += 4.0 * np.eye(r)
    return Ohat


def _nan_in_one_trajectory(Ohat, q0, draw, ell):
    """Make ``draw`` NaN in trajectory ``ell`` only. Row 1 of the draw
    becomes a pure decay, so q_1 stays exactly 0 wherever it starts at 0;
    row 0 gets +-1e38 on q_1^2 and q_1 q_0, which are 0 there and
    overflow to inf - inf where q_1 starts at 2 (trajectory ``ell``)."""
    r = q0.shape[1]
    Ohat[draw, 1, :] = 0.0
    Ohat[draw, 1, 1 + 1] = -1.0
    Ohat[draw, 0, 1 + r + 2] = 1e38  # ckron(q) index 2: q_1 q_1
    Ohat[draw, 0, 1 + r + 1] = -1e38  # ckron(q) index 1: q_1 q_0
    q0[:, 1] = 0.0
    q0[ell, 1] = 2.0


def _quadratic_case(rng, r, G, nd, k, L):
    return dict(
        Ohat=_operators(rng, r, G, nd),
        q0=0.4 * rng.standard_normal((L, r)),
        t_eval=np.linspace(0, 2.0, k),
        shift=0.05 * rng.standard_normal((L, r)),
        limits=np.full((L, r), 10.0),
        snapshots=rng.standard_normal((L, r, k)),
    )


def _cahbn_case(rng, r, G, nd, k, L, substeps):
    t = np.linspace(0, 1.5, k)
    ts = np.asarray(_input_stage_times(jnp.asarray(t), substeps))
    ab = rng.uniform(-2.0, 2.0, (L, 2))
    u = np.stack([ab[:, :1] * np.sin(2 * np.pi * ts), ab[:, 1:] * np.sin(4 * np.pi * ts)], -1)
    return dict(
        Ohat=_operators(rng, r, G, nd, NU),
        q0=0.3 * rng.standard_normal((L, r)),
        t_eval=t,
        shift=np.zeros((L, r)),
        limits=np.full((L, r), 8.0),
        u_stages=u,
        snapshots=rng.standard_normal((L, r, k)),
    )


PER_PROBLEM = ("q0", "shift", "limits", "u_stages", "snapshots")


def _torch_args(case, ell=None):
    """The case as tensors, batched or (``ell`` given) one trajectory."""
    return {n: torch.as_tensor(v if ell is None or n not in PER_PROBLEM else v[ell])
            for n, v in case.items()}


def _assert_equal(batched, singles):
    s_b, e_b = batched
    assert torch.equal(s_b, torch.stack([s for s, _ in singles]))
    torch.testing.assert_close(e_b, torch.stack([e for _, e in singles]),
                               rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("r,G,nd,k,L", [
    (3, 4, 5, 20, 3),
    (2, 3, 7, 12, 2),  # a draw count that is not a power of two
])
def test_batched_quadratic_screen_equals_loop_and_xla(rng, r, G, nd, k, L):
    case = _quadratic_case(rng, r, G, nd, k, L)
    kw = dict(nd=nd, substeps=4)
    s_b, e_b = quadratic_ensemble_screen(**_torch_args(case), **kw)
    assert s_b.shape == (L, G * nd) and e_b.shape == (L, G)
    singles = [quadratic_ensemble_screen(**_torch_args(case, ell), **kw) for ell in range(L)]
    _assert_equal((s_b, e_b), singles)
    for ell in range(L):
        jargs = {n: jnp.asarray(v if n not in PER_PROBLEM else v[ell]) for n, v in case.items()}
        s_x, e_x = (np.asarray(a) for a in quadratic_ensemble_screen_xla(**jargs, **kw))
        np.testing.assert_array_equal(s_b[ell].numpy(), s_x)
        ok = s_x.reshape(G, nd).all(axis=1)
        assert ok.any() and not ok[-1]
        np.testing.assert_allclose(e_b[ell].numpy()[ok], e_x[ok], rtol=2e-4, atol=1e-4)
    s_n, e_n = quadratic_ensemble_screen(**_torch_args(case), **kw, track_error=False)
    assert torch.equal(s_n, s_b) and bool((e_n == 0.0).all()) and e_n.shape == (L, G)


@pytest.mark.parametrize("G,nd,k,L", [
    (3, 4, 12, 3),
    (2, 7, 8, 2),  # a draw count that is not a power of two
])
def test_batched_cahbn_screen_equals_loop_and_xla(rng, G, nd, k, L):
    r = 3
    case = _cahbn_case(rng, r, G, nd, k, L, substeps=2)
    kw = dict(nd=nd, substeps=2)
    s_b, e_b = cahbn_ensemble_screen(**_torch_args(case), **kw)
    assert s_b.shape == (L, G * nd) and e_b.shape == (L, G)
    singles = [cahbn_ensemble_screen(**_torch_args(case, ell), **kw) for ell in range(L)]
    _assert_equal((s_b, e_b), singles)
    for ell in range(L):
        jargs = {n: jnp.asarray(v if n not in PER_PROBLEM else v[ell]) for n, v in case.items()}
        s_x, e_x = (np.asarray(a) for a in cahbn_ensemble_screen_xla(**jargs, **kw))
        np.testing.assert_array_equal(s_b[ell].numpy(), s_x)
        ok = s_x.reshape(G, nd).all(axis=1)
        assert ok.any() and not ok[-1]
        np.testing.assert_allclose(e_b[ell].numpy()[ok], e_x[ok], rtol=5e-4)


@pytest.mark.parametrize("kind", ["quadratic", "cahbn"])
def test_nan_draw_in_one_trajectory_stays_there(rng, kind):
    """A draw that turns NaN in trajectory 1 only: there it is unstable
    and its candidate's error is NaN; the other trajectories' flags and
    errors are those of a run without trajectory 1, and there the draw is
    stable."""
    G, nd, L, draw = 3, 5, 3, 2
    if kind == "quadratic":
        case, screen, kw = _quadratic_case(rng, 3, G, nd, 16, L), quadratic_ensemble_screen, {}
    else:
        case, screen, kw = _cahbn_case(rng, 3, G, nd, 10, L, 2), cahbn_ensemble_screen, {}
    _nan_in_one_trajectory(case["Ohat"], case["q0"], draw, ell=1)
    s_b, e_b = screen(**_torch_args(case), nd=nd, substeps=2, **kw)
    assert not bool(s_b[1, draw]) and not bool(torch.isfinite(e_b[1, 0]))
    assert bool(s_b[[0, 2], draw].all()) and bool(torch.isfinite(e_b[[0, 2], 0]).all())
    others = {n: v[[0, 2]] if n in PER_PROBLEM else v for n, v in case.items()}
    s_o, e_o = screen(**_torch_args(others), nd=nd, substeps=2, **kw)
    assert torch.equal(s_b[[0, 2]], s_o)
    torch.testing.assert_close(e_b[[0, 2]], e_o, rtol=0.0, atol=0.0)


def test_mismatched_leading_axis_raises(rng):
    case = _quadratic_case(rng, 2, 2, 3, 8, 3)
    args = _torch_args(case)
    with pytest.raises(ValueError, match="leading axis of 3"):
        quadratic_ensemble_screen(**{**args, "shift": args["shift"][:2]}, nd=3)
    with pytest.raises(ValueError, match="leading axis of 3"):
        quadratic_ensemble_screen_torch(**{**args, "snapshots": args["snapshots"][0]}, nd=3)
    with pytest.raises(ValueError, match=r"\(r,\) or \(L, r\)"):
        quadratic_ensemble_screen(**{**args, "q0": args["q0"][None]}, nd=3)
    case = _cahbn_case(rng, 3, 2, 3, 6, 2, 2)
    args = _torch_args(case)
    with pytest.raises(ValueError, match="leading axis of 2"):
        cahbn_ensemble_screen(**{**args, "u_stages": args["u_stages"][0]}, nd=3, substeps=2)
    with pytest.raises(ValueError, match="leading axis of 2"):
        cahbn_ensemble_screen_torch(**{**args, "limits": args["limits"][:1]}, nd=3,
                                    substeps=2)


def _looped_objective(lstsq, rom, q0, t_pred, t_est, snaps, ndraws, input_funcs):
    """The objective as the search computed it before the screens took
    all trajectories at once: two single-problem screen calls per
    trajectory, combined in trajectory order."""
    L, r = snaps.shape[0], rom.state_dimension
    shifts = torch.mean(snaps, dim=2)
    limits = 5.0 * torch.amax(torch.abs(snaps - shifts[:, :, None]), dim=2)
    norms = torch.sqrt(torch.sum(snaps**2, dim=(1, 2))).to(torch.float32)
    grids = {"pred": t_pred, "est": t_est}

    def screen(ohats, ell, which, s=None, **kw):
        if input_funcs is None:
            return quadratic_ensemble_screen(ohats, q0[ell], grids[which], shifts[ell],
                                             limits[ell], s, nd=ndraws,
                                             substeps=rom.substeps, **kw)
        u = input_funcs[ell](input_stage_times(grids[which], rom.substeps)).T
        return cahbn_ensemble_screen(ohats, q0[ell], grids[which], shifts[ell], limits[ell],
                                     u, s, nd=ndraws, substeps=rom.substeps, **kw)

    def objective(lams, xi):
        C = lams.shape[0]
        stable = lstsq.posterior_spd(lams)
        ohats = lstsq.sample(lams, xi=xi).reshape(C * ndraws, r, -1)
        err = torch.zeros(C, dtype=torch.float32)
        for ell in range(L):
            st_p, _ = screen(ohats, ell, "pred", track_error=False)
            st_e, err_sq = screen(ohats, ell, "est", snaps[ell])
            stable = stable & torch.all((st_p & st_e).reshape(C, ndraws), dim=1)
            err = err + torch.sqrt(err_sq) / norms[ell]
        err = err / L
        ok = stable & torch.isfinite(err)
        return torch.where(ok, err.to(torch.float64), MAXOPTVAL).numpy()

    return objective


@pytest.mark.parametrize("structure", ["cAH", "cAHBN"])
def test_objective_equals_per_trajectory_loop(rng, structure):
    """The search's objective at L = 3, one screen call per time grid,
    against the per-trajectory loop: the same values, bit for bit."""
    r, L, ndraws, m = 3, 3, 4, 30
    nu = NU if structure == "cAHBN" else 0
    rom = (GalerkinROM("cAH", r, substeps=2) if nu == 0
           else GalerkinROM("cAHBN", r, nu, ivp_method="dirk2", substeps=2))
    d = rom.operator_dimension
    O_true = 0.1 * rng.standard_normal((r, d))
    O_true[:, 1 : 1 + r] -= np.eye(r)
    D = rng.standard_normal((1, m, d))
    rhs = np.einsum("md,rd->rm", D[0], O_true)[:, None] + 0.01 * rng.standard_normal((r, 1, m))
    lstsq = weighted_lstsq_fit(torch.as_tensor(D), torch.eye(m, dtype=torch.float64)
                               .expand(r, 1, m, m), torch.as_tensor(rhs))
    q0 = torch.as_tensor(0.5 * rng.standard_normal((L, r)))
    t_pred, t_est = torch.linspace(0, 2.0, 15, dtype=torch.float64), torch.linspace(0, 1.0, 9,
                                                                                    dtype=torch.float64)
    snaps = torch.as_tensor(rng.standard_normal((L, r, 9)))
    input_funcs = None
    if nu:
        amps = rng.uniform(-2, 2, (L, nu))
        input_funcs = [
            (lambda t, a=a: torch.stack([a[0] * torch.sin(2 * np.pi * t),
                                         a[1] * torch.sin(4 * np.pi * t)]))
            for a in amps
        ]
    lams = torch.as_tensor(np.logspace(-6, 2, 5))
    xi = torch.as_tensor(rng.standard_normal((5, ndraws, r, d)))
    got = _kernel_objective(lstsq, rom, q0, t_pred, t_est, snaps, ndraws, input_funcs)(lams, xi)
    want = _looped_objective(lstsq, rom, q0, t_pred, t_est, snaps, ndraws, input_funcs)(lams, xi)
    assert (got < MAXOPTVAL).any()
    np.testing.assert_array_equal(got, want)
