"""The port's ensemble screen against the JAX package's: the plain
PyTorch version against the XLA twin and against the Pallas kernel in
interpret mode, as ``tests/test_ensemble_pallas.py`` runs them on the CPU.

Stability flags must be identical. err_sq is held at rtol 2e-4, atol
1e-4: all three sum in float32 in different orders (the same tolerance
the JAX package holds between its own two versions).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gp_bayesopinf_tpu.ops.ensemble_pallas import (
    quadratic_ensemble_screen as pallas_screen,
    quadratic_ensemble_screen_xla as xla_screen,
)
from gp_bayesopinf_torch.ops import ensemble_screen
from gp_bayesopinf_torch.ops.ensemble_screen import (
    quadratic_ensemble_screen,
    quadratic_ensemble_screen_torch,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(rng, r, G, nd, k, diverge=True, nan_draw=None):
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.25 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 0.9 * np.eye(r)[None]
    if diverge:  # every draw of the last candidate blows up
        Ohat[-nd:, :, 1 : 1 + r] += 3.0 * np.eye(r)[None]
    if nan_draw is not None:
        Ohat[nan_draw, 0, 0] = np.nan
    return dict(
        Ohat=Ohat,
        q0=0.4 * rng.standard_normal(r),
        t_eval=np.linspace(0, 2.0, k),
        shift=np.zeros(r),
        limits=np.full(r, 10.0),
        snapshots=rng.standard_normal((r, k)),
    )


def _run_all(case, nd, substeps, track_error=True):
    snaps = case["snapshots"] if track_error else None
    jargs = [jnp.asarray(case[n]) for n in ("Ohat", "q0", "t_eval", "shift", "limits")]
    jsnap = None if snaps is None else jnp.asarray(snaps)
    kw = dict(nd=nd, substeps=substeps, track_error=track_error)
    s_x, e_x = xla_screen(*jargs, jsnap, **kw)
    s_p, e_p = pallas_screen(*jargs, jsnap, interpret=True, **kw)
    targs = [torch.as_tensor(case[n]) for n in ("Ohat", "q0", "t_eval", "shift", "limits")]
    tsnap = None if snaps is None else torch.as_tensor(snaps)
    s_t, e_t = quadratic_ensemble_screen(*targs, tsnap, **kw)
    return (np.asarray(s_x), np.asarray(e_x)), (np.asarray(s_p), np.asarray(e_p)), (
        s_t.numpy(), e_t.numpy()
    )


def _check(results, G, nd, expect_unstable=(), pallas_err=True):
    (s_x, e_x), (s_p, e_p), (s_t, e_t) = results
    np.testing.assert_array_equal(s_t, s_x)
    np.testing.assert_array_equal(s_t, s_p)
    ok = s_x.reshape(G, nd).all(axis=1)
    for e_ref in (e_x, e_p) if pallas_err else (e_x,):
        np.testing.assert_allclose(e_t[ok], e_ref[ok], rtol=2e-4, atol=1e-4)
    for n in expect_unstable:
        assert not s_t[n]
    assert s_t.dtype == np.bool_ and e_t.dtype == np.float32
    return ok


def test_plain_matches_xla_and_pallas_with_diverging_candidate(rng):
    G, nd = 4, 5
    case = _case(rng, r=3, G=G, nd=nd, k=30)
    ok = _check(_run_all(case, nd, substeps=4), G, nd,
                expect_unstable=range((G - 1) * nd, G * nd))
    assert ok[:-1].any() and not ok[-1]


def test_draw_count_not_a_multiple_of_32(rng):
    G, nd = 3, 7  # N = 21
    case = _case(rng, r=2, G=G, nd=nd, k=12, diverge=False)
    _check(_run_all(case, nd, substeps=2), G, nd)


def test_track_error_off(rng):
    G, nd = 4, 5
    case = _case(rng, r=3, G=G, nd=nd, k=20)
    results = _run_all(case, nd, substeps=4, track_error=False)
    _check(results, G, nd)
    assert np.all(results[2][1] == 0.0)


def test_nan_operator_draw_is_unstable(rng):
    G, nd = 3, 5
    case = _case(rng, r=3, G=G, nd=nd, k=20, diverge=False, nan_draw=6)
    results = _run_all(case, nd, substeps=4)
    # The Pallas kernel's group-mean matmul turns one NaN draw into NaN
    # errors for every candidate (NaN x 0); the XLA twin and the port keep
    # it inside its own candidate, so err_sq is held to the twin only.
    _check(results, G, nd, expect_unstable=[6], pallas_err=False)
    assert not np.isfinite(results[1][1]).any()
    e_t = results[2][1]
    assert not np.isfinite(e_t[1]) and np.isfinite(e_t[[0, 2]]).all()


def test_cpu_tensors_take_the_plain_version(rng):
    case = _case(rng, r=2, G=2, nd=3, k=8)
    args = [torch.as_tensor(case[n]) for n in ("Ohat", "q0", "t_eval", "shift", "limits")]
    before = ensemble_screen.launches
    s1, e1 = quadratic_ensemble_screen(*args, torch.as_tensor(case["snapshots"]), nd=3)
    s2, e2 = quadratic_ensemble_screen_torch(*args, torch.as_tensor(case["snapshots"]), nd=3)
    assert ensemble_screen.launches == before
    assert torch.equal(s1, s2) and torch.equal(e1, e2)


def test_cuda_wrapper_rejects_cpu_tensors(rng):
    case = _case(rng, r=2, G=2, nd=3, k=8)
    args = [torch.as_tensor(case[n], dtype=torch.float32)
            for n in ("Ohat", "q0", "t_eval", "shift", "limits")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ensemble_screen.quadratic_ensemble_screen_cuda(*args, nd=3)
