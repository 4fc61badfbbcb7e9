"""Both ensemble screens above the state and input dimensions of their
templated CUDA instances (kernel A above r = 12, kernel B above r = 8 or
nu = 2), where the card takes the capacity-templated kernels and, above
r = 32 (A) or r = 16 or nu = 4 (B), the wide kernels: the plain
PyTorch versions, which the CPU runs and the kernels are held to on the
card, against the JAX package's XLA twins on inputs made from a NumPy
seed, and the regularization search of a 13-mode "cAH" ROM through the
kernel objective.

The Pallas kernels accept these dimensions too, but interpret mode
unrolls every feature of every row statically (153 at r = 16), so the
twins stand for them here, as ``tests/test_ensemble_pallas.py`` holds
the Pallas kernels to the twins.

Flags must be identical; err_sq is held at rtol 1e-4 on the candidates
whose draws are all stable (float32 sums in other orders).
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
from gp_bayesopinf_torch.bayes import regsearch
from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen
from gp_bayesopinf_torch.rom import GalerkinROM
from gp_bayesopinf_torch.solve import weighted_lstsq_fit


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _operators(rng, G, nd, d, r, nan_draw=3):
    """Stable operator draws, the last candidate sabotaged to diverge and
    one draw NaN."""
    Ohat = 0.2 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 1.5 * np.eye(r)
    Ohat[:, :, 1 + r :] *= 0.2
    Ohat[-nd:, :, 1 : 1 + r] += 12.0 * np.eye(r)
    Ohat[nan_draw, 0, 0] = np.nan
    return Ohat


def _hold(s_t, e_t, s_x, e_x, G, nd):
    s_x, e_x = np.asarray(s_x), np.asarray(e_x)
    np.testing.assert_array_equal(s_t.numpy(), s_x)
    ok = s_x.reshape(G, nd).all(axis=1)
    assert ok.sum() >= G - 2 and not s_x[-nd:].any() and not s_x[3]
    np.testing.assert_allclose(e_t.numpy()[ok], e_x[ok], rtol=1e-4)


@pytest.mark.parametrize("r", [13, 16])
def test_plain_quadratic_screen_matches_xla_twin(rng, r):
    G, nd, k = 4, 5, 12
    d = 1 + r + r * (r + 1) // 2
    args = dict(Ohat=_operators(rng, G, nd, d, r), q0=0.4 * rng.standard_normal(r),
                t_eval=np.linspace(0.0, 1.0, k), shift=np.zeros(r), limits=np.full(r, 10.0),
                snapshots=0.3 * rng.standard_normal((r, k)))
    s_x, e_x = quadratic_ensemble_screen_xla(*(jnp.asarray(v) for v in args.values()), nd=nd,
                                             substeps=2)
    s_t, e_t = ensemble_screen.quadratic_ensemble_screen(*(_t(v) for v in args.values()),
                                                         nd=nd, substeps=2)
    _hold(s_t, e_t, s_x, e_x, G, nd)


@pytest.mark.parametrize("r,nu", [(10, 2), (6, 3)])
def test_plain_cahbn_screen_matches_xla_twin(rng, r, nu):
    """One substep a step and two Newton steps a stage: the twin traces
    every step of the unrolled elimination, and its compile time grows with
    each (~90 s at r = 10 with the search's 2 x 6)."""
    G, nd, k, substeps, newton_iters = 3, 4, 8, 1, 2
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    t = np.linspace(0.0, 1.0, k)
    ts = np.asarray(_input_stage_times(jnp.asarray(t), substeps))
    u = np.stack([np.sin(2 * np.pi * (e + 1) * ts) for e in range(nu)], axis=-1)
    args = dict(Ohat=_operators(rng, G, nd, d, r), q0=0.3 * rng.standard_normal(r), t_eval=t,
                shift=np.zeros(r), limits=np.full(r, 8.0), u_stages=u,
                snapshots=0.3 * rng.standard_normal((r, k)))
    kw = dict(nd=nd, substeps=substeps, newton_iters=newton_iters)
    s_x, e_x = cahbn_ensemble_screen_xla(*(jnp.asarray(v) for v in args.values()), **kw)
    s_t, e_t = cahbn_screen.cahbn_ensemble_screen(*(_t(v) for v in args.values()), **kw)
    _hold(s_t, e_t, s_x, e_x, G, nd)


def test_auto_regularize_screens_r13_through_the_kernel_objective(rng, monkeypatch):
    """A 13-mode autonomous "cAH" ROM is eligible for kernel A: its search
    goes through the kernel objective, two screen calls (one per time
    grid) per evaluation, each at r = 13, and chooses a regularizer."""
    r, m, ndraws = 13, 120, 4
    rom = GalerkinROM("cAH", r, substeps=2)
    d = rom.operator_dimension
    O_true = np.zeros((r, d))
    O_true[:, 1 : 1 + r] = -np.eye(r)  # q(t) = exp(-t) q0, the snapshots below
    D = rng.standard_normal((1, m, d))
    rhs = np.einsum("md,rd->rm", D[0], O_true)[:, None] + 0.01 * rng.standard_normal((r, 1, m))
    lstsq = weighted_lstsq_fit(_t(D), torch.eye(m, dtype=torch.float64).expand(r, 1, m, m),
                               _t(rhs))
    t_est = torch.linspace(0.0, 1.0, 9, dtype=torch.float64)
    q0 = _t(0.3 * rng.standard_normal(r))
    snaps = torch.exp(-t_est)[None, :] * q0[:, None]

    calls = []
    screen = regsearch.quadratic_ensemble_screen

    def counted(Ohat, *args, **kwargs):
        calls.append(Ohat.shape[1:])
        return screen(Ohat, *args, **kwargs)

    monkeypatch.setattr(regsearch, "quadratic_ensemble_screen", counted)
    objective = regsearch._kernel_objective
    evaluations = []
    monkeypatch.setattr(regsearch, "_kernel_objective", lambda *a, **k: (
        lambda lams, xi: evaluations.append(len(lams)) or objective(*a, **k)(lams, xi)))
    res = regsearch.auto_regularize(
        lstsq, rom, q0, torch.linspace(0.0, 1.5, 13, dtype=torch.float64), t_est, snaps,
        torch.Generator().manual_seed(0), grid=np.logspace(-6, 2, 5), ndraws=ndraws,
        verbose=False,
    )
    assert np.isfinite(res.regularizer) and res.regularizer > 0
    assert evaluations and len(calls) == 2 * len(evaluations)
    assert set(calls) == {(r, d)}
