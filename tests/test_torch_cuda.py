"""The CUDA ensemble-screen kernels (A: RK4 "cAH", B: SDIRK2 "cAHBN")
against their plain PyTorch versions, and the low-rank weight root against
the dense one at m' = 2048, on the card. Every test here needs a CUDA
device and skips without one.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.ops import cahbn_screen as cs
from gp_bayesopinf_torch.ops import ensemble_screen as es


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(r, G, nd, k, device):
    rng = np.random.default_rng(11)
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.25 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 0.9 * np.eye(r)
    Ohat[-nd:, :, 1 : 1 + r] += 3.0 * np.eye(r)  # the last candidate diverges
    Ohat[1, 0, 0] = np.nan
    arrays = (Ohat, 0.4 * rng.standard_normal(r), np.linspace(0, 2.0, k),
              np.zeros(r), np.full(r, 10.0), rng.standard_normal((r, k)))
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("r,G,nd", [(6, 4, 20), (3, 5, 7), (12, 2, 32), (13, 3, 20), (16, 2, 7)])
def test_kernel_matches_plain(cuda, r, G, nd):
    """Templated instances (r <= 12) and the runtime-r kernel (r = 13, 16)."""
    args = _case(r, G, nd, 40, cuda)
    before = es.launches
    s_k, e_k = es.quadratic_ensemble_screen(*args, nd=nd, substeps=4)
    torch.cuda.synchronize()
    assert es.launches == before + 1
    s_p, e_p = es.quadratic_ensemble_screen_torch(*args, nd=nd, substeps=4)
    assert torch.equal(s_k, s_p)
    assert not bool(s_k[1]) and not bool(s_k[-nd:].any())
    ok = s_p.reshape(G, nd).all(dim=1)
    # nvcc contracts multiply-adds, so err_sq differs in the last bits.
    torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,t_max,track", [(360, 90.0, True), (500, 200.0, False)])
def test_kernel_matches_plain_on_seird_operators(cuda, k, t_max, track):
    """Kernel A at r = 5, d = 21 on operators that ``SEIRD2.cah_operators``
    makes of perturbed parameter draws (the SEIRD search's shapes: 16
    candidates of 20 draws, 8 substeps), the last candidate diverging."""
    from gp_bayesopinf_torch.models import SEIRD2

    rng = np.random.default_rng(13)
    G, nd = 16, 20
    model = SEIRD2((0.25, 0.1, 0.095, 0.0025), substeps=8)
    draws = np.asarray(model.parameters) * (1.0 + 0.02 * rng.standard_normal((G * nd, 1, 4)))
    draws[-nd:, 0, 1] = -1.0  # the exposed grow like e^t: to the clip
    Ohat = model.cah_operators(torch.as_tensor(draws, device=cuda))
    assert Ohat.shape == (G * nd, 5, 21)
    q0 = torch.tensor([0.994, 0.005, 0.001, 0.0, 0.0], dtype=torch.float64, device=cuda)
    t = torch.linspace(0.0, t_max, k, dtype=torch.float64, device=cuda)
    truth = model.solve(q0, t)
    shift = truth.mean(dim=1)
    limits = 5.0 * (truth - shift[:, None]).abs().amax(dim=1)
    before = es.launches
    s_k, e_k = es.quadratic_ensemble_screen(Ohat, q0, t, shift, limits, truth, nd=nd,
                                            substeps=8, track_error=track)
    torch.cuda.synchronize()
    assert es.launches == before + 1
    s_p, e_p = es.quadratic_ensemble_screen_torch(Ohat, q0, t, shift, limits, truth, nd=nd,
                                                  substeps=8, track_error=track)
    assert torch.equal(s_k, s_p)
    assert bool(s_k[:-nd].all()) and not bool(s_k[-nd:].any())
    if track:
        torch.testing.assert_close(e_k[:-1], e_p[:-1], rtol=1e-3, atol=0.0)
    else:
        assert bool((e_k == 0).all())


@pytest.mark.gpu
def test_kernel_matches_plain_at_k_3200(cuda):
    """Kernel A on the Euler ex1c estimation grid: k = 3200 output times
    with the error term (eight times the terms of k = 400 in every
    per-warp sum), 16 candidates of 20 draws, r = 6, 8 substeps."""
    rng = np.random.default_rng(17)
    r, G, nd, k = 6, 16, 20, 3200
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.3 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 20.0 * np.eye(r)
    Ohat[:, :, 1 + r :] *= 0.1
    Ohat[-nd:, :, 1 : 1 + r] += 420.0 * np.eye(r)  # the last candidate hits the clip
    arrays = (Ohat, 0.5 * rng.standard_normal(r), np.linspace(0, 0.06, k), np.zeros(r),
              np.full(r, 10.0), 0.2 * rng.standard_normal((r, k)))
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    before = es.launches
    s_k, e_k = es.quadratic_ensemble_screen(*args, nd=nd, substeps=8)
    torch.cuda.synchronize()
    assert es.launches == before + 1
    s_p, e_p = es.quadratic_ensemble_screen_torch(*args, nd=nd, substeps=8)
    assert torch.equal(s_k, s_p)
    assert bool(s_k[:-nd].all()) and not bool(s_k[-nd:].any())
    torch.testing.assert_close(e_k[:-1], e_p[:-1], rtol=1e-3, atol=0.0)


@pytest.mark.gpu
def test_lowrank_root_matches_dense_at_2048_points(cuda):
    """The factored root against the dense eigh root on the card at m' =
    2048 (three modes, 128 samples): W (C + eta I) W = I and the weighted
    Gram matrix, both to 5e-3 (the float64 conditioning floor at eta =
    1e-8 is ~1e-3); the estimates to 1e-8 of their scale; ranks far below
    m'; the three-mode batch equal to each mode alone (same rank)."""
    from gp_bayesopinf_torch.gp.estimates import batched_gp_estimates
    from gp_bayesopinf_torch.gp.lowrank import (
        batched_lowrank_gp_estimates, lowrank_gp_estimates,
    )

    rng = np.random.default_rng(19)
    f64, m, mp = torch.float64, 128, 2048
    t = np.sort(rng.uniform(0, 1, m))
    Y = np.stack([np.sin(9 * t), np.cos(21 * t), np.sin(40 * t) * np.exp(-t)])
    Y = Y + 1e-3 * rng.standard_normal(Y.shape)
    T = torch.as_tensor(t, device=cuda).expand(3, m)
    Yt = torch.as_tensor(Y, device=cuda)
    t_est = torch.linspace(0, 1, mp, dtype=f64, device=cuda)
    hyper = [torch.tensor(v, dtype=f64, device=cuda)
             for v in ([1.0, 1.5, 0.8], [0.15, 0.06, 0.03], [1e-6, 1e-6, 1e-6])]
    low = batched_lowrank_gp_estimates(T, Yt, t_est, *hyper, eta=1e-8)
    dense = batched_gp_estimates(T, Yt, t_est, *hyper, 1e-8, method="eigh")
    eye = torch.eye(mp, dtype=f64, device=cuda)
    for i, est in enumerate(low):
        assert 0 < est.root.rank < mp // 4
        W = est.root.dense()
        assert float((W @ (dense.ddt_covariance[i] + 1e-8 * eye) @ W - eye).abs().max()) < 5e-3
        D = torch.stack([torch.ones_like(t_est), dense.state_estimate[i]], dim=1)
        G_low = est.root.apply(D).T @ est.root.apply(D)
        G_dense = (dense.weight_root[i] @ D).T @ (dense.weight_root[i] @ D)
        assert float(torch.linalg.norm(G_low - G_dense) / torch.linalg.norm(G_dense)) < 5e-3
        scale = float(dense.ddt_estimate[i].abs().max())
        torch.testing.assert_close(est.ddt_estimate, dense.ddt_estimate[i], rtol=0,
                                   atol=1e-8 * scale)
        alone = lowrank_gp_estimates(T[i], Yt[i], t_est, *(h[i] for h in hyper), eta=1e-8,
                                     refine=False, tol_factor=1e-2)
        batch = batched_lowrank_gp_estimates(T, Yt, t_est, *hyper, eta=1e-8, refine=False,
                                             tol_factor=1e-2)[i]
        assert alone.root.rank == batch.root.rank


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = [a.float() for a in _case(3, 2, 4, 10, cuda)]
    with pytest.raises(ValueError, match="nd"):
        es.quadratic_ensemble_screen_cuda(*args, nd=3)
    with pytest.raises(ValueError, match="float32"):
        es.quadratic_ensemble_screen_cuda(args[0].double(), *args[1:], nd=4)
    empty = torch.zeros((44, 0, 1), device=cuda)  # r = 0
    zeros = torch.zeros(0, device=cuda)
    with pytest.raises(ValueError, match="r >= 1"):
        es.quadratic_ensemble_screen_cuda(empty, zeros, args[2], zeros, zeros + 1, nd=22)


@pytest.mark.gpu
def test_runtime_r_kernel_matches_templated(cuda):
    """The runtime-r kernel forced at r = 6: the templated instance's flags."""
    args = [a.float().contiguous() for a in _case(6, 4, 20, 40, cuda)]
    s_t, e_t = es.quadratic_ensemble_screen_cuda(*args, nd=20)
    s_a, e_a = es.quadratic_ensemble_screen_cuda(*args, nd=20, any_r=True)
    assert torch.equal(s_a, s_t)
    ok = s_t.reshape(4, 20).all(dim=1)
    torch.testing.assert_close(e_a[ok], e_t[ok], rtol=1e-3, atol=0.0)


def _cahbn_case(r, nu, G, nd, k, substeps, device):
    rng = np.random.default_rng(12)
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    Ohat = 0.2 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 1.2 * np.eye(r)
    Ohat[-nd:, :, 1 : 1 + r] += 4.0 * np.eye(r)  # the last candidate diverges
    Ohat[1, 0, 0] = np.nan
    t = torch.linspace(0, 1.5, k, dtype=torch.float64)
    ts = cs.input_stage_times(t, substeps)
    u = torch.stack([torch.sin(2 * np.pi * ts), torch.cos(4 * np.pi * ts),
                     torch.sin(6 * np.pi * ts)][:nu], dim=-1)
    arrays = (Ohat, 0.3 * rng.standard_normal(r), t, np.zeros(r), np.full(r, 8.0), u,
              rng.standard_normal((r, k)))
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("r,nu,G,nd", [(5, 2, 4, 20), (3, 2, 5, 7), (8, 1, 3, 32), (9, 2, 3, 20),
                                       (10, 2, 2, 7), (6, 3, 3, 20)])
def test_cahbn_kernel_matches_plain(cuda, r, nu, G, nd):
    """Templated instances (r <= 8, nu <= 2) and the runtime-(r, nu) kernel."""
    args = _cahbn_case(r, nu, G, nd, 30, 2, cuda)
    before = cs.launches
    s_k, e_k = cs.cahbn_ensemble_screen(*args, nd=nd, substeps=2)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    s_p, e_p = cs.cahbn_ensemble_screen_torch(*args, nd=nd, substeps=2)
    assert torch.equal(s_k, s_p)
    assert not bool(s_k[1]) and not bool(s_k[-nd:].any())
    ok = s_p.reshape(G, nd).all(dim=1)
    assert bool(ok.any())
    # nvcc contracts multiply-adds, so err_sq differs in the last bits.
    torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)


def _batched(args, L, per_problem, seed):
    """``args`` of one problem made into L problems: each per-problem
    argument (by position) gets L variants, the first the original."""
    rng = np.random.default_rng(seed)
    out = list(args)
    for i in per_problem:
        x = args[i]
        scale = 0.0 if i in (3, 4) else 0.3  # shift and limits stay
        out[i] = torch.stack([x] + [x + scale * torch.as_tensor(
            rng.standard_normal(tuple(x.shape)), device=x.device) for _ in range(L - 1)])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("r,G,nd,L", [(6, 4, 20, 2), (3, 5, 7, 3), (12, 2, 32, 2), (16, 2, 7, 2)])
def test_batched_kernel_matches_plain(cuda, r, G, nd, L):
    args = _batched(_case(r, G, nd, 40, cuda), L, (1, 3, 4, 5), r)
    before = es.launches
    s_k, e_k = es.quadratic_ensemble_screen(*args, nd=nd, substeps=4)
    torch.cuda.synchronize()
    assert es.launches == before + 1  # all L problems in one launch
    s_p, e_p = es.quadratic_ensemble_screen_torch(*args, nd=nd, substeps=4)
    assert s_k.shape == (L, G * nd) and e_k.shape == (L, G)
    assert torch.equal(s_k, s_p)
    ok = s_p.reshape(L, G, nd).all(dim=2)
    torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)
    # Problem 0 is the single-problem case, launched alone.
    s_1, e_1 = es.quadratic_ensemble_screen(*[a[0] if i in (1, 3, 4, 5) else a
                                              for i, a in enumerate(args)], nd=nd, substeps=4)
    assert torch.equal(s_1, s_k[0])
    torch.testing.assert_close(e_1, e_k[0], rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("r,nu,G,nd,L", [(5, 2, 4, 20, 5), (3, 2, 5, 7, 2), (8, 1, 3, 32, 2),
                                         (9, 2, 2, 7, 3)])
def test_batched_cahbn_kernel_matches_plain(cuda, r, nu, G, nd, L):
    args = _batched(_cahbn_case(r, nu, G, nd, 30, 2, cuda), L, (1, 3, 4, 5, 6), r)
    before = cs.launches
    s_k, e_k = cs.cahbn_ensemble_screen(*args, nd=nd, substeps=2)
    torch.cuda.synchronize()
    assert cs.launches == before + 1  # all L problems in one launch
    s_p, e_p = cs.cahbn_ensemble_screen_torch(*args, nd=nd, substeps=2)
    assert s_k.shape == (L, G * nd) and e_k.shape == (L, G)
    assert torch.equal(s_k, s_p)
    ok = s_p.reshape(L, G, nd).all(dim=2)
    assert bool(ok.any())
    torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)
    s_1, e_1 = cs.cahbn_ensemble_screen(*[a[0] if i in (1, 3, 4, 5, 6) else a
                                          for i, a in enumerate(args)], nd=nd, substeps=2)
    assert torch.equal(s_1, s_k[0])
    torch.testing.assert_close(e_1, e_k[0], rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.gpu
def test_cahbn_kernel_rejects_what_it_does_not_take(cuda):
    args = [a.float() for a in _cahbn_case(3, 2, 2, 4, 10, 2, cuda)]
    with pytest.raises(ValueError, match="nd"):
        cs.cahbn_ensemble_screen_cuda(*args, nd=3, substeps=2)
    with pytest.raises(ValueError, match="float32"):
        cs.cahbn_ensemble_screen_cuda(args[0].double(), *args[1:], nd=4, substeps=2)
    empty = torch.zeros((4, 0, 3), device=cuda)  # r = 0
    zeros = torch.zeros(0, device=cuda)
    with pytest.raises(ValueError, match="r and nu >= 1"):
        cs.cahbn_ensemble_screen_cuda(empty, zeros, args[2], zeros, zeros + 1, args[5],
                                      nd=4, substeps=2)
