"""The wide CUDA kernels' order of arithmetic, emulated in NumPy float32 on
the CPU and held against the plain PyTorch versions (and those against
the JAX package's XLA twins where the twin compiles quickly).

The wide kernels (family ``"wide"``: ``csrc/quadratic_screen.cu::
quadratic_screen_wide_kernel``, ``csrc/cahbn_screen.cu::
cahbn_screen_wide_kernel``) take kernel A above r = 32 and kernel B above
r = 16 or nu = 4. They sum in another order than the plain versions:

* every operator row is one dot product with the feature vector, split
  over the 32 lanes of a warp by columns (lane j: columns j + 32 t, t
  ascending, by multiply-adds) and added by a butterfly of xor shuffles;
* B's Newton matrix is formed column by column (A[i, j], then the
  quadratic terms in ascending b with 2 x_j at b = j, then the input
  terms), eliminated in ``solve_small``'s operations and back-substituted
  by columns (dk[i] = F[i] / M[i][i], then F[k] -= M[k][i] dk[i] for k <
  i), so the subtractions of a row come in descending column order;
* err_sq is ``mean_error_kernel``'s: draws summed in order, times dealt
  to lanes, a shuffle tree of ``__shfl_down_sync``.

The emulation follows that order, with nvcc's multiply-add contraction
as a fused multiply-add (rounded once, through float64). It is held
against the plain versions as the card holds the kernels: identical
flags, err_sq within rtol 1e-4 on the candidates whose draws are all
stable (float32 sums in other orders differ by a few ulps).
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
from gp_bayesopinf_torch.ops import cahbn_screen as cs
from gp_bayesopinf_torch.ops import ensemble_screen as es

F32, F64 = np.float32, np.float64
CAP = F32(1e6)
LANES = np.arange(32)
GAMMA = F32(1.0 - 0.5 * 1.4142135623730951)
ONE_MINUS_GAMMA = F32(0.5 * 1.4142135623730951)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fma(a, b, c):
    """a b + c rounded once to float32 (the product is exact in float64)."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def warp_sum(v):
    """``screen_common.cuh::warp_sum`` over the last axis (32 lanes): lane
    j adds lane j ^ off's value for off = 16, 8, 4, 2, 1."""
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., LANES ^ off]).astype(F32)
    return v


def mean_error(part, snaps, nd):
    """``mean_error_kernel``: part (N, k, r) of one problem, snaps (r, k)."""
    N, k, r = part.shape
    G = N // nd
    e = np.zeros((G, 32), F32)
    for s in range(k):
        total = np.zeros((G, r), F32)
        for w in range(nd):
            total = (total + part[np.arange(G) * nd + w, s]).astype(F32)
        diff = (total / F32(nd) - snaps[:, s]).astype(F32)
        es_ = np.zeros(G, F32)
        for i in range(r):
            es_ = fma(diff[:, i], diff[:, i], es_)
        e[:, s % 32] = (e[:, s % 32] + es_).astype(F32)
    for off in (16, 8, 4, 2, 1):
        src = LANES + off
        e = np.where(src < 32, e + e[:, np.minimum(src, 31)], e).astype(F32)
    return e[:, 0]


def features(x, u=None):
    """[1, x, x_a x_b (b <= a), u, u_e x_a] of (N, r) states, padded with
    zeros to whole chunks of 32: (N, Q, 32)."""
    N, r = x.shape
    a_idx, b_idx = np.tril_indices(r)
    parts = [np.ones((N, 1), F32), x, (x[:, a_idx] * x[:, b_idx]).astype(F32)]
    if u is not None:
        nu = u.shape[0]
        parts += [np.broadcast_to(u, (N, nu)), (u[None, :, None] * x[:, None, :]).reshape(N, -1)]
    f = np.concatenate(parts, axis=1).astype(F32)
    Q = -(-f.shape[1] // 32)
    return np.pad(f, ((0, 0), (0, 32 * Q - f.shape[1]))).reshape(N, Q, 32)


def split_rhs(Opad, f):
    """Every row's dot product with the features, split by lanes over
    chunks in ascending order, then warp_sum: (N, r)."""
    N, r = Opad.shape[:2]
    acc = np.zeros((N, r, 32), F32)
    for t in range(f.shape[1]):
        acc = fma(Opad[:, :, t], f[:, None, t], acc)
    return warp_sum(acc)[..., 0]


def pad_operator(O):
    N, r, d = O.shape
    Q = -(-d // 32)
    return np.pad(O, ((0, 0), (0, 0), (0, 32 * Q - d))).reshape(N, r, Q, 32)


def step_sizes(t, substeps):
    t = t.astype(F32)
    return [((t[s] - t[s - 1]) / F32(substeps)).astype(F32) for s in range(1, len(t))]


def emulate_quadratic_wide(O, q0, t, shift, limits, snaps, nd, substeps):
    """The wide kernel A on one problem: (stable (N,), err_sq (G,))."""
    O = O.astype(F32)
    Opad = pad_operator(O)
    N, r = O.shape[:2]
    q = np.broadcast_to(q0.astype(F32), (N, r)).copy()
    shift, limits = shift.astype(F32), limits.astype(F32)
    maxdev = np.abs(q - shift)
    part = [q.copy()]
    with np.errstate(invalid="ignore", over="ignore"):
        for h in step_sizes(t, substeps):
            hh, h6 = F32(0.5) * h, (h / F32(6.0)).astype(F32)
            for _ in range(substeps):
                kk = split_rhs(Opad, features(q))
                acc = kk
                x = np.clip(fma(hh, kk, q), -CAP, CAP)
                kk = split_rhs(Opad, features(x))
                acc = fma(2.0, kk, acc)
                x = np.clip(fma(hh, kk, q), -CAP, CAP)
                kk = split_rhs(Opad, features(x))
                acc = fma(2.0, kk, acc)
                x = np.clip(fma(h, kk, q), -CAP, CAP)
                kk = split_rhs(Opad, features(x))
                q = np.clip(fma(h6, (acc + kk).astype(F32), q), -CAP, CAP)
            maxdev = np.maximum(maxdev, np.abs(q - shift))
            part.append(q.copy())
        stable = ((maxdev <= limits) & np.isfinite(maxdev)).all(axis=1)
        return stable, mean_error(np.stack(part, axis=1), snaps.astype(F32), nd)


def newton_matrix(O, x, u, hg):
    """M = I - hg J, column j in the wide kernel's order: (N, r, r)."""
    N, r, d = O.shape
    nu = u.shape[0]
    kH, kN = 1 + r, 1 + r + r * (r + 1) // 2 + nu
    j = np.arange(r)
    col = O[:, :, 1 + j]
    for b in range(r):
        c = np.where(b <= j, kH + j * (j + 1) // 2 + b, kH + b * (b + 1) // 2 + j)
        xb = np.where(j == b, F32(2) * x[:, b:b + 1], x[:, b:b + 1]).astype(F32)  # (N, r_j)
        col = fma(O[:, :, c], xb[:, None, :], col)
    for e in range(nu):
        col = fma(O[:, :, kN + e * r + j], u[e], col)
    return fma(-hg, col, np.eye(r, dtype=F32))


def wide_solve(M, F):
    """Elimination without pivoting in solve_small's operations, then the
    back substitution by columns; (N, r, r), (N, r) -> dk (N, r)."""
    M, F = M.copy(), F.copy()
    r = F.shape[1]
    for p in range(r):
        inv = (F32(1) / M[:, p, p]).astype(F32)
        f = (M[:, p + 1:, p] * inv[:, None]).astype(F32)
        M[:, p + 1:, p + 1:] = fma(-f[:, :, None], M[:, None, p, p + 1:], M[:, p + 1:, p + 1:])
        F[:, p + 1:] = fma(-f, F[:, p:p + 1], F[:, p + 1:])
    dk = np.zeros_like(F)
    for i in range(r - 1, -1, -1):
        dk[:, i] = (F[:, i] / M[:, i, i]).astype(F32)
        F[:, :i] = fma(-M[:, :i, i], dk[:, i:i + 1], F[:, :i])
    return dk


def emulate_cahbn_wide(O, q0, t, shift, limits, u_stages, snaps, nd, substeps, newton_iters):
    """The wide kernel B on one problem: (stable (N,), err_sq (G,))."""
    O = O.astype(F32)
    Opad = pad_operator(O)
    N, r = O.shape[:2]
    u_tab = u_stages.astype(F32)
    q = np.broadcast_to(q0.astype(F32), (N, r)).copy()
    shift, limits = shift.astype(F32), limits.astype(F32)
    maxdev = np.abs(q - shift)
    part = [q.copy()]

    def newton(bv, kv, u, hg):
        for _ in range(newton_iters):
            x = fma(hg, kv, bv)
            F = (kv - split_rhs(Opad, features(x, u))).astype(F32)
            kv = (kv - wide_solve(newton_matrix(O, x, u, hg), F)).astype(F32)
        return kv

    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for s, h in enumerate(step_sizes(t, substeps)):
            hg, h1 = (h * GAMMA).astype(F32), (h * ONE_MINUS_GAMMA).astype(F32)
            for sub in range(substeps):
                row = 3 * (s * substeps + sub)
                k1 = split_rhs(Opad, features(q, u_tab[row]))
                k1 = newton(q, k1, u_tab[row + 1], hg)
                k2 = newton(fma(h1, k1, q), k1, u_tab[row + 2], hg)
                inner = fma(ONE_MINUS_GAMMA, k1, (GAMMA * k2).astype(F32))
                q = np.clip(fma(h, inner, q), -CAP, CAP)
            maxdev = np.maximum(maxdev, np.abs(q - shift))
            part.append(q.copy())
        stable = ((maxdev <= limits) & np.isfinite(maxdev)).all(axis=1)
        return stable, mean_error(np.stack(part, axis=1), snaps.astype(F32), nd)


def _operators(rng, G, nd, d, r, nan_draw=3):
    """Stable operator draws, the last candidate sabotaged to diverge and
    one draw NaN."""
    Ohat = 0.2 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 1.5 * np.eye(r)
    Ohat[:, :, 1 + r :] *= 0.2
    Ohat[-nd:, :, 1 : 1 + r] += 12.0 * np.eye(r)
    Ohat[nan_draw, 0, 0] = np.nan
    return Ohat


def _hold(s_e, e_e, s_p, e_p, G, nd, rtol=1e-4):
    s_p, e_p = np.asarray(s_p), np.asarray(e_p)
    np.testing.assert_array_equal(s_e, s_p)
    ok = s_p.reshape(G, nd).all(axis=1)
    assert ok.sum() >= G - 2 and not s_p[-nd:].any() and not s_p[3]
    np.testing.assert_allclose(e_e[ok], e_p[ok], rtol=rtol)


def _a_args(rng, r, G, nd, k):
    d = 1 + r + r * (r + 1) // 2
    return dict(Ohat=_operators(rng, G, nd, d, r), q0=0.4 * rng.standard_normal(r),
                t_eval=np.linspace(0.0, 1.0, k), shift=np.zeros(r), limits=np.full(r, 10.0),
                snapshots=0.3 * rng.standard_normal((r, k)))


def _b_args(rng, r, nu, G, nd, k, substeps):
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    t = np.linspace(0.0, 1.0, k)
    ts = np.asarray(cs.input_stage_times(torch.as_tensor(t), substeps))
    u = np.stack([np.sin(2 * np.pi * (e + 1) * ts) for e in range(nu)], axis=-1)
    return dict(Ohat=_operators(rng, G, nd, d, r), q0=0.3 * rng.standard_normal(r), t_eval=t,
                shift=np.zeros(r), limits=np.full(r, 8.0), u_stages=u,
                snapshots=0.3 * rng.standard_normal((r, k)))


def _t(x):
    return torch.as_tensor(np.array(x))


def test_warp_sum_gives_every_lane_the_same_bits(rng):
    """The butterfly adds the same two values in either order at every
    level, so all 32 lanes end with one float32 value: the row's sum."""
    v = (rng.standard_normal((50, 32)) * 10.0 ** rng.integers(-6, 6, (50, 32))).astype(F32)
    out = warp_sum(v)
    assert (out == out[:, :1]).all()
    np.testing.assert_allclose(out[:, 0], v.astype(F64).sum(axis=1), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("r", [33, 40])
def test_quadratic_wide_order_matches_plain(rng, r):
    """Kernel A's wide layout at r = 33 (d 595: 19 chunks a row) and 40 (d
    861: 27): the emulated lane partition and shuffle tree against the
    plain version."""
    assert es.screen_family(r) == "wide"
    G, nd, k, substeps = 3, 4, 6, 2
    args = _a_args(rng, r, G, nd, k)
    s_e, e_e = emulate_quadratic_wide(*args.values(), nd, substeps)
    s_p, e_p = es.quadratic_ensemble_screen(*(_t(v) for v in args.values()), nd=nd,
                                            substeps=substeps)
    _hold(s_e, e_e, s_p.numpy(), e_p.numpy(), G, nd)


@pytest.mark.parametrize("r,nu", [(17, 1), (6, 5)])
def test_cahbn_wide_order_matches_plain(rng, r, nu):
    """Kernel B's wide layout at (17, 1) and (6, 5): the emulated split
    right-hand side, Newton matrix by columns, elimination and back
    substitution by columns against the plain version (two Newton steps a
    stage, one substep)."""
    assert cs.screen_family(r, nu) == "wide"
    G, nd, k, substeps, newton_iters = 3, 4, 6, 1, 2
    args = _b_args(rng, r, nu, G, nd, k, substeps)
    s_e, e_e = emulate_cahbn_wide(*args.values(), nd, substeps, newton_iters)
    s_p, e_p = cs.cahbn_ensemble_screen(*(_t(v) for v in args.values()), nd=nd,
                                        substeps=substeps, newton_iters=newton_iters)
    _hold(s_e, e_e, s_p.numpy(), e_p.numpy(), G, nd)


def test_wide_solve_matches_solve_small(rng):
    """The back substitution by columns solves the system solve_small
    solves, at r = 40 (rows past 32, which warp 0 keeps in shared memory)."""
    from gp_bayesopinf_torch.solve.ivp import solve_small

    r = 40
    M = (np.eye(r) + 0.05 * rng.standard_normal((6, r, r))).astype(F32)
    F = rng.standard_normal((6, r)).astype(F32)
    dk = wide_solve(M, F)
    ref = solve_small(torch.as_tensor(M, dtype=torch.float64),
                      torch.as_tensor(F, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(dk, ref, rtol=1e-4, atol=1e-5)


def test_plain_quadratic_screen_matches_xla_twin_at_r33(rng):
    """The plain version the wide kernel A is held to, against the XLA twin
    at r = 33."""
    r, G, nd, k = 33, 3, 4, 8
    args = _a_args(rng, r, G, nd, k)
    s_x, e_x = quadratic_ensemble_screen_xla(*(jnp.asarray(v) for v in args.values()), nd=nd,
                                             substeps=2)
    s_t, e_t = es.quadratic_ensemble_screen(*(_t(v) for v in args.values()), nd=nd, substeps=2)
    _hold(s_t.numpy(), e_t.numpy(), s_x, e_x, G, nd)


def test_plain_cahbn_screen_matches_xla_twin_at_r6_nu5(rng):
    """The plain version the wide kernel B is held to, against the XLA twin
    at (6, 5): one substep a step, two Newton steps a stage."""
    r, nu, G, nd, k, substeps, newton_iters = 6, 5, 3, 4, 8, 1, 2
    args = _b_args(rng, r, nu, G, nd, k, substeps)
    ts = np.asarray(_input_stage_times(jnp.asarray(args["t_eval"]), substeps))
    np.testing.assert_allclose(
        np.asarray(cs.input_stage_times(torch.as_tensor(args["t_eval"]), substeps)), ts)
    kw = dict(nd=nd, substeps=substeps, newton_iters=newton_iters)
    s_x, e_x = cahbn_ensemble_screen_xla(*(jnp.asarray(v) for v in args.values()), **kw)
    s_t, e_t = cs.cahbn_ensemble_screen(*(_t(v) for v in args.values()), **kw)
    _hold(s_t.numpy(), e_t.numpy(), s_x, e_x, G, nd)
