"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each failing loudly (an uncaught exception exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build both ensemble-screen kernels from ``gp_bayesopinf_torch/csrc``,
   one nvcc each, in parallel, and print ptxas's registers and spills;
3. hold kernel A (RK4 "cAH" screen) against its plain PyTorch version on
   the card at the Euler ex1a screen shapes (G = 16 candidates, nd = 20
   draws, r = 6, d = 28, 8 RK4 substeps; k = 401 without the error term,
   k = 400 with it), with a diverging candidate, an envelope-rejected
   candidate, a NaN draw, a run with nd = 7, and L = 2 problems in one
   launch with a draw that is NaN in one of them only; time the kernel
   and the plain version with CUDA events; then the same kernel at the
   SEIRD screen shapes (r = 5, d = 21, operators made by
   ``SEIRD2.cah_operators`` of perturbed parameter draws; k = 360 over
   [0, 90] with the error term, k = 500 over [0, 200] without);
4. the same for kernel B (SDIRK2 "cAHBN" screen) at the heat ex3 screen
   shapes (G = 16, r = 5, nu = 2, d = 33, 4 substeps, 6 Newton steps,
   the ex3 input family): k = 80 with the error term, k = 120 over [0, 2]
   without it, nd = 7, and ex3's L = 5 trajectories in one launch, each
   with its own q0 and (a, b) inputs; the kernel is also timed at the
   full prediction grid, k = 500, with L = 1 and L = 5;
5. run the full ex1a workload through the port's CLI entry
   (``euler 0.06 200 0.03 400 6 --ndraws 600`` on ``cuda``) and check
   that the grid search went through kernel A, two launches per objective
   evaluation, and that the posterior ensemble is sound;
6. run the full heat ex3 workload (``heat 1.0 20 0.05 80 5 --ndraws
   600``) and check that its search went through kernel B, two launches
   per objective evaluation for all five trajectories, and that every
   trajectory's ensemble is sound;
7. run the full SEIRD ex1a workload (``seird 90 90 0.10 360 --ndraws
   600``) and check that its search went through kernel A at r = 5, two
   launches per objective evaluation, that both ensembles are sound and
   that the posterior mean lies near the true parameters; then hold the
   Cholesky weight root against the eigh root on that run's GP problem
   (the same posterior means, rtol 1e-6);
8. hold kernel A against its plain version at the Euler ex1c screen
   shape (k = 3200 output times with the error term, phase 3's last case),
   then run the full ex1c workload (``euler 0.06 200 0.03 3200 6 --ndraws
   600``: m' = 3200, so the GP weights are the factored low-rank roots)
   and check that its search went through kernel A, two launches per
   objective evaluation, and that the ensemble is sound;
9. run the production-scale pipeline at its defaults (``scaled``: n =
   6000, 10,000 snapshots, 30 modes, m' = 2048, low-rank roots, 256
   draws) and check its regularizer, grid, stable share, training error
   and singular values; no hand-written kernel lies on this path, and the
   launch counts show it; hold the randomized POD against the exact
   spectrum, and the low-rank root against the dense eigh root on a
   handful of the run's modes at m' = 2048;
10. one smaller windowed run (Euler source, 4 windows, "cAH", a scaled
    column-norm Tikhonov matrix) so that path touches the card: finite
    outputs only, no accuracy gate.

The last two lines of standard output are a JSON summary of the kernels
and a JSON status line.
"""

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

EX1A = ["euler", "0.06", "200", "0.03", "400", "6", "--ndraws", "600", "--device", "cuda"]
EX3 = ["heat", "1.0", "20", "0.05", "80", "5", "--ndraws", "600", "--device", "cuda"]
SEIRD_EX1A = ["seird", "90", "90", "0.10", "360", "--ndraws", "600", "--device", "cuda"]
EX1C = ["euler", "0.06", "200", "0.03", "3200", "6", "--ndraws", "600", "--device", "cuda"]
SCALED = ["scaled", "--quiet", "--device", "cuda"]
SCALED_WINDOWED = ["scaled", "--source", "euler", "--n-space", "600", "--k", "2000", "--modes", "8",
                   "--gp-samples", "256", "--mprime", "512", "--windows", "4", "--modelform", "cAH",
                   "--regularization", "gamma", "--quiet", "--device", "cuda"]
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "quadratic_ensemble_screen": ("gp_bayesopinf_torch/csrc/quadratic_screen.cu",
                                  "gp_bayesopinf_tpu/ops/ensemble_pallas.py:177"),
    "cahbn_ensemble_screen": ("gp_bayesopinf_torch/csrc/cahbn_screen.cu",
                              "gp_bayesopinf_tpu/ops/ensemble_pallas.py:529"),
}
# Published peaks of one H100 SXM at 700 W: float32 outside the tensor
# cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def screen_case(G, nd, k, t_max, rng, track_error):
    """Synthetic ex1a-shaped screen inputs with known outcomes: candidate
    G-1 diverges to the clip, candidate G-2 leaves the envelope, draw 3 has
    a NaN operator; every other draw decays well inside the envelope."""
    r = 6
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.3 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] += -20.0 * np.eye(r)
    Ohat[:, :, 1 + r :] *= 0.1
    Ohat[(G - 1) * nd :, :, 1 : 1 + r] += 420.0 * np.eye(r)  # e^60: hits the clip
    Ohat[(G - 2) * nd : (G - 1) * nd, :, 1 : 1 + r] += 100.0 * np.eye(r)  # grows past the envelope
    Ohat[3, 0, 0] = np.nan
    t = np.linspace(0.0, t_max, k)
    args = dict(
        Ohat=Ohat, q0=0.5 * rng.standard_normal(r), t_eval=t, shift=np.zeros(r),
        limits=np.full(r, 10.0),
        snapshots=0.2 * rng.standard_normal((r, k)) if track_error else None,
    )
    return {n: None if v is None else torch.as_tensor(v, device="cuda") for n, v in args.items()}


def seird_screen_case(G, nd, k, t_max, rng, track_error, device="cuda"):
    """SEIRD-shaped screen inputs (r = 5, d = 21) with the outcomes that
    ``hold`` knows: operators by ``SEIRD2.cah_operators`` of ex1a's true
    parameters perturbed by 2%, the envelope and the error target from the
    truth over the training span [0, 90]. Candidate G-1 diverges to the
    clip (p2 = -1: the exposed grow like e^t), candidate G-2 leaves the envelope
    (p4 x 30: the deceased pass five times their amplitude), draw 3 has a
    NaN parameter; every other draw stays inside."""
    from gp_bayesopinf_torch.models import SEIRD2

    model = SEIRD2((0.25, 0.1, 0.095, 0.0025), substeps=8)
    params = np.asarray(model.parameters) * (1.0 + 0.02 * rng.standard_normal((G * nd, 1, 4)))
    params[(G - 1) * nd :, 0, 1] = -1.0
    params[(G - 2) * nd : (G - 1) * nd, 0, 3] *= 30.0
    params[3, 0, 1] = np.nan
    Ohat = model.cah_operators(torch.as_tensor(params, device=device))
    q0 = torch.tensor([0.994, 0.005, 0.001, 0.0, 0.0], dtype=torch.float64, device=device)
    t = torch.linspace(0.0, t_max, k, dtype=torch.float64, device=device)
    span = model.solve(q0, torch.linspace(0.0, 90.0, 360, dtype=torch.float64, device=device))
    shift = span.mean(dim=1)
    return dict(
        Ohat=Ohat, q0=q0, t_eval=t, shift=shift,
        limits=5.0 * (span - shift[:, None]).abs().amax(dim=1),
        snapshots=model.solve(q0, t) if track_error else None,
    )


def batched_case(a, L, rng, per_problem):
    """L problems from one problem's inputs ``a``: trajectory 0 keeps them,
    the others get their own q0 and snapshots (and ``per_problem`` supplies
    any other per-trajectory tensor, as a function of the trajectory). Draw
    3 becomes a draw that is NaN in trajectory 1 only: its row 1 is a pure
    decay, so q_1 stays exactly 0 where it starts at 0 (every trajectory
    but 1), and its row 0 gets +-1e38 on q_1^2 and q_1 q_0, which are 0
    there and overflow to inf - inf in trajectory 1, where q_1 starts at 2."""
    Ohat = a["Ohat"].clone()
    r = Ohat.shape[1]
    Ohat[3] = Ohat[4]
    Ohat[3, 1, :] = 0.0
    Ohat[3, 1, 2] = -20.0
    Ohat[3, 0, 1 + r + 2] = 1e38  # ckron(q) index 2: q_1 q_1
    Ohat[3, 0, 1 + r + 1] = -1e38  # ckron(q) index 1: q_1 q_0
    q0 = torch.stack([a["q0"]] + [torch.as_tensor(0.5 * rng.standard_normal(r), device="cuda")
                                   for _ in range(L - 1)])
    q0[:, 1] = 0.0
    q0[1, 1] = 2.0
    out = dict(a, Ohat=Ohat, q0=q0, shift=torch.stack([a["shift"]] * L),
               limits=torch.stack([a["limits"]] * L))
    if a["snapshots"] is not None:
        out["snapshots"] = torch.stack([a["snapshots"]] + [
            torch.as_tensor(0.2 * rng.standard_normal(tuple(a["snapshots"].shape)), device="cuda")
            for _ in range(L - 1)])
    for name, make in per_problem.items():
        out[name] = torch.stack([make(ell) for ell in range(L)])
    return out


def hold(name, s_k, e_k, s_p, e_p, maxdev, limits, G, nd, track, batched):
    """Kernel against plain on one case: identical flags on every draw, the
    known outcomes, err_sq within rtol 1e-3 where every draw is stable.
    Returns the largest |err_sq difference|."""
    lead = s_p.shape[:-1]
    # Every draw must sit clear of its limit, so the flags are decided by
    # construction, not by the last bits.
    lim = limits[..., None, :]
    clear = ~torch.isfinite(maxdev) | ((maxdev - lim).abs() > 1e-3 * lim)
    assert bool(clear.all()), f"{name}: a draw's maxdev lies within 1e-3 of its limit"
    assert torch.equal(s_k, s_p), f"{name}: flags differ: {torch.nonzero(s_k != s_p).tolist()}"
    by_cand = s_p.reshape(lead + (G, nd)).all(dim=-1)
    assert not bool(by_cand[..., -1].any()) and not bool(by_cand[..., -2].any())
    assert bool(by_cand[..., 1:-2].all()), f"{name}: a sound candidate came out unstable"
    if batched:  # draw 3 is NaN in trajectory 1 only
        assert not bool(s_p[1, 3]) and bool(s_p[[0] + list(range(2, lead[0])), 3].all())
        if track:
            assert not bool(torch.isfinite(e_p[1, 0])) and not bool(torch.isfinite(e_k[1, 0]))
    else:  # draw 3 has a NaN operator
        assert not bool(s_k[3]), f"{name}: the NaN draw came out stable"
    if not track:
        assert bool((e_k == 0).all())
        return 0.0
    ok = by_cand & torch.isfinite(e_p)
    assert int(ok.sum()) >= (G - 3) * (lead[0] if batched else 1)
    torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)
    return float((e_k[ok] - e_p[ok]).abs().max())


def cuda_ms(fn, reps):
    fn()  # warm up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def screen_bytes(args, N, G):
    """Each input read once and each output (N bools, G floats) written once."""
    return sum(a.numel() * a.element_size() for a in args if a is not None) + N + 4 * G


def quadratic_flops(N, r, k, substeps):
    """Float32 operations of one kernel A launch, counted from
    csrc/quadratic_screen.cu: per right-hand side r(r+1)/2 products and
    r (r + r(r+1)/2) multiply-adds; per RK4 step four of them and 13 r
    for the stage combinations. Data-independent."""
    P = r * (r + 1) // 2
    rhs = P + 2 * r * (r + P)
    return N * (k - 1) * substeps * (4 * rhs + 13 * r)


def cahbn_flops(N, r, nu, k, substeps, newton_iters):
    """Float32 operations of one kernel B launch, counted from
    csrc/cahbn_screen.cu (a multiply-add is two, a division one).
    Data-independent: the Newton count is fixed."""
    P = r * (r + 1) // 2
    rhs = P + nu * r + 2 * r * (r + P + nu + nu * r)
    newton_matrix = r * r * (2 * (r + 1) + 2 * nu + 2)
    eliminate = sum(1 + (r - 1 - p) * (1 + 2 * (r - 1 - p) + 2) for p in range(r))
    eliminate += sum(2 * (r - 1 - i) + 1 for i in range(r))
    newton = rhs + newton_matrix + eliminate + 4 * r
    substep = rhs + 2 * newton_iters * newton + 2 * r + 5 * r
    return N * (k - 1) * substeps * substep


def kernel_phase():
    """Phase 3; returns kernel A's JSON fields from the k = 400
    error-tracking call."""
    from gp_bayesopinf_torch.ops import ensemble_screen as es

    rng = np.random.default_rng(20260817)
    f32 = torch.float32
    max_err, times = 0.0, None
    # (r, G, nd, k, t_max, track_error, L); L = 0 is the single-problem
    # form; r = 6 is the ex1a shape, r = 5 the SEIRD one.
    cases = [(6, 16, 20, 401, 0.15, False, 0), (6, 16, 20, 400, 0.06, True, 0),
             (6, 16, 7, 400, 0.06, True, 0), (6, 16, 20, 400, 0.06, True, 2),
             (5, 16, 20, 360, 90.0, True, 0), (5, 16, 20, 500, 200.0, False, 0),
             (6, 16, 20, 3200, 0.06, True, 0)]  # the ex1c estimation grid
    seird, ex1c = {}, None
    for r, G, nd, k, t_max, track, L in cases:
        make = screen_case if r == 6 else seird_screen_case
        a = make(G, nd, k, t_max, rng, track)
        if L:
            a = batched_case(a, L, rng, {})
        f = {n: None if v is None else v.to(f32).contiguous() for n, v in a.items()}
        kw = dict(nd=nd, substeps=8, track_error=track)
        s_k, e_k = es.quadratic_ensemble_screen(*a.values(), **kw)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        s_p, e_p, maxdev = es._plain(*f.values(), nd, 8, track)
        stop.record()
        torch.cuda.synchronize()
        err = hold("A", s_k, e_k, s_p, e_p, maxdev, f["limits"], G, nd, track, L > 0)
        max_err = max(max_err, err)
        if k == 3200:  # the plain version takes seconds here: timed on this one run
            ms = cuda_ms(lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 10)
            bound, by = bound_ms(quadratic_flops(G * nd, r, k, 8),
                                 screen_bytes(f.values(), G * nd, G))
            ex1c = dict(ms=ms, plain_ms=start.elapsed_time(stop), bound_ms=bound, bound_by=by,
                        max_abs_err=err)
            print(f"[kernel vs plain] ex1c shape, k=3200 with error: kernel {ms:.3f} ms, plain "
                  f"{ex1c['plain_ms']:.3f} ms (CUDA events, one run), bound {bound:.4f} ms ({by}); "
                  f"{1e6 * ms / ((k - 1) * 8 * 4):.1f} ns per right-hand side; flags identical "
                  f"({int(s_k.sum())}/{s_k.numel()} stable), err_sq max abs diff {err:.3e}",
                  flush=True)
            continue
        print(f"[kernel vs plain] r={r} G={G} nd={nd} k={k} track_error={track} L={L or 1}: "
              f"flags identical ({int(s_k.sum())}/{s_k.numel()} stable)", flush=True)
        if r == 5:
            ms = cuda_ms(lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 10)
            plain_ms = cuda_ms(lambda: es._plain(*f.values(), nd, 8, track), 1)
            bound, by = bound_ms(quadratic_flops(G * nd, 5, k, 8),
                                 screen_bytes(f.values(), G * nd, G))
            seird[f"k{k}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel vs plain] SEIRD r=5 k={k} track_error={track}: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms (CUDA events), bound {bound:.4f} ms ({by}); "
                  f"{1e6 * ms / ((k - 1) * 8 * 4):.1f} ns per right-hand side", flush=True)
        if (r, G, nd, k) == (6, 16, 20, 400):
            ms = cuda_ms(lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 10)
            flops = quadratic_flops(G * nd, r, k, 8) * (L or 1)
            bound, by = bound_ms(flops, screen_bytes(f.values(), (L or 1) * G * nd, (L or 1) * G))
            if L:
                print(f"[kernel vs plain] k=400 with error, L={L} in one launch: kernel "
                      f"{ms:.3f} ms (CUDA events), bound {bound:.4f} ms ({by})", flush=True)
                continue
            plain_ms = cuda_ms(lambda: es._plain(*f.values(), nd, 8, track), 2)
            times = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel vs plain] k=400 with error: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms (CUDA events), bound {bound:.4f} ms "
                  f"({by}); {1e6 * ms / ((k - 1) * 8 * 4):.1f} ns per right-hand side",
                  flush=True)
    return dict(max_abs_err=max_err, seird=seird, ex1c=ex1c, **times)


def cahbn_case(G, nd, k, t_max, rng, track_error):
    """Synthetic heat-ex3-shaped cAHBN screen inputs (r = 5, nu = 2, the
    ex3 input family at (a, b) = (1, -1), 4 substeps) with known outcomes:
    candidate G-1 diverges to the clip, candidate G-2 leaves the envelope,
    draw 3 has a NaN operator; every other draw decays well inside it."""
    from gp_bayesopinf_torch.ops.cahbn_screen import input_stage_times
    from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory

    r, nu = 5, 2
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    Ohat = 0.3 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] += -20.0 * np.eye(r)
    Ohat[:, :, 1 + r :] *= 0.1
    Ohat[(G - 1) * nd :, :, 1 : 1 + r] += 60.0 * np.eye(r)  # e^{40 t}: hits the clip
    Ohat[(G - 2) * nd : (G - 1) * nd, :, 1 : 1 + r] += 26.0 * np.eye(r)  # past the envelope
    Ohat[3, 0, 0] = np.nan
    t = torch.linspace(0.0, t_max, k, dtype=torch.float64, device="cuda")
    u = input_func_factory((1.0, -1.0))(input_stage_times(t, 4)).T
    args = dict(
        Ohat=Ohat, q0=0.5 * rng.standard_normal(r), t_eval=t, shift=np.zeros(r),
        limits=np.full(r, 10.0), u_stages=u,
        snapshots=0.2 * rng.standard_normal((r, k)) if track_error else None,
    )
    return {n: None if v is None else torch.as_tensor(v, device="cuda") for n, v in args.items()}


def cahbn_phase():
    """Phase 4; returns kernel B's JSON fields from the k = 80
    error-tracking call."""
    from gp_bayesopinf_torch.ops import cahbn_screen as cs

    from gp_bayesopinf_torch.ops.cahbn_screen import input_stage_times
    from gp_bayesopinf_torch.pipeline.configs import HeatMultiConfig
    from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory

    rng = np.random.default_rng(20261016)
    f32 = torch.float32
    max_err, fields = 0.0, None
    # (G, nd, k, t_max, track_error, L); L = 0 is the single-problem form.
    # L = 5 is ex3's: each trajectory its own q0 and the inputs of its own
    # (a, b) of the training family.
    cases = [(16, 20, 80, 1.0, True, 0), (16, 20, 120, 2.0, False, 0), (16, 7, 80, 1.0, True, 0),
             (16, 20, 80, 1.0, True, 5), (16, 20, 500, 2.0, False, 0),
             (16, 20, 500, 2.0, False, 5)]
    params = HeatMultiConfig().input_parameters
    for G, nd, k, t_max, track, L in cases:
        a = cahbn_case(G, nd, k, t_max, rng, track)
        if L:
            ts = input_stage_times(a["t_eval"], 4)
            a = batched_case(a, L, rng, {
                "u_stages": lambda ell: input_func_factory(params[ell])(ts).T})
        f = {n: None if v is None else v.to(f32).contiguous() for n, v in a.items()}
        kw = dict(nd=nd, substeps=4, newton_iters=6, track_error=track)
        if k < 500:  # the plain version takes ~5 s a problem at k = 80
            s_k, e_k = cs.cahbn_ensemble_screen(*a.values(), **kw)
            torch.cuda.synchronize()
            s_p, e_p, maxdev = cs._plain(*f.values(), nd, 4, 6, track)
            err = hold("B", s_k, e_k, s_p, e_p, maxdev, f["limits"], G, nd, track, L > 0)
            max_err = max(max_err, err)
            print(f"[kernel B vs plain] G={G} nd={nd} k={k} track_error={track} L={L or 1}: "
                  f"flags identical ({int(s_k.sum())}/{s_k.numel()} stable)", flush=True)
        if nd != 20 or (k, track) not in ((80, True), (500, False)):
            continue
        ms = cuda_ms(lambda: cs.cahbn_ensemble_screen_cuda(*f.values(), **kw), 10 if k == 80 else 5)
        flops = cahbn_flops(G * nd, 5, 2, k, 4, 6) * (L or 1)
        bound, by = bound_ms(flops, screen_bytes(f.values(), (L or 1) * G * nd, (L or 1) * G))
        newton_ns = 1e6 * ms / ((k - 1) * 4 * 2 * 6)
        print(f"[kernel B] k={k} track_error={track} L={L or 1} in one launch: kernel {ms:.3f} "
              f"ms (CUDA events), bound {bound:.4f} ms ({by}); {newton_ns:.1f} ns per Newton "
              "step", flush=True)
        if (k, L) == (80, 0):
            plain_ms = cuda_ms(lambda: cs._plain(*f.values(), nd, 4, 6, track), 1)
            fields = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel B vs plain] k=80 with error: plain {plain_ms:.3f} ms (CUDA events)",
                  flush=True)
    return dict(max_abs_err=max_err, **fields)


def reset_launches():
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    ensemble_screen.launches = cahbn_screen.launches = 0


def read_launches():
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    return {"quadratic_ensemble_screen": ensemble_screen.launches,
            "cahbn_ensemble_screen": cahbn_screen.launches}


def run_counted(argv, kernel):
    """Run the CLI on ``argv`` with the launch counts set to 0 just before;
    returns (result, wall seconds, ``kernel``'s launches, objective
    evaluations of the regularization search)."""
    from gp_bayesopinf_torch.bayes import regsearch
    from gp_bayesopinf_torch.pipeline import cli

    evaluations = 0
    make = regsearch._kernel_objective

    def counted(*args, **kwargs):
        objective = make(*args, **kwargs)

        def evaluate(lams, xi):
            nonlocal evaluations
            evaluations += 1
            return objective(lams, xi)

        return evaluate

    regsearch._kernel_objective = counted
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = cli.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()[kernel]
    finally:
        regsearch._kernel_objective = make
    return res, wall, launches, evaluations


def pipeline_phase():
    """Phase 5; returns the kernel A launches of the run."""
    from gp_bayesopinf_torch.pipeline import ensemble_error

    res, wall, launches, evals = run_counted(EX1A, "quadratic_ensemble_screen")

    n_valid = int(res.valid.sum())
    err = ensemble_error(res)
    print(f"[ex1a] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex1a] lambda {res.regularizer:.6e}, "
          f"valid {n_valid}/600, ensemble-mean error vs compressed truth {err:.4f}, "
          f"kernel launches {launches} in {evals} objective evaluations", flush=True)
    assert launches >= 12, f"only {launches} kernel launches in the ex1a run"
    assert launches == 2 * evals, f"{launches} launches in {evals} evaluations"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 420, f"only {n_valid}/600 draws valid"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.draws).all())
    assert err < 0.5, f"ensemble-mean error {err:.4f}"
    return launches


def heat_phase():
    """Phase 6; returns the kernel B launches of the run."""
    from gp_bayesopinf_torch.pipeline import ensemble_errors

    res, wall, launches, evals = run_counted(EX3, "cahbn_ensemble_screen")

    n_valid = res.valid.sum(dim=1).tolist()
    errs, err_new = ensemble_errors(res)
    full, full_new = ensemble_errors(res, full_state=True)
    print(f"[ex3] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex3] lambda {res.regularizer:.6e}, valid {n_valid} of 600 per trajectory, "
          f"{int(res.newparam_valid.sum())}/600 at the test parameters; kernel B "
          f"launches {launches} in {evals} objective evaluations", flush=True)
    print(f"[ex3] ensemble-mean errors vs compressed truth {[round(e, 4) for e in errs]}, "
          f"test {err_new:.4f}; vs full-state truth {[round(e, 4) for e in full]}, "
          f"test {full_new:.4f}", flush=True)
    # One launch per time grid for all five trajectories: 2 per objective
    # evaluation, at least 12 for the 81-point grid in chunks of 16.
    assert launches >= 12, f"only {launches} kernel B launches in the ex3 run"
    assert launches == 2 * evals, f"{launches} kernel B launches in {evals} evaluations"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert min(n_valid) >= 420, f"valid draws per trajectory {n_valid}"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.newparam_draws[res.newparam_valid]).all())
    # 0.5, as the ex1a gate: the compressed error follows where the 20-draw
    # screen lets lambda land, 0.04-0.10 for lambda <= 1 and 0.31 at this
    # seed's lambda of 6.9 (PERF.md, section 6: the heat-multi entry).
    assert max(errs) < 0.5 and err_new < 0.5, f"ensemble-mean errors {errs}, {err_new}"
    return launches


def seird_phase():
    """Phase 7; returns the kernel A launches of the run."""
    from gp_bayesopinf_torch.gp import batched_gp_estimates
    from gp_bayesopinf_torch.pipeline.odes import ensemble_error
    from gp_bayesopinf_torch.solve import weighted_lstsq_fit

    res, wall, launches, evals = run_counted(SEIRD_EX1A, "quadratic_ensemble_screen")

    n_valid, n_valid_new = int(res.valid.sum()), int(res.newic_valid.sum())
    err, err_new = ensemble_error(res), ensemble_error(res, newic=True)
    mean = res.bayesian_model.mean.tolist()
    truth = list(res.model.parameters)
    print(f"[seird] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[seird] lambda {res.regularizer:.6e}, valid {n_valid}/600, {n_valid_new}/600 from "
          f"the new initial conditions; ensemble-mean error vs truth {err:.4f}, new {err_new:.4f}; "
          f"kernel A launches {launches} in {evals} objective evaluations", flush=True)
    print("[seird] posterior mean " + ", ".join(f"{m:.5g}" for m in mean)
          + " against true " + ", ".join(f"{p:.5g}" for p in truth), flush=True)
    # Two launches per objective evaluation (one per time grid), at least
    # 4 for the 22-point grid in chunks of 16.
    assert launches >= 4, f"only {launches} kernel A launches in the SEIRD run"
    assert launches == 2 * evals, f"{launches} launches in {evals} evaluations"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 420 and n_valid_new >= 420, f"valid draws {n_valid}, {n_valid_new} of 600"
    assert bool(torch.isfinite(res.draws[res.valid]).all())
    assert bool(torch.isfinite(res.newic_draws[res.newic_valid]).all())
    assert err < 0.5 and err_new < 0.5, f"ensemble-mean errors {err:.4f}, {err_new:.4f}"
    np.testing.assert_allclose(mean, truth, rtol=0.5)

    # The Cholesky weight root against the eigh root on this run's GP
    # problem (5 GPs, m = 90, m' = 360): one weighted norm, one posterior.
    dev = res.draws.device
    gps = res.gps
    T, Y = torch.stack([g.t_training for g in gps]), torch.stack([g.y for g in gps])
    hyper = [torch.tensor([getattr(g, name) for g in gps], dtype=torch.float64, device=dev)
             for name in ("constant", "length_scale", "noise_level")]
    means = {}
    for method in ("eigh", "chol"):
        est = batched_gp_estimates(T, Y, gps[0].t_estimation, *hyper, 1e-8, method=method)
        assert bool(est.ok.all()), f"{method}: weight covariance not positive definite"
        fac = weighted_lstsq_fit(
            res.model.data_matrix_blocks(est.state_estimate), est.weight_root[None],
            est.ddt_estimate[None], weights_are_cholesky=(method == "chol"),
        )
        means[method] = fac.solve(res.regularizer)[0]
    torch.testing.assert_close(means["eigh"], res.bayesian_model.mean, rtol=1e-9, atol=0.0)
    torch.testing.assert_close(means["chol"], means["eigh"], rtol=1e-6, atol=0.0)
    rel = float(((means["chol"] - means["eigh"]) / means["eigh"]).abs().max())
    print(f"[seird] Cholesky against eigh weight root: posterior means differ by {rel:.2e} "
          "relative at most", flush=True)
    return launches


def ex1c_phase():
    """Phase 8; returns the kernel A launches of the run."""
    from gp_bayesopinf_torch.pipeline import ensemble_error

    res, wall, launches, evals = run_counted(EX1C, "quadratic_ensemble_screen")

    n_valid = int(res.valid.sum())
    err = ensemble_error(res)
    print(f"[ex1c] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex1c] weight roots {sorted({g.weight_method for g in res.gps})}, retained ranks "
          f"{[g.lowrank_root.rank for g in res.gps]} of {res.gps[0].t_estimation.shape[0]}",
          flush=True)
    print(f"[ex1c] lambda {res.regularizer:.6e}, valid {n_valid}/600, ensemble-mean error vs "
          f"compressed truth {err:.4f}, kernel launches {launches} in {evals} objective "
          "evaluations", flush=True)
    assert all(g.weight_method == "lowrank" and g.sqrtW is None for g in res.gps)
    assert launches >= 12, f"only {launches} kernel launches in the ex1c run"
    assert launches == 2 * evals, f"{launches} launches in {evals} evaluations"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 420, f"only {n_valid}/600 draws valid"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.draws).all())
    assert err < 0.5, f"ensemble-mean error {err:.4f}"
    return launches


def scaled_phase():
    """Phase 9: the scaled run at its defaults, then the POD and the
    low-rank root held against their dense counterparts on its data."""
    from gp_bayesopinf_torch.gp.estimates import batched_gp_estimates
    from gp_bayesopinf_torch.gp.lowrank import batched_lowrank_gp_estimates
    from gp_bayesopinf_torch.pipeline import cli
    from gp_bayesopinf_torch.pipeline.scaled import search

    reset_launches()
    t0 = time.perf_counter()
    res = cli.run(SCALED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"[scaled] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[scaled] weight roots '{res.weight_method}', retained ranks of the 30 roots "
          f"{res.weight_ranks[0].tolist()} of 2048", flush=True)
    print("[scaled] grid errors " + ", ".join(
        f"{lam:.1e}: " + ("rejected" if e >= search.REJECTED else f"{e:.4f}")
        for lam, e in zip(res.grid, res.grid_errors)), flush=True)
    print(f"[scaled] regularizer {res.regularizer:.6e}, stable fraction "
          f"{res.stable_fraction:.4f}, train error {res.train_error:.5f}; hand-written kernel "
          f"launches on this path {launches} (no TPU kernel lies on it)", flush=True)
    assert res.weight_method == "lowrank" and res.weight_ranks.shape == (1, 30)
    assert not any(launches.values()), f"the scaled path launched a screen kernel: {launches}"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert bool((res.grid_errors < search.REJECTED).any()), "every grid candidate rejected"
    assert res.stable_fraction >= 0.7, f"stable fraction {res.stable_fraction:.4f}"
    # No accuracy gate below the shrinkage floor: at these defaults three of
    # the 30 POD modes of the synthetic source are noise, the 20-draw screen
    # rejects every lambda <= 1 in the JAX package too (held to 7 digits on
    # the CPU, tests/test_torch_scaled.py, the slow test), and the search
    # lands where the operators shrink towards zero and the error is ~1.
    # An error of 2 or more would be a diverging ensemble.
    assert res.train_error < 2.0, f"train error {res.train_error:.5f}"
    sv = res.svdvals[:30]
    assert np.isfinite(sv).all() and np.all(np.diff(sv) <= 0), "singular values not descending"
    assert res.ensemble_mean.shape == (30, 2048) and np.isfinite(res.ensemble_mean).all()

    # The randomized POD at the run's size against the exact spectrum (the
    # eigenvalues of the float64 Gram matrix). Float32 products: the
    # singular values that stand above the noise floor to 1e-4 of the
    # largest; those inside the floor's cluster (three of the 30 here) are
    # resolved by two power iterations only to ~10% (bound 25%).
    from gp_bayesopinf_torch.parallel import randomized_pod
    from gp_bayesopinf_torch.pipeline.scaled.data import synthetic_states

    gen = torch.Generator(device="cuda").manual_seed(0)
    states = synthetic_states(6000, 10000, 30, device="cuda", generator=gen)
    centered = states - states.mean(dim=1, keepdim=True)
    basis, pod_sv = randomized_pod(centered, 30, generator=gen)
    c64 = centered.double()
    exact = torch.sqrt(torch.linalg.eigvalsh(c64 @ c64.T).flip(0)[:30].clamp(min=0.0))
    signal = exact > 3.0 * exact[-1]
    pod_err = float((pod_sv[:30] - exact)[signal].abs().max() / exact[0])
    floor_err = float(((pod_sv[:30] - exact) / exact).abs().max())
    orth = float((basis.T @ basis - torch.eye(30, device="cuda")).abs().max())
    print(f"[scaled] randomized POD against the exact spectrum at (6000, 10000): the "
          f"{int(signal.sum())} singular values above the noise floor within {pod_err:.2e} of "
          f"the largest, all 30 within {floor_err:.2e} relative, basis orthonormal to "
          f"{orth:.2e}", flush=True)
    assert pod_err < 1e-4 and floor_err < 0.25 and orth < 1e-4, (pod_err, floor_err, orth)
    del states, centered, c64

    # The low-rank root against the dense eigh root at m' = 2048 on four of
    # the run's modes: W (C + eta I) W = I, and the same weighted Gram
    # matrix of the "cA" data matrix [1, q]. Both sit on the float64
    # conditioning floor at eta = 1e-8 (~1e-3), hence the bound 5e-3.
    dev, f64 = torch.device("cuda"), torch.float64
    modes = [0, 9, 19, 29]
    T = torch.as_tensor(res.sample_times, dtype=f64, device=dev).expand(len(modes), -1)
    Y = torch.as_tensor(res.samples[modes], dtype=f64, device=dev)
    hyper = [torch.as_tensor(res.hyperparameters[modes, i], dtype=f64, device=dev)
             for i in range(3)]
    t_est = torch.linspace(0.0, 1.0, 2048, dtype=f64, device=dev)
    low = batched_lowrank_gp_estimates(T, Y, t_est, *hyper, eta=1e-8)
    dense = batched_gp_estimates(T, Y, t_est, *hyper, 1e-8, method="eigh")
    assert bool(dense.ok.all())
    eye = torch.eye(2048, dtype=f64, device=dev)
    for i, mode in enumerate(modes):
        W = low[i].root.dense()  # (m', m') for this check only
        resid = float((W @ (dense.ddt_covariance[i] + 1e-8 * eye) @ W - eye).abs().max())
        D = torch.stack([torch.ones_like(t_est), dense.state_estimate[i]], dim=1)
        G_low = low[i].root.apply(D).T @ low[i].root.apply(D)
        G_dense = (dense.weight_root[i] @ D).T @ (dense.weight_root[i] @ D)
        rel = float(torch.linalg.norm(G_low - G_dense) / torch.linalg.norm(G_dense))
        print(f"[scaled] mode {mode}: low-rank root of rank {low[i].root.rank} (the run's "
              f"{res.weight_ranks[0, mode]}) against dense eigh: max |W (C + eta I) W - I| "
              f"{resid:.3e}, weighted Gram relative difference {rel:.3e}", flush=True)
        assert resid < 5e-3 and rel < 5e-3, (mode, resid, rel)
        torch.testing.assert_close(low[i].ddt_estimate, dense.ddt_estimate[i], rtol=1e-8,
                                   atol=1e-8 * float(dense.ddt_estimate[i].abs().max()))
    return wall


def windowed_phase():
    """Phase 10: a smoke of the windowed path on the card (no accuracy
    gate: the sizes are cut far below a deployment's)."""
    from gp_bayesopinf_torch.pipeline import cli

    t0 = time.perf_counter()
    res = cli.run(SCALED_WINDOWED)
    torch.cuda.synchronize()
    print(f"[scaled, 4 windows] wall {time.perf_counter() - t0:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[scaled, 4 windows] window regularizers {res.window_regularizers.tolist()}, stable "
          f"fraction {res.stable_fraction:.4f}, errors: anchored {res.window_error:.4f}, mean "
          f"handoff {res.chained_error_mean:.4f}, draw-wise {res.chained_error_draws:.4f}",
          flush=True)
    assert res.window_regularizers.shape == (4,)
    assert np.isfinite(res.window_regularizers).all() and (res.window_regularizers > 0).all()
    assert all(math.isfinite(e) for e in (res.window_error, res.chained_error_mean,
                                          res.chained_error_draws, res.train_error))
    assert res.ensemble_mean.shape == (8, 512) and np.isfinite(res.ensemble_mean).all()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gp_bayesopinf_torch.ops.build import build

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)

    names = ("quadratic_screen", "cahbn_screen")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(build, names)))
    print(f"[build] both in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in infos.items():
        print(f"[build] {info.path.name} in {info.seconds:.1f} s", flush=True)
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    fields = {"quadratic_ensemble_screen": kernel_phase(), "cahbn_ensemble_screen": cahbn_phase()}
    fields["quadratic_ensemble_screen"]["launches"] = pipeline_phase()
    fields["cahbn_ensemble_screen"]["launches"] = heat_phase()
    # Kernel A carries two main paths: its launches are those of both runs.
    by_path = {"ex1a": fields["quadratic_ensemble_screen"]["launches"], "seird": seird_phase(),
               "ex1c": ex1c_phase()}
    fields["quadratic_ensemble_screen"].update(
        launches=sum(by_path.values()), launches_by_path=by_path)
    scaled_phase()
    windowed_phase()

    def entry(name, f, **more):
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": f["launches"], "max_abs_err": f["max_abs_err"], "ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "library_ms": None, **more}

    A, B = fields["quadratic_ensemble_screen"], fields["cahbn_ensemble_screen"]
    print(json.dumps({"kernels": [
        entry("quadratic_ensemble_screen", A, shape="ex1a: G 16, nd 20, r 6, k 400, error term",
              launches_by_path=by_path, seird=A["seird"]),
        entry("cahbn_ensemble_screen", B, shape="ex3: G 16, nd 20, r 5, nu 2, k 80, error term"),
        # The same kernel at the ex1c estimation grid, with that run's launches.
        entry("quadratic_ensemble_screen", dict(A["ex1c"], launches=by_path["ex1c"]),
              shape="ex1c: G 16, nd 20, r 6, k 3200, error term"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
