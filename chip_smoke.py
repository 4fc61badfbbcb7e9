"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each failing loudly (an uncaught exception exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build both ensemble-screen kernels and the fused Euler truth solve
   from ``gp_bayesopinf_torch/csrc``, one nvcc each, in parallel, and
   print ptxas's registers and spills;
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
3b. kernel A above the templated r <= 12, so through its
   capacity-templated kernel, at r = 13, 16 and 24 (d = 105, 153, 325)
   with phase 3's cases (k = 400 with the error term and k = 401 without,
   nd = 7, L = 2): against the plain version (identical flags) and against
   PR 7's runtime-r kernel forced on the same inputs (identical flags,
   err_sq bit-equal), timed in turns with it; then the capacity and the
   runtime-r kernel forced at r = 6 against the templated instance:
   identical flags;
4. the same for kernel B (SDIRK2 "cAHBN" screen) at the heat ex3 screen
   shapes (G = 16, r = 5, nu = 2, d = 33, 4 substeps, 6 Newton steps,
   the ex3 input family): k = 80 with the error term, k = 120 over [0, 2]
   without it, nd = 7, and ex3's L = 5 trajectories in one launch, each
   with its own q0 and (a, b) inputs; the kernel is also timed at the
   full prediction grid, k = 500, with L = 1 and L = 5;
4b. kernel B above r <= 8, nu <= 2, so through its capacity-templated
   kernel, at r = 9 and 12 with nu = 2 (the ex3 input family) and r = 6
   with nu = 3, k = 80 with the error term; at r = 9 also k = 40 without
   it, and with it nd = 7 and L = 5 in one launch (k = 40): against the
   plain version and against PR 7's runtime-(r, nu) kernel as in 3b,
   timed in turns with it at k = 80; at the heat search's other grid (r =
   9, nu = 2, k = 500 without the error term, L = 5) against the runtime
   kernel and timed in turns; then both forced at r = 5, nu = 2 against
   the templated instance;
4c. the wide kernels, which the wrappers choose above the capacity
   kernels, with the runtime-dimension kernels forced beside them:
   kernel A at r = 40 and 64 (k = 400 with the error term), kernel B at
   (r, nu) = (20, 2) and (6, 5) (k = 80 with it) and at (45, 2) and (46,
   2) (k = 5: the largest operator the wide kernel stages in shared
   memory at nu = 2, and the smallest it reads from device scratch), G =
   16, nd = 20: each kernel against the plain version on the inputs it is
   timed on, the two kernels' flags against each other, the two timed in
   turns with CUDA events, beside the bound; both families' launches on
   the main paths are read from every main-path run below (by the
   wrappers' per-family counts) and must be 0;
4d. the fused Euler truth solve (``csrc/euler_truth.cu``) against the
   ``rk4_solve`` loop through ``Euler.solve``: ex1a's two solves (nx 200,
   the 401 prediction times and the 200 sample times of the CLI's seed)
   and ``scaled``'s Euler source at its width (nx 2000) over
   ``SCALED_LOCAL``'s 2,400 snapshots and at nx 3000, past the register
   kernel's 2048 cells (the wide kernel, 240 snapshots); equal to the
   bit, the kernel timed with CUDA events, the loop once;
4e. the fused SDIRK2 integration of "cAHBN" ROM draws
   (``cahbn_dirk2_kernel`` of ``csrc/cahbn_screen.cu``) against the
   ``dirk2_solve`` loop through ``GalerkinROM.predict`` at heat ex3's two
   ensemble shapes (5 x 600 draws with their trajectories' inputs, and 600
   draws at the test parameters; r 5, nu 2, k 500, 4 substeps, operators
   as ``cahbn_case`` builds them, its two blocks of growing draws linear):
   timed in turns with the loop (loop, kernel, kernel, loop) with CUDA
   events, us a Newton step, the largest gap of a stable draw over its
   largest state, identical masks, and ptxas's registers and spill of the
   r 5, nu 2 instance;
5. run the full ex1a workload through the port's CLI entry
   (``euler 0.06 200 0.03 400 6 --ndraws 600`` on ``cuda``) and check
   that the grid search went through kernel A, two launches per objective
   evaluation, that the truth solves took the fused kernel (two
   launches), that its decisions are the loop's to the digit (lambda
   ``EX1A_LAMBDA``, ``EX1A_VALID`` valid draws) and that the posterior
   ensemble is sound;
6. run the full heat ex3 workload (``heat 1.0 20 0.05 80 5 --ndraws
   600``) and check that its search went through kernel B, two launches
   per objective evaluation for all five trajectories, that its two
   ensembles took the fused SDIRK2 kernel, one launch each, and that
   every trajectory's ensemble is sound;
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
8b. ``euler 0.06 200 0.03 400 16 --ndraws 600`` and 8c. ``heat 1.0 20
   0.05 80 9 --ndraws 600``: searches above the templated instances, so
   through the capacity-templated kernels (every launch, by the wrappers'
   per-family counts); two launches per objective evaluation, a sound
   ensemble, lambda, valid counts and errors printed;
9. run the production-scale pipeline at its defaults (``scaled``: n =
   6000, 10,000 snapshots, 30 modes, m' = 2048, low-rank roots, 256
   draws) and check its regularizer, grid, stable share, training error
   and singular values; no hand-written kernel lies on this path, and the
   launch counts show it; hold the randomized POD against the exact
   spectrum, and the low-rank root against the dense eigh root on a
   handful of the run's modes at m' = 2048;
mesh. the multi-device layer (``gp_bayesopinf_torch.parallel``), after
   phase 9: (a) one rank spawned on cuda:0 with NCCL runs ``run_scaled`` at
   its defaults on ``make_mesh({"draw": 1, "mode": 1})``, held against phase
   9's one-device run (the grid's rejections and argmin, lambda inside the
   grid bracket, the stable share, singular values to 1e-4 of the largest,
   hyperparameters to 1e-3 in their logarithm; which stages are equal to
   the bit is printed); (b) two ranks share cuda:0 through gloo (NCCL takes
   one rank a card, so the backend is named and printed): the ex1a search
   of phase 5's run (G 81, nd 20, r 6, k 401 and 400) through kernel A on
   {"draw": 2}, its grid errors and lambda equal to the one-device
   search's to the bit on both ranks, each rank's kernel A launches beside
   the one-device search's, then ``run_scaled`` at its defaults on
   {"draw": 2, "mode": 1}, equal on both ranks, its walls, collectives and
   decisions printed beside the one-device run's under phase 9's gates;
   (c) ``python -m gp_bayesopinf_torch.pipeline.cli scaled --devices 1``
   (m' cut to 512) prints one JSON line;
10. one smaller windowed run (Euler source, 4 windows, "cAH", a scaled
    column-norm Tikhonov matrix) so that path touches the card: finite
    outputs only, no accuracy gate;
10b. local window bases at the JAX package's production width (Euler
    source, n = 6000, 12 modes, 8 windows of 256 GP samples, m' = 2048, 16
    restarts, 256 draws, anchor chaining; the snapshots cut from 10,000 to
    2,400, the Euler truth solve's share of the wall): eight
    finite positive regularizers, every window basis orthonormal to 1e-5,
    a window's end state through the transfer equal to the full-space map,
    finite window and chained errors, printed beside the JAX package's;
11. the resident server: ``python3 -m gp_bayesopinf_torch.pipeline.cli
    serve`` as a fresh process in ``build/chip_smoke/serve`` answers
    ``warmup seird``, the SEIRD ex1a run as plain text, as JSON, with
    ``--exportto`` and with ``--profile``, four bad lines and ``quit``;
    every SEIRD answer must print phase 7's regularizer and stable count
    and launch kernel A as often (its ack's launch count), the export must
    hold the posterior (or fail naming ``h5py`` where it is missing), and
    the profiled request's trace must hold the stage ranges and that many
    kernel A launches; the acks' walls are the process's first run
    (warmup) against its warm runs;
12. the checkpoint: ``scaled`` at its defaults but m' = 512 with a
    fresh ``--checkpoint-dir``, then again with it: the same result to
    the bit, and no data, POD or GP-fit stage in the second run.
examples. the port's demos, studies and notebooks (``examples/torch_*``,
    ``scripts/torch_*_study.py``) through their compute and report
    functions: the SEIRD demo at ``--full`` (phase 7's gates, kernel A's
    launches counted, its printed error equal to ``ensemble_error``'s);
    the Euler demo's report on phase 5's run (its printed error equal to
    the compressed error over the training span, computed on the card);
    the extrapolation study's ``domain_errors`` of phase 5's run and one
    ex2a run (50 samples, 1% noise, m' 400, r 6, 400 draws: lambda > 0, at
    least 70% valid, finite errors, kernel A's launches counted); three
    rungs of the stability ladder (the chosen lambda, 1e-2, 1e-1) on
    phase 5's factorization; the notebooks' model cells on the card
    (``SEIRD2.solve`` and ``noise``, ``CubicHeatBimodal.solve`` on a 41 x
    41 grid) against their host twins at rtol 1e-10; figures only where
    matplotlib and h5py are, said on a line of its own.

The last two lines of standard output are a JSON summary of the kernels
and a JSON status line.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

EX1A = ["euler", "0.06", "200", "0.03", "400", "6", "--ndraws", "600", "--device", "cuda"]
EX3 = ["heat", "1.0", "20", "0.05", "80", "5", "--ndraws", "600", "--device", "cuda"]
SEIRD_EX1A = ["seird", "90", "90", "0.10", "360", "--ndraws", "600", "--device", "cuda"]
EX1C = ["euler", "0.06", "200", "0.03", "3200", "6", "--ndraws", "600", "--device", "cuda"]
SCALED = ["scaled", "--quiet", "--device", "cuda"]
# ex1a's decisions at the CLI's seed (27092023) on the H100, through the
# rk4_solve loop and the fused truth solve alike.
EX1A_LAMBDA, EX1A_VALID = "6.143891e-02", 584
# The Euler source's initial-condition knots (pipeline/scaled/data.py).
EULER_KNOTS = (22.0, 20.0, 24.0, 95.0, 105.0, 100.0)
EULER16 = ["euler", "0.06", "200", "0.03", "400", "16", "--ndraws", "600", "--device", "cuda"]
# r = 9, not 10: at r = 10 the 20-draw grid screen rejects every candidate
# on the card (PERF.md, section 6), so 9 is the largest r above the templated
# instances (r <= 8) at which the heat search completes.
HEAT9 = ["heat", "1.0", "20", "0.05", "80", "9", "--ndraws", "600", "--device", "cuda"]
# Local window bases at the JAX package's production width (BASELINE.md,
# round 5: nx 2000, k 10,000, m' 2048, W 8, 16 restarts, 256 draws, r 12,
# 256 GP samples a window, anchor chaining), with one cut: k 10,000 ->
# 2,400 snapshots (300 a window), since the Euler truth solve took 125 of
# the phase's 146 s at 10,000 on an H100.
SCALED_LOCAL = ["scaled", "--source", "euler", "--n-space", "6000", "--k", "2400", "--modes", "12",
                "--gp-samples", "2048", "--mprime", "2048", "--restarts", "16", "--ndraws", "256",
                "--windows", "8", "--window-basis", "local", "--chaining", "anchor",
                "--modelform", "cAH", "--quiet", "--device", "cuda"]
# Cut in depth to 1000 snapshots (from 2000): the truth solve set its wall.
SCALED_WINDOWED = ["scaled", "--source", "euler", "--n-space", "600", "--k", "1000", "--modes", "8",
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


def screen_case(G, nd, k, t_max, rng, track_error, r=6):
    """Synthetic ex1a-shaped screen inputs (r = 6 unless given) with known
    outcomes: candidate G-1 diverges to the clip, candidate G-2 leaves the
    envelope, draw 3 has a NaN operator; every other draw decays well
    inside the envelope."""
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


def cuda_ms(fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def f32(a):
    """A case's inputs as the kernels' float32 copies."""
    return {n: None if v is None else v.to(torch.float32).contiguous() for n, v in a.items()}


def held(name, screen, plain, a, kw, G, batched, keep_plain=False):
    """The screen entry ``screen`` on case ``a`` with keywords ``kw``,
    against its plain version ``plain`` on the float32 copy, timed with
    CUDA events; the two held by ``hold``. Returns the float32 copy, the
    kernel's (stable, err_sq), the largest |err_sq difference| and the
    plain version's milliseconds, and with ``keep_plain`` the plain
    version's (stable, err_sq, maxdev) last."""
    f = f32(a)
    s_k, e_k = screen(*a.values(), **kw)
    torch.cuda.synchronize()
    steps = (kw["substeps"],) + ((kw["newton_iters"],) if "newton_iters" in kw else ())
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    s_p, e_p, maxdev = plain(*f.values(), kw["nd"], *steps, kw["track_error"])
    stop.record()
    torch.cuda.synchronize()
    err = hold(name, s_k, e_k, s_p, e_p, maxdev, f["limits"], G, kw["nd"], kw["track_error"],
               batched)
    out = f, s_k, e_k, err, start.elapsed_time(stop)
    return out + ((s_p, e_p, maxdev),) if keep_plain else out


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
        kw = dict(nd=nd, substeps=8, track_error=track)
        f, s_k, e_k, err, plain_ms = held("A", es.quadratic_ensemble_screen, es._plain, a, kw, G,
                                          L > 0)
        max_err = max(max_err, err)
        if k == 3200:  # the plain version takes seconds here: timed on this one run
            ms = cuda_ms(lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 10)
            bound, by = bound_ms(quadratic_flops(G * nd, r, k, 8),
                                 screen_bytes(f.values(), G * nd, G))
            ex1c = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
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
            bound, by = bound_ms(quadratic_flops(G * nd, 5, k, 8),
                                 screen_bytes(f.values(), G * nd, G))
            seird[f"k{k}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel vs plain] SEIRD r=5 k={k} track_error={track}: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms (CUDA events, one run), bound {bound:.4f} ms "
                  f"({by}); {1e6 * ms / ((k - 1) * 8 * 4):.1f} ns per right-hand side",
                  flush=True)
        if (r, G, nd, k) == (6, 16, 20, 400):
            ms = cuda_ms(lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 10)
            flops = quadratic_flops(G * nd, r, k, 8) * (L or 1)
            bound, by = bound_ms(flops, screen_bytes(f.values(), (L or 1) * G * nd, (L or 1) * G))
            if L:
                print(f"[kernel vs plain] k=400 with error, L={L} in one launch: kernel "
                      f"{ms:.3f} ms (CUDA events), bound {bound:.4f} ms ({by})", flush=True)
                continue
            times = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel vs plain] k=400 with error: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms (CUDA events, one run), bound {bound:.4f} ms "
                  f"({by}); {1e6 * ms / ((k - 1) * 8 * 4):.1f} ns per right-hand side",
                  flush=True)
    return dict(max_abs_err=max_err, seird=seird, ex1c=ex1c, **times)


def ex3_inputs(params, t, nu=2):
    """The ex3 input family at (a, b) = ``params`` at every time the SDIRK2
    screen reads (4 substeps): ((k-1) 12, nu). Channels beyond the two,
    where nu > 2, are sin(2 pi c t) for c = 1, 2, ..."""
    from gp_bayesopinf_torch.ops.cahbn_screen import input_stage_times
    from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory

    ts = input_stage_times(t, 4)
    u = input_func_factory(params)(ts).T
    extra = [torch.sin(2.0 * math.pi * c * ts)[:, None] for c in range(1, nu - 1)]
    return torch.cat([u] + extra, dim=1)


def cahbn_case(G, nd, k, t_max, rng, track_error, r=5, nu=2):
    """Synthetic heat-ex3-shaped cAHBN screen inputs (r = 5 and nu = 2
    unless given, the ex3 input family at (a, b) = (1, -1), 4 substeps)
    with known outcomes: candidate G-1 diverges to the clip, candidate G-2
    leaves the envelope, draw 3 has a NaN operator; every other draw decays
    well inside it."""
    d = 1 + r + r * (r + 1) // 2 + nu + nu * r
    Ohat = 0.3 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] += -20.0 * np.eye(r)
    Ohat[:, :, 1 + r :] *= 0.1
    Ohat[(G - 1) * nd :, :, 1 : 1 + r] += 60.0 * np.eye(r)  # e^{40 t}: hits the clip
    Ohat[(G - 2) * nd : (G - 1) * nd, :, 1 : 1 + r] += 26.0 * np.eye(r)  # past the envelope
    Ohat[3, 0, 0] = np.nan
    t = torch.linspace(0.0, t_max, k, dtype=torch.float64, device="cuda")
    u = ex3_inputs((1.0, -1.0), t, nu)
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
        f = f32(a)
        kw = dict(nd=nd, substeps=4, newton_iters=6, track_error=track)
        if k < 500:  # the plain version takes ~5 s a problem at k = 80
            f, s_k, e_k, err, plain_ms = held("B", cs.cahbn_ensemble_screen, cs._plain, a, kw, G,
                                              L > 0)
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
        if (k, L) == (80, 0):  # plain_ms: the plain run of the check above
            fields = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel B vs plain] k=80 with error: plain {plain_ms:.3f} ms (CUDA events, "
                  "one run)", flush=True)
    return dict(max_abs_err=max_err, **fields)


def same_bits(name, s_new, e_new, s_old, e_old):
    """The new kernel against PR 7's runtime kernel on the same inputs:
    identical flags and err_sq bit for bit (NaN where the other is NaN).
    Both keep each row's arithmetic in the same order and the same
    per-draw partial sums, so no tolerance is needed."""
    assert torch.equal(s_new, s_old), (
        f"{name}: flags differ from the runtime kernel: {torch.nonzero(s_new != s_old).tolist()}")
    nan_new, nan_old = torch.isnan(e_new), torch.isnan(e_old)
    assert torch.equal(nan_new, nan_old), f"{name}: err_sq NaN where the runtime kernel's is not"
    bits_new, bits_old = e_new.view(torch.int32), e_old.view(torch.int32)
    differ = (bits_new != bits_old) & ~nan_new
    assert not bool(differ.any()), (
        f"{name}: err_sq not bit-equal to the runtime kernel's at {torch.nonzero(differ).tolist()}: "
        f"{e_new[differ].tolist()} against {e_old[differ].tolist()}")


def in_turns(old, new, reps, warm=True):
    """CUDA-event milliseconds of two calls in the order old, new, new, old,
    each warmed up first unless both have just run (``warm=False``);
    returns (old's two times, new's two times)."""
    t = [cuda_ms(fn, reps, warm) for fn in (old, new, new, old)]
    return [t[0], t[3]], [t[1], t[2]]


def capacity_a_phase():
    """Phase 3b: kernel A above its templated instances, so through the
    capacity-templated kernel, at r = 13, 16 and 24 (d = 105, 153, 325)
    with phase 3's cases: against the plain version (identical flags,
    err_sq within rtol 1e-3) and against PR 7's runtime-r kernel forced on
    the same inputs (identical flags, err_sq bit-equal); timed in turns
    with the runtime-r kernel at k = 400. Then forced at r = 6, both the
    capacity and the runtime-r kernel against the templated instance:
    identical flags. Returns the JSON fields of each r, from its k = 400
    error-tracking call."""
    from gp_bayesopinf_torch.ops import ensemble_screen as es

    rng = np.random.default_rng(20261017)
    out = {}
    # (r, G, nd, k, t_max, track_error, L); L = 0 is the single-problem form.
    cases = [(r, 16, 20, 400, 0.06, True, 0) for r in (13, 16, 24)]
    cases += [(16, 16, 20, 401, 0.15, False, 0), (16, 16, 7, 400, 0.06, True, 0),
              (16, 16, 20, 400, 0.06, True, 2)]
    for r, G, nd, k, t_max, track, L in cases:
        a = screen_case(G, nd, k, t_max, rng, track, r=r)
        if L:
            a = batched_case(a, L, rng, {})
        kw = dict(nd=nd, substeps=8, track_error=track)
        assert es.screen_family(r) == "capacity"
        f, s_k, e_k, err, plain_ms = held(f"A r={r}", es.quadratic_ensemble_screen, es._plain, a,
                                          kw, G, L > 0)
        s_r, e_r = es.quadratic_ensemble_screen_cuda(*f.values(), **kw, family="runtime")
        torch.cuda.synchronize()
        same_bits(f"A r={r}", s_k, e_k, s_r, e_r)
        print(f"[kernel A, capacity {es.capacity_instance(r)}] r={r} G={G} nd={nd} k={k} "
              f"track_error={track} L={L or 1}: flags identical to the plain version "
              f"({int(s_k.sum())}/{s_k.numel()} stable), err_sq max abs diff {err:.3e}; flags "
              "identical and err_sq bit-equal to the runtime-r kernel", flush=True)
        if (nd, k, L) != (20, 400, 0):
            continue
        old, new = in_turns(
            lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw, family="runtime"),
            lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 5)
        ms, ms_old = sum(new) / 2, sum(old) / 2
        bound, by = bound_ms(quadratic_flops(G * nd, r, k, 8), screen_bytes(f.values(), G * nd, G))
        rhs = (k - 1) * 8 * 4
        out[r] = dict(ms=ms, runtime_ms=ms_old, plain_ms=plain_ms,
                      bound_ms=bound, bound_by=by, max_abs_err=err, ns_per_rhs=1e6 * ms / rhs,
                      capacity=es.capacity_instance(r))
        print(f"[kernel A, capacity {es.capacity_instance(r)}] r={r} k=400 with error, in turns "
              f"(runtime, capacity, capacity, runtime): {old[0]:.3f}, {new[0]:.3f}, {new[1]:.3f}, "
              f"{old[1]:.3f} ms ({ms_old / ms:.2f}x); plain {out[r]['plain_ms']:.3f} ms (CUDA "
              f"events; plain one run), bound {bound:.4f} ms ({by}); {1e6 * ms / rhs:.1f} ns per "
              f"right-hand side (runtime-r kernel {1e6 * ms_old / rhs:.1f})", flush=True)

    # Below the capacity kernel's range: both it and the runtime-r kernel,
    # forced at r = 6, against the templated instance.
    for L in (0, 2):
        a = screen_case(16, 20, 400, 0.06, rng, True)
        if L:
            a = batched_case(a, L, rng, {})
        f = f32(a)
        kw = dict(nd=20, substeps=8, track_error=True)
        s_t, e_t = es.quadratic_ensemble_screen_cuda(*f.values(), **kw)
        ok = s_t.reshape(s_t.shape[:-1] + (16, 20)).all(dim=-1) & torch.isfinite(e_t)
        for family in ("capacity", "runtime"):
            s_a, e_a = es.quadratic_ensemble_screen_cuda(*f.values(), **kw, family=family)
            torch.cuda.synchronize()
            assert torch.equal(s_a, s_t), (
                f"r=6, {family}: flags differ: {torch.nonzero(s_a != s_t).tolist()}")
            torch.testing.assert_close(e_a[ok], e_t[ok], rtol=1e-3, atol=0.0)
            print(f"[kernel A, {family}] forced at r=6, L={L or 1}: flags identical to the "
                  f"templated instance ({int(s_a.sum())}/{s_a.numel()} stable), err_sq max abs "
                  f"diff {float((e_a[ok] - e_t[ok]).abs().max()):.3e}", flush=True)
    return out


def capacity_b_phase():
    """Phase 4b: kernel B beyond its templated instances, so through the
    capacity-templated kernel, at r = 9 and 12 with nu = 2 (the ex3 input
    family) and r = 6 with nu = 3, k = 80 with the error term; at r = 9
    also k = 40 without it, and with it nd = 7 and ex3's L = 5 trajectories
    in one launch: against the plain version (identical flags, err_sq
    within rtol 1e-3) and against PR 7's runtime-(r, nu) kernel forced on
    the same inputs (identical flags, err_sq bit-equal); timed in turns
    with the runtime kernel at k = 80, and at the search's other grid (r =
    9, nu = 2, k = 500 without the error term, L = 5), held there against
    the runtime kernel alone (the plain version would take minutes). Then
    forced at r = 5, nu = 2 against the templated instance: identical
    flags. Returns the JSON fields of each (r, nu), from its k = 80
    error-tracking call."""
    from gp_bayesopinf_torch.ops import cahbn_screen as cs
    from gp_bayesopinf_torch.pipeline.configs import HeatMultiConfig

    rng = np.random.default_rng(20261018)
    out = {}
    params = HeatMultiConfig().input_parameters
    # (r, nu, G, nd, k, t_max, track_error, L)
    # The edge cases at k = 40: the plain version's ~16 s a problem at k = 80
    # would take 80 s for L = 5 alone. k = 500 runs no plain version.
    cases = [(9, 2, 16, 20, 80, 1.0, True, 0), (12, 2, 16, 20, 80, 1.0, True, 0),
             (6, 3, 16, 20, 80, 1.0, True, 0), (9, 2, 16, 20, 40, 2.0, False, 0),
             (9, 2, 16, 7, 40, 1.0, True, 0), (9, 2, 16, 20, 40, 1.0, True, 5),
             (9, 2, 16, 20, 500, 2.0, False, 5)]
    for r, nu, G, nd, k, t_max, track, L in cases:
        a = cahbn_case(G, nd, k, t_max, rng, track, r=r, nu=nu)
        if L:
            a = batched_case(a, L, rng, {"u_stages": lambda ell: ex3_inputs(params[ell],
                                                                              a["t_eval"])})
        kw = dict(nd=nd, substeps=4, newton_iters=6, track_error=track)
        assert cs.screen_family(r, nu) == "capacity"
        instance = f"capacity {cs.capacity_instance(r)}"
        if k < 500:
            f, s_k, e_k, err, plain_ms = held(f"B r={r} nu={nu}", cs.cahbn_ensemble_screen,
                                              cs._plain, a, kw, G, L > 0)
        else:
            f = f32(a)
            s_k, e_k = cs.cahbn_ensemble_screen(*a.values(), **kw)
        s_r, e_r = cs.cahbn_ensemble_screen_cuda(*f.values(), **kw, family="runtime")
        torch.cuda.synchronize()
        same_bits(f"B r={r} nu={nu} k={k}", s_k, e_k, s_r, e_r)
        if k < 500:
            print(f"[kernel B, {instance}] r={r} nu={nu} G={G} nd={nd} k={k} track_error={track} "
                  f"L={L or 1}: flags identical to the plain version ({int(s_k.sum())}/"
                  f"{s_k.numel()} stable), err_sq max abs diff {err:.3e}; flags identical and "
                  "err_sq bit-equal to the runtime kernel", flush=True)
        else:
            print(f"[kernel B, {instance}] r={r} nu={nu} G={G} nd={nd} k={k} track_error={track} "
                  f"L={L}: flags identical to the runtime kernel ({int(s_k.sum())}/{s_k.numel()} "
                  "stable)", flush=True)
        if (nd, k, L) not in ((20, 80, 0), (20, 500, 5)):
            continue
        old, new = in_turns(
            lambda: cs.cahbn_ensemble_screen_cuda(*f.values(), **kw, family="runtime"),
            lambda: cs.cahbn_ensemble_screen_cuda(*f.values(), **kw), 5 if k == 80 else 2)
        ms, ms_old = sum(new) / 2, sum(old) / 2
        # Both kernels stop integrating a draw once it turns NaN: the NaN-operator
        # draws (and, with L = 5, draw 3 of trajectory 1, NaN after its first
        # right-hand side; batched_case) do no Newton work and are not counted.
        nan_draws = 1 if L else int(torch.isnan(f["Ohat"]).flatten(1).any(dim=1).sum())
        bound, by = bound_ms(cahbn_flops((L or 1) * G * nd - nan_draws, r, nu, k, 4, 6),
                             screen_bytes(f.values(), (L or 1) * G * nd, (L or 1) * G))
        steps = (k - 1) * 4 * 2 * 6
        fields = dict(ms=ms, runtime_ms=ms_old, bound_ms=bound, bound_by=by,
                      ns_per_newton_step=1e6 * ms / steps, capacity=cs.capacity_instance(r))
        print(f"[kernel B, {instance}] r={r} nu={nu} k={k} track_error={track} L={L or 1}, in "
              f"turns (runtime, capacity, capacity, runtime): {old[0]:.3f}, {new[0]:.3f}, "
              f"{new[1]:.3f}, {old[1]:.3f} ms ({ms_old / ms:.2f}x); bound {bound:.4f} ms ({by}); "
              f"{1e6 * ms / steps:.1f} ns per Newton step (runtime kernel "
              f"{1e6 * ms_old / steps:.1f})", flush=True)
        if k == 500:
            out[(9, 2)]["k500_L5"] = fields
            continue
        out[(r, nu)] = dict(fields, plain_ms=plain_ms, max_abs_err=err)
        print(f"[kernel B, {instance}] r={r} nu={nu} k=80: plain {out[(r, nu)]['plain_ms']:.3f} "
              "ms (CUDA events, one run)", flush=True)

    # Below the capacity kernel's range: it and the runtime kernel, forced at
    # r = 5, nu = 2 (ex3's shape), against the templated instance.
    f = f32(cahbn_case(16, 20, 80, 1.0, rng, True))
    kw = dict(nd=20, substeps=4, newton_iters=6, track_error=True)
    s_t, e_t = cs.cahbn_ensemble_screen_cuda(*f.values(), **kw)
    ok = s_t.reshape(16, 20).all(dim=-1) & torch.isfinite(e_t)
    for family in ("capacity", "runtime"):
        s_a, e_a = cs.cahbn_ensemble_screen_cuda(*f.values(), **kw, family=family)
        torch.cuda.synchronize()
        assert torch.equal(s_a, s_t), (
            f"r=5, nu=2, {family}: flags differ: {torch.nonzero(s_a != s_t).tolist()}")
        torch.testing.assert_close(e_a[ok], e_t[ok], rtol=1e-3, atol=0.0)
        print(f"[kernel B, {family}] forced at r=5, nu=2: flags identical to the templated "
              f"instance ({int(s_a.sum())}/{s_a.numel()} stable), err_sq max abs diff "
              f"{float((e_a[ok] - e_t[ok]).abs().max()):.3e}", flush=True)
    return out


def wide_phase_4c():
    """Phase 4c: the wide kernels in the range the wrappers give them,
    with the runtime-dimension kernels forced beside them: kernel A at r
    = 40 (d = 861, its operator in registers) and r = 64 (d = 2145, 549 KB
    a draw: rows past the registers in shared memory and device memory),
    k = 400; kernel B at (r, nu) = (20, 2) and (6, 5), k = 80, and at (45,
    2) and (46, 2), k = 5, the largest (r, nu) at nu = 2 whose operator the
    wide kernel stages in shared memory and the smallest it reads from
    device scratch (the plain version's time grows with r^2 launches a
    Newton step, so these two are held at the k they are timed at); G = 16,
    nd = 20, with the error term, on phase 3's and 4's cases. Each shape:
    the wide kernel, chosen by the wrapper, against the plain version on
    the inputs it is timed on (identical flags, err_sq within rtol 1e-3);
    the runtime kernel forced on the same inputs against the plain version
    and against the wide kernel (identical flags); the two timed in turns
    (runtime, wide, wide, runtime) with CUDA events. Returns each shape's
    JSON fields for both kernels: {label: {"wide": ..., "runtime": ...}}."""
    from gp_bayesopinf_torch.ops import cahbn_screen as cs
    from gp_bayesopinf_torch.ops import ensemble_screen as es

    rng = np.random.default_rng(20261019)
    G, nd = 16, 20
    out = {}
    scratch = cs._library().gpboi_cahbn_wide_scratch
    assert scratch(45, 2) == 0 < scratch(46, 2), "B's wide kernel stages (45, 2) and not (46, 2)"
    # (r, nu, k, timing repetitions); nu None for kernel A.
    for r, nu, k, reps in ((40, None, 400, 1), (64, None, 400, 1), (20, 2, 80, 3), (6, 5, 80, 3),
                           (45, 2, 5, 3), (46, 2, 5, 3)):
        if nu is None:  # kernel A
            mod, screen, label = es, es.quadratic_ensemble_screen, f"A r={r}"
            wrapper = es.quadratic_ensemble_screen_cuda
            family = es.screen_family(r)
            a = screen_case(G, nd, k, 0.06, rng, True, r=r)
            kw = dict(nd=nd, substeps=8, track_error=True)
            work, steps, per = quadratic_flops(G * nd, r, k, 8), (k - 1) * 8 * 4, "rhs"
        else:
            mod, screen, label = cs, cs.cahbn_ensemble_screen, f"B r={r} nu={nu}"
            wrapper = cs.cahbn_ensemble_screen_cuda
            family = cs.screen_family(r, nu)
            a = cahbn_case(G, nd, k, 1.0, rng, True, r=r, nu=nu)
            kw = dict(nd=nd, substeps=4, newton_iters=6, track_error=True)
            # No kernel integrates a draw whose operator is NaN.
            nan_draws = int(torch.isnan(a["Ohat"]).flatten(1).any(dim=1).sum())
            work = cahbn_flops(G * nd - nan_draws, r, nu, k, 4, 6)
            steps, per = (k - 1) * 4 * 2 * 6, "newton_step"
        assert family == "wide", (label, family)
        before = dict(mod.family_launches)
        f, s_w, e_w, err_w, plain_ms, (s_p, e_p, maxdev) = held(
            label, screen, mod._plain, a, kw, G, False, keep_plain=True)
        assert mod.family_launches["wide"] == before["wide"] + 1
        s_r, e_r = wrapper(*f.values(), **kw, family="runtime")
        torch.cuda.synchronize()
        assert mod.family_launches["runtime"] == before["runtime"] + 1
        err_r = hold(f"{label} runtime", s_r, e_r, s_p, e_p, maxdev, f["limits"], G, nd, True,
                     False)
        assert torch.equal(s_w, s_r), (
            f"{label}: wide and runtime flags differ: {torch.nonzero(s_w != s_r).tolist()}")
        # Both kernels have just run on these inputs: no warm-up calls (the
        # runtime kernel takes seconds a call at r 64).
        old, new = in_turns(lambda: wrapper(*f.values(), **kw, family="runtime"),
                            lambda: wrapper(*f.values(), **kw), reps, warm=False)
        ms, ms_old = sum(new) / 2, sum(old) / 2
        bound, by = bound_ms(work, screen_bytes(f.values(), G * nd, G))
        shape = (f"G {G}, nd {nd}, r {r}" + ("" if nu is None else f", nu {nu}")
                 + f", k {k}, error term")
        common = dict(plain_ms=plain_ms, bound_ms=bound, bound_by=by, shape=shape)
        out[label] = {
            "wide": dict(common, ms=ms, runtime_ms=ms_old, max_abs_err=err_w,
                         **{f"ns_per_{per}": 1e6 * ms / steps}),
            "runtime": dict(common, ms=ms_old, max_abs_err=err_r,
                            **{f"ns_per_{per}": 1e6 * ms_old / steps}),
        }
        print(f"[kernel {label}, wide] G={G} nd={nd} k={k} with error: flags identical to the "
              f"plain version ({int(s_w.sum())}/{s_w.numel()} stable) and to the runtime "
              f"kernel's, err_sq max abs diff {err_w:.3e} (runtime kernel {err_r:.3e}); in turns "
              f"(runtime, wide, wide, runtime): {old[0]:.3f}, {new[0]:.3f}, {new[1]:.3f}, "
              f"{old[1]:.3f} ms "
              f"({ms_old / ms:.2f}x); plain {plain_ms:.3f} ms (CUDA events, one run), bound "
              f"{bound:.4f} ms ({by}; wide {ms / bound:.1f}x, runtime {ms_old / bound:.0f}x); "
              f"{1e6 * ms / steps:.1f} ns per {per.replace('_', ' ')} (runtime kernel "
              f"{1e6 * ms_old / steps:.1f})", flush=True)
    return out


def reset_launches():
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    ensemble_screen.launches = cahbn_screen.launches = 0
    for counts in (ensemble_screen.family_launches, cahbn_screen.family_launches):
        counts.update(dict.fromkeys(counts, 0))


def read_launches():
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    return {"quadratic_ensemble_screen": ensemble_screen.launches,
            "cahbn_ensemble_screen": cahbn_screen.launches}


# The families that no main path reaches: phase 4c's.
PHASE_4C_FAMILIES = ("runtime", "wide")


def phase_4c_launches():
    """Each kernel's launches of the runtime and the wide families since the
    last ``reset_launches``: {kernel: {family: launches}}."""
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    return {name: {f: mod.family_launches[f] for f in PHASE_4C_FAMILIES}
            for name, mod in (("quadratic_ensemble_screen", ensemble_screen),
                              ("cahbn_ensemble_screen", cahbn_screen))}


# The runtime and wide kernels' launches on the main paths: every main
# path's run adds its counts (``phase_4c_launches``, or a child process's)
# here just after it ends.
MAIN_PATH_4C = {name: dict.fromkeys(PHASE_4C_FAMILIES, 0) for name in KERNELS}


def tally_4c(counts=None):
    for name, by_family in (counts or phase_4c_launches()).items():
        for family in PHASE_4C_FAMILIES:
            MAIN_PATH_4C[name][family] += by_family[family]


def run_counted(argv, kernel):
    """Run the CLI on ``argv`` with the launch counts set to 0 just before;
    returns (result, wall seconds, ``kernel``'s launches, objective
    evaluations of the regularization search)."""
    from gp_bayesopinf_torch.pipeline import cli

    return call_counted(lambda: cli.run(argv), kernel)


def call_counted(fn, kernel):
    """``fn()`` with the launch counts set to 0 just before, as
    ``run_counted``."""
    from gp_bayesopinf_torch.bayes import regsearch

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
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()[kernel]
        tally_4c()
    finally:
        regsearch._kernel_objective = make
    return res, wall, launches, evaluations


def pipeline_phase():
    """Phase 5; returns the kernel A launches of the run, its search's
    inputs (``ex1a_search_inputs``) for phase ``mesh``, the result for
    phase ``examples`` and the fused truth solve's launches."""
    from gp_bayesopinf_torch.ops import euler_truth
    from gp_bayesopinf_torch.pipeline import ensemble_error

    euler_truth.launches = 0
    res, wall, launches, evals = run_counted(EX1A, "quadratic_ensemble_screen")
    truth = euler_truth.launches

    n_valid = int(res.valid.sum())
    err = ensemble_error(res)
    print(f"[ex1a] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex1a] lambda {res.regularizer:.6e}, "
          f"valid {n_valid}/600, ensemble-mean error vs compressed truth {err:.4f}, "
          f"kernel launches {launches} in {evals} objective evaluations, "
          f"fused truth-solve launches {truth}", flush=True)
    assert truth == 2, f"{truth} fused truth-solve launches in the ex1a run"
    assert (f"{res.regularizer:.6e}", n_valid) == (EX1A_LAMBDA, EX1A_VALID), \
        (res.regularizer, n_valid)
    assert launches >= 12, f"only {launches} kernel launches in the ex1a run"
    assert launches == 2 * evals, f"{launches} launches in {evals} evaluations"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 420, f"only {n_valid}/600 draws valid"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.draws).all())
    assert err < 0.5, f"ensemble-mean error {err:.4f}"
    return launches, ex1a_search_inputs(res), res, truth


def euler_truth_phase():
    """Phase 4d: ``Euler.solve`` through the fused kernel against the
    ``rk4_solve`` loop at the substeps its CFL rule chose; returns each
    case's times for the summary."""
    from gp_bayesopinf_torch.models import Euler
    from gp_bayesopinf_torch.models import euler as euler_module
    from gp_bayesopinf_torch.pipeline.configs import EulerConfig
    from gp_bayesopinf_torch.solve.ivp import rk4_solve
    from gp_bayesopinf_torch.utils.keys import stage_generators

    cfg = EulerConfig()
    ex1a = Euler(cfg.spatial_domain, substeps=cfg.fom_substeps)
    u = torch.rand(200, generator=stage_generators(cfg.seed, "cuda")["sample"],
                   dtype=torch.float64, device="cuda")
    t_samples = np.sort((0.06 * u).cpu().numpy())  # as run_euler draws them
    t_samples[0], t_samples[-1] = 0.0, 0.06
    cases = [("ex1a prediction, nx 200, k 401", ex1a, cfg.init_params, cfg.time_domain),
             ("ex1a samples, nx 200, k 200", ex1a, cfg.init_params, t_samples),
             ("scaled Euler source, nx 2000, k 2400", Euler(np.linspace(0.0, 2.0, 2001)[:-1]),
              EULER_KNOTS, np.linspace(0.0, 0.06, 2400)),
             ("scaled Euler source, nx 3000 (n_space 9000, the wide kernel), k 240",
              Euler(np.linspace(0.0, 2.0, 3001)[:-1]), EULER_KNOTS, np.linspace(0.0, 0.006, 240))]
    kernel = euler_module.euler_rk4_cuda
    out = {}
    for name, model, knots, times in cases:
        ics = model.initial_conditions(knots, device="cuda")
        calls = []
        euler_module.euler_rk4_cuda = lambda *a: calls.append(a) or kernel(*a)
        try:
            fused = model.solve(ics, times)
        finally:
            euler_module.euler_rk4_cuda = kernel
        (args,) = calls
        q0, t, substeps = args[:3]
        ms = cuda_ms(lambda: kernel(*args), 10)
        t0 = time.perf_counter()
        looped = model.lift(rk4_solve(model.derivative, q0, t, substeps=substeps))
        torch.cuda.synchronize()
        loop_ms = 1e3 * (time.perf_counter() - t0)
        steps = (len(times) - 1) * substeps
        print(f"[euler truth] {name}: {substeps} substeps, {steps} RK4 steps; fused "
              f"{ms:.3f} ms ({1e6 * ms / steps:.1f} ns a step), loop {loop_ms:.1f} ms "
              f"({loop_ms / ms:.0f}x); equal to the bit", flush=True)
        assert torch.equal(fused, looped), name
        out[name] = {"ms": ms, "loop_ms": loop_ms, "steps": steps, "nx": q0.shape[0] // 3}
    return out


def dirk2_registers():
    """ptxas's report of the fused SDIRK2 kernel's r 5, nu 2 instance:
    (registers, spill stores, spill loads) from this process's build of
    ``cahbn_screen``; Nones where it loaded a library built before."""
    from gp_bayesopinf_torch.ops.build import build

    lines = build("cahbn_screen").log.splitlines()
    at = [i for i, line in enumerate(lines)
          if "Compiling entry function" in line and "cahbn_dirk2_kernelILi5ELi2E" in line]
    if not at:
        return None, None, None
    info = " ".join(lines[at[0] + 1 : at[0] + 4])
    regs = int(re.search(r"Used (\d+) registers", info).group(1))
    stores, loads = (int(v) for v in re.search(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", info).groups())
    return regs, stores, loads


def dirk2_phase():
    """Phase 4e: the fused SDIRK2 kernel against the ``dirk2_solve`` loop
    at heat ex3's two ensemble shapes; returns each shape's times."""
    from gp_bayesopinf_torch.ops import cahbn_dirk2 as cd
    from gp_bayesopinf_torch.pipeline.configs import HeatMultiConfig
    from gp_bayesopinf_torch.pipeline.pdes_multi import input_func_factory, stacked_input_func
    from gp_bayesopinf_torch.rom import model as rom_model
    from gp_bayesopinf_torch.rom.model import GalerkinROM
    from gp_bayesopinf_torch.solve.ivp import finite_mask, stability_mask

    cfg = HeatMultiConfig()
    rng = np.random.default_rng(20261019)
    r, nu, nd = 5, 2, 600
    t = torch.as_tensor(cfg.time_domain, device="cuda")
    rom = GalerkinROM("cAHBN", r, nu, ivp_method="dirk2", substeps=cfg.rom_substeps)
    newton = (len(t) - 1) * cfg.rom_substeps * 2 * 6
    regs, stores, loads = dirk2_registers()
    print(f"[dirk2] cahbn_dirk2_kernel<5, 2>: {regs} registers, {stores} B spill stores, "
          f"{loads} B spill loads", flush=True)
    out = {}
    for name, L in (("ensemble, 5 x 600 draws", 5), ("newparam, 600 draws", 0)):
        # cahbn_case's operators, a set for each trajectory (30 candidates of 20
        # draws): the last candidate driven to the clamp, the one before past
        # the envelope, a NaN draw. The two grow linearly: a draw that the
        # quadratic term blows up leaves Newton unconverged, where any two
        # roundings part, so its finite mask is not reproducible.
        a = cahbn_case(30 * max(L, 1), 20, 2, 1.0, rng, False)
        a["Ohat"][-40:, :, 1 + r :] = 0.0
        O = a["Ohat"].reshape(max(L, 1), nd, r, -1)
        q0 = 0.5 * torch.randn(max(L, 1), 1, r, dtype=torch.float64, device="cuda")
        u = stacked_input_func(cfg.input_parameters, "cuda") if L else \
            input_func_factory(cfg.test_parameters)
        if not L:
            O, q0 = O[0], q0[0, 0]
        before = cd.launches
        fused = rom.predict(O, q0, t, u)
        torch.cuda.synchronize()
        assert cd.launches == before + 1, "the ensemble did not take the fused kernel"

        def loop():
            with mock.patch.object(rom_model, "fused_dirk2", lambda *a: False):
                return rom.predict(O, q0, t, u)

        looped = loop()
        shift = torch.zeros(r, dtype=torch.float64, device="cuda")
        limits = torch.full_like(shift, 10.0)
        keep = stability_mask(fused, shift, limits)
        assert torch.equal(torch.isnan(fused), torch.isnan(looped)), name
        assert torch.equal(finite_mask(fused), finite_mask(looped)), name
        assert torch.equal(keep, stability_mask(looped, shift, limits)), name
        gap = float(((fused - looped).abs().amax((-2, -1))
                     / looped.abs().amax((-2, -1)))[keep].max())
        assert gap <= 1e-12, f"{name}: the kernel is {gap:.3e} from the loop"
        ms_loop0 = cuda_ms(loop, 1, warm=False)
        ms = [cuda_ms(lambda: rom.predict(O, q0, t, u), 3) for _ in range(2)]
        ms_loop = [ms_loop0, cuda_ms(loop, 1, warm=False)]
        print(f"[dirk2] {name}, k 500, 4 substeps: fused {ms[0]:.3f} / {ms[1]:.3f} ms "
              f"({1e3 * min(ms) / newton:.3f} us a Newton step of a draw), loop "
              f"{ms_loop[0]:.1f} / {ms_loop[1]:.1f} ms ({min(ms_loop) / min(ms):.0f}x); "
              f"{int(keep.sum())}/{keep.numel()} stable, largest gap {gap:.3e}; masks "
              "identical", flush=True)
        out[name] = {"ms": ms, "loop_ms": ms_loop, "gap": gap, "newton_steps": newton,
                     "draws": keep.numel()}
    return out, {"registers": regs, "spill_stores": stores, "spill_loads": loads}


def ex1a_search_inputs(res):
    """The regularization search of an ex1a run as NumPy arrays: the
    weighted factorization rebuilt from its GPs (r 6, m' 400, d 28), the
    time grids (k 401 and 400), the GP state estimates, the 81-point grid
    and the search's standard normals (drawn here, seed 0)."""
    from gp_bayesopinf_torch.gp.gp import regression_weights
    from gp_bayesopinf_torch.pipeline.configs import EulerConfig
    from gp_bayesopinf_torch.solve import weighted_lstsq_fit

    st = torch.stack([gp.state_estimate for gp in res.gps])
    roots, chol = regression_weights([[gp] for gp in res.gps])
    fac = weighted_lstsq_fit(res.rom.data_matrix(st)[None], roots,
                             torch.stack([gp.ddt_estimate for gp in res.gps])[:, None],
                             weights_are_cholesky=chol)
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid = EulerConfig().reg_grid
    shape = (20, fac.num_problems, fac.num_unknowns)
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return dict(
        fac=[host(x) for x in fac], st=host(st), t_pred=res.time_domain, t_est=res.t_estimation,
        grid=grid, substeps=res.rom.substeps,
        xi_grid=host(torch.randn((len(grid),) + shape, generator=gen, dtype=torch.float64,
                                 device="cuda")),
        xi_refine=host(torch.randn(shape, generator=gen, dtype=torch.float64, device="cuda")),
    )


def heat_phase():
    """Phase 6; returns the kernel B launches of the run."""
    from gp_bayesopinf_torch.pipeline import ensemble_errors

    from gp_bayesopinf_torch.ops import cahbn_dirk2

    before = cahbn_dirk2.launches
    res, wall, launches, evals = run_counted(EX3, "cahbn_ensemble_screen")
    fused = cahbn_dirk2.launches - before

    n_valid = res.valid.sum(dim=1).tolist()
    errs, err_new = ensemble_errors(res)
    full, full_new = ensemble_errors(res, full_state=True)
    print(f"[ex3] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex3] lambda {res.regularizer:.6e}, valid {n_valid} of 600 per trajectory, "
          f"{int(res.newparam_valid.sum())}/600 at the test parameters; kernel B "
          f"launches {launches} in {evals} objective evaluations; fused SDIRK2 launches "
          f"{fused}", flush=True)
    print(f"[ex3] ensemble-mean errors vs compressed truth {[round(e, 4) for e in errs]}, "
          f"test {err_new:.4f}; vs full-state truth {[round(e, 4) for e in full]}, "
          f"test {full_new:.4f}", flush=True)
    # One launch per time grid for all five trajectories: 2 per objective
    # evaluation, at least 12 for the 81-point grid in chunks of 16.
    assert launches >= 12, f"only {launches} kernel B launches in the ex3 run"
    assert launches == 2 * evals, f"{launches} kernel B launches in {evals} evaluations"
    assert fused == 2, f"{fused} fused SDIRK2 launches for the two ensembles"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert min(n_valid) >= 420, f"valid draws per trajectory {n_valid}"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.newparam_draws[res.newparam_valid]).all())
    # 0.5, as the ex1a gate: the compressed error follows where the 20-draw
    # screen lets lambda land, 0.04-0.10 for lambda <= 1 and 0.31 at this
    # seed's lambda of 6.9 (PERF.md, section 6: the heat-multi entry).
    assert max(errs) < 0.5 and err_new < 0.5, f"ensemble-mean errors {errs}, {err_new}"
    return launches, fused


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
    return launches, res


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
    tally_4c()
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
    return wall, res


def windowed_phase():
    """Phase 10: a smoke of the windowed path on the card (no accuracy
    gate: the sizes are cut far below a deployment's)."""
    from gp_bayesopinf_torch.pipeline import cli

    reset_launches()
    t0 = time.perf_counter()
    res = cli.run(SCALED_WINDOWED)
    torch.cuda.synchronize()
    tally_4c()
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


def wide_phase(argv, kernel, r):
    """Phases 8b and 8c: a pipeline run whose search screens at a state
    dimension above the templated instances, so through the runtime
    kernel; two launches per objective evaluation for all trajectories,
    and a sound ensemble. Returns the launches."""
    from gp_bayesopinf_torch.pipeline import ensemble_error, ensemble_errors

    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    res, wall, launches, evals = run_counted(argv, kernel)
    families = dict((ensemble_screen if kernel == "quadratic_ensemble_screen"
                     else cahbn_screen).family_launches)
    name = " ".join(argv[:6])
    print(f"[{name}] launches by kernel family: {families}", flush=True)
    assert families["capacity"] == launches, f"not every launch took the capacity kernel: {families}"
    print(f"[{name}] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    if argv[0] == "heat":
        n_valid = res.valid.sum(dim=1).tolist()
        errs, err_new = ensemble_errors(res)
        err = max(errs + [err_new])
        valid_new = int(res.newparam_valid.sum())
        print(f"[{name}] lambda {res.regularizer:.6e}, valid {n_valid} of 600 per trajectory, "
              f"{valid_new}/600 at the test parameters; ensemble-mean errors vs compressed truth "
              f"{[round(e, 4) for e in errs]}, test {err_new:.4f}; kernel B launches {launches} "
              f"in {evals} objective evaluations", flush=True)
        assert bool(torch.isfinite(res.newparam_draws[res.newparam_valid]).all())
    else:
        n_valid = [int(res.valid.sum())]
        err = ensemble_error(res)
        print(f"[{name}] lambda {res.regularizer:.6e}, valid {n_valid[0]}/600, ensemble-mean "
              f"error vs compressed truth {err:.4f}; kernel A launches {launches} in {evals} "
              "objective evaluations", flush=True)
    assert res.draws_compressed.shape[-2] == r, res.draws_compressed.shape
    assert launches >= 12 and launches == 2 * evals, f"{launches} launches in {evals} evaluations"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert min(n_valid) > 0, f"valid draws {n_valid}"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert math.isfinite(err), f"ensemble-mean error {err}"
    return launches


def local_phase():
    """Phase 10b: local window bases at the reference's production width
    (``SCALED_LOCAL``): eight finite positive regularizers, every window
    basis orthonormal, the boundary transfer of a window's end state equal
    to the full-space map, and finite window and chained errors."""
    from gp_bayesopinf_torch.pipeline import cli
    from gp_bayesopinf_torch.pipeline.scaled.search import transfer_maps

    reset_launches()
    t0 = time.perf_counter()
    res = cli.run(SCALED_LOCAL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tally_4c()
    print(f"[scaled, 8 local windows] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    lams = res.window_regularizers
    print(f"[scaled, 8 local windows] window regularizers {lams.tolist()}, stable fraction "
          f"{res.stable_fraction:.4f}; errors: window (anchored) {res.window_error:.4f}, mean "
          f"handoff {res.chained_error_mean:.4f}, draw-wise {res.chained_error_draws:.4f} (the "
          "JAX package's window error at this configuration with 10,000 snapshots: 0.643, "
          "BASELINE.md); kernel "
          f"launches {read_launches()} (no TPU kernel on this path)", flush=True)
    assert lams.shape == (8,) and np.isfinite(lams).all() and (lams > 0).all(), lams
    assert all(math.isfinite(e) for e in (res.window_error, res.chained_error_mean,
                                          res.chained_error_draws))
    B = torch.as_tensor(res.window_bases, device="cuda").double()  # (8, 6000, 12)
    mu = torch.as_tensor(res.window_means, device="cuda").double()
    eye = torch.eye(12, dtype=torch.float64, device="cuda")
    orth = float((B.transpose(1, 2) @ B - eye).abs().amax())
    assert B.shape == (8, 6000, 12) and orth < 1e-5, orth
    # Window 0's anchored ensemble-mean end state, crossed into window 1.
    T, b = transfer_maps(B, mu)
    mw = res.ensemble_mean.shape[1] // 8
    q = torch.as_tensor(res.ensemble_mean[:, mw - 1], dtype=torch.float64, device="cuda")
    full = B[1].T @ (mu[0] + B[0] @ q - mu[1])
    moved = T[0] @ q + b[0]
    gap = float((moved - full).abs().max() / full.abs().max())
    print(f"[scaled, 8 local windows] bases orthonormal to {orth:.2e}; window 0's end state "
          f"through T_0, b_0 against the full-space map: {gap:.2e} relative", flush=True)
    assert gap < 1e-10, gap
    assert not any(read_launches().values())
    return wall


def trace_names(path):
    """(names of the kernel events, set of the user ranges' names) of a
    Chrome trace by ``profile_trace``. The trace of a SEIRD run is ~1 GB:
    its events are found by a scan of the text, in the layout that the
    profiler writes ("cat" before "name"), and read with ``json`` only if
    the scan finds no kernel."""
    import re

    text = Path(path).read_bytes()

    def names(cat):
        pattern = rb'"cat"\s*:\s*"' + cat + rb'"\s*,\s*"name"\s*:\s*"((?:[^"\\]|\\.)*)"'
        return [m.decode() for m in re.findall(pattern, text)]

    kernels, ranges = names(rb"kernel"), set(names(rb"user_annotation"))
    if not kernels:
        events = json.loads(text)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    return kernels, ranges


def serve_phase(seird_res, seird_launches):
    """Phase 11: the resident server in a fresh process. ``seird_res`` and
    ``seird_launches`` are phase 7's result and kernel A launches, which
    every SEIRD answer must repeat. Returns kernel A's launches in the
    session, from the acks."""
    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke" / "serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    export, prof = work / "seird", work / "prof"
    seird = " ".join(SEIRD_EX1A)
    requests = [
        "warmup seird --ndraws 600", seird, json.dumps({"argv": SEIRD_EX1A}),
        f"{seird} --exportto {export} --nolog", f"{seird} --profile {prof} --nolog",
        "42", '{"x": 1}', "euler 0.06", "serve",
    ]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gp_bayesopinf_torch.pipeline.cli", "serve"], cwd=work, env=env,
        input="\n".join(requests + ["quit"]) + "\n", capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"serve exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    segments, acks, lines = [], [], []
    for line in proc.stdout.splitlines():
        if line.startswith('{"serve"'):
            acks.append(json.loads(line)["serve"])
            segments.append(lines)
            lines = []
        else:
            lines.append(line)
    assert len(acks) == len(requests), f"{len(acks)} acks for {len(requests)} requests"
    for req, ack in zip(requests, acks):
        assert {"rc", "wall_s", "argv", "launches"} <= set(ack), ack
        print(f"[serve] {req[:60]!r}: rc {ack['rc']}, wall {ack['wall_s']:.3f} s, kernel A "
              f"launches {ack['launches']['quadratic_ensemble_screen']}"
              + (f", error {ack['error'][:120]!r}" if "error" in ack else ""), flush=True)

    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    want = [0, 0, 0, 0 if have_h5py else 1, 0, 2, 2, 2, 2]
    assert [a["rc"] for a in acks] == want, [a["rc"] for a in acks]
    assert all(a["argv"] is None for a in acks[5:7]) and acks[8]["argv"] == ["serve"]
    lam, n_valid = f"{seird_res.regularizer:.6e}", int(seird_res.valid.sum())
    for i in (1, 2, 3, 4) if have_h5py else (1, 2, 4):  # the SEIRD runs
        out = "\n".join(segments[i])
        assert f"chosen regularizer: {lam}" in out, f"request {i}: {out[-2000:]}"
        assert f"stable draws: {n_valid}/600" in out, f"request {i}: {out[-2000:]}"
    counts = [a["launches"]["quadratic_ensemble_screen"] for a in acks]
    # Without h5py the export request fails before its run.
    assert counts[:5] == [seird_launches] * 3 + [seird_launches if have_h5py else 0,
                                                 seird_launches], counts
    assert not any(a["launches"]["cahbn_ensemble_screen"] for a in acks)
    for ack in acks:
        tally_4c(ack["family_launches"])
    print(f"[serve] every SEIRD answer: lambda {lam}, {n_valid}/600 stable, {seird_launches} "
          "kernel A launches, as phase 7", flush=True)

    if have_h5py:
        import h5py

        with h5py.File(f"{export}_posterior.h5", "r") as hf:
            mean, cov = hf["mean"][:], hf["cov"][:]
        np.testing.assert_allclose(mean, seird_res.bayesian_model.mean.cpu().numpy(), rtol=1e-10)
        np.testing.assert_allclose(cov, seird_res.bayesian_model.cov.cpu().numpy(), rtol=1e-10)
        assert os.path.isfile(f"{export}_data.h5")
        print("[serve] h5py present: the export holds phase 7's posterior (rtol 1e-10)",
              flush=True)
    else:
        assert "h5py" in acks[3]["error"], acks[3]
        print("[serve] h5py missing: the export request failed with rc 1 naming h5py",
              flush=True)

    traces = sorted(prof.glob("*.json"))
    assert len(traces) == 1, traces
    t1 = time.perf_counter()
    kernels, ranges = trace_names(traces[0])
    screens = sum("quadratic_screen_kernel" in name for name in kernels)
    stages = ("data", "gp_fit", "regression", "ensemble", "newic")
    print(f"[serve] profile trace {traces[0].name}: {os.path.getsize(traces[0]) / 1e6:.1f} MB, "
          f"{len(kernels)} kernels, {screens} kernel A; read in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    assert set(stages) <= ranges, f"stage ranges missing: {set(stages) - ranges}"
    assert screens == seird_launches, f"{screens} kernel A events in the trace"
    shutil.rmtree(prof)  # ~1 GB
    first, warm = acks[0]["wall_s"], [a["wall_s"] for a in acks[1:5]]
    print(f"[serve] process wall {wall:.2f} s; first run (warmup) {first:.3f} s; warm runs "
          f"{warm[0]:.3f}, {warm[1]:.3f} s; with --exportto {warm[2]:.3f} s; with --profile "
          f"{warm[3]:.3f} s", flush=True)
    return sum(counts)


def checkpoint_phase():
    """Phase 12: ``scaled`` at its defaults twice with one fresh
    checkpoint directory; the second run resumes."""
    from gp_bayesopinf_torch.pipeline import cli

    ckpt = tempfile.mkdtemp(prefix="scaled-ckpt-", dir=Path(__file__).resolve().parent / "build")
    runs, walls = [], []
    reset_launches()
    for _ in range(2):
        t0 = time.perf_counter()
        # m' cut to 512 (from 2048): the refinement's steps set the wall.
        runs.append(cli.run(SCALED + ["--mprime", "512", "--checkpoint-dir", ckpt]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    tally_4c()
    first, second = runs
    for res, wall in zip(runs, walls):
        print(f"[checkpoint] wall {wall:.2f} s; stages (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    front = {"data", "pod", "gp_fit"}
    assert front <= set(first.stage_seconds) and not front & set(second.stage_seconds)
    assert second.regularizer == first.regularizer and second.train_error == first.train_error
    np.testing.assert_array_equal(second.grid_errors, first.grid_errors)
    np.testing.assert_array_equal(second.ensemble_mean, first.ensemble_mean)
    print(f"[checkpoint] resumed run equal to the bit: regularizer {second.regularizer:.6e}, "
          f"train error {second.train_error:.5f}, grid errors and ensemble mean "
          f"({second.ensemble_mean.shape}) identical; walls {walls[0]:.2f} -> {walls[1]:.2f} s",
          flush=True)
    shutil.rmtree(ckpt)


# Phase mesh (c): the command line's multi-device path, cut in depth (m'
# 2048 -> 512, as phase 12) since phase mesh (a) runs the defaults.
MESH_CLI = ["scaled", "--devices", "1", "--mprime", "512", "--quiet", "--device", "cuda"]


def scaled_digest(res):
    """The values of a ``ScaledResult`` that phase ``mesh`` compares."""
    return dict(regularizer=res.regularizer, stable_fraction=res.stable_fraction,
                train_error=res.train_error, grid_errors=res.grid_errors, svdvals=res.svdvals,
                hyperparameters=res.hyperparameters, ensemble_mean=res.ensemble_mean,
                stages=dict(res.stage_seconds))


def mesh_scaled_rank(rank, shape):
    """A rank of phase ``mesh``: ``run_scaled`` at its defaults on a mesh of
    ``shape`` on this rank's card; its digest, wall and collectives."""
    import torch.distributed as dist

    from gp_bayesopinf_torch.parallel import make_mesh
    from gp_bayesopinf_torch.parallel import mesh as pmesh
    from gp_bayesopinf_torch.pipeline import run_scaled

    mesh = make_mesh(shape, "cuda")
    pmesh.collectives, pmesh.collective_seconds = 0, 0.0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_scaled(mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    return dict(scaled_digest(res), wall=time.perf_counter() - t0, collectives=pmesh.collectives,
                collective_seconds=pmesh.collective_seconds, backend=dist.get_backend(),
                card=torch.cuda.current_device(), phase_4c=phase_4c_launches())


def search_args(search):
    """``auto_regularize``'s arguments for ``ex1a_search_inputs`` on the card."""
    from gp_bayesopinf_torch.rom import GalerkinROM
    from gp_bayesopinf_torch.solve.lstsq import WeightedLSTSQ

    cuda = lambda x: torch.as_tensor(x, device="cuda")  # noqa: E731
    fac = WeightedLSTSQ(*map(cuda, search["fac"]))
    st = cuda(search["st"])
    rom = GalerkinROM("cAH", state_dimension=st.shape[0], substeps=search["substeps"])
    args = (fac, rom, st[:, 0], cuda(search["t_pred"]), cuda(search["t_est"]), st)
    kw = dict(grid=search["grid"], ndraws=20, verbose=False, xi_grid=cuda(search["xi_grid"]),
              xi_refine=cuda(search["xi_refine"]))
    return args, kw


def mesh_pair_rank(rank, search):
    """A rank of phase ``mesh`` (b), two on one card: the ex1a search on
    {"draw": 2}, its kernel A launches counted from 0, then ``run_scaled``
    at its defaults on {"draw": 2, "mode": 1}."""
    from gp_bayesopinf_torch.bayes import auto_regularize
    from gp_bayesopinf_torch.ops import ensemble_screen
    from gp_bayesopinf_torch.parallel import make_mesh

    args, kw = search_args(search)
    mesh = make_mesh({"draw": 2}, "cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = auto_regularize(*args, mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()["quadratic_ensemble_screen"]
    search_out = dict(grid_errors=res.grid_errors, regularizer=res.regularizer,
                      refined=res.refined, launches=launches, wall=wall,
                      families=dict(ensemble_screen.family_launches),
                      phase_4c=phase_4c_launches())
    return dict(search=search_out, scaled=mesh_scaled_rank(rank, {"draw": 2, "mode": 1}))


def compare_scaled(tag, res, one, strict):
    """Print a mesh run's decisions and stage values beside one device's.
    Every run holds phase 9's gates (stable share >= 0.7, a finite mean,
    train error < 2). ``strict`` also holds the stated tolerances of a run
    whose sums over ranks are one device's (world 1): singular values to
    1e-4 of the largest, hyperparameters to 1e-3 in their logarithm, the
    grid's rejections and argmin, lambda within the grid bracket of one
    device's best, the stable share within 0.02. Where ranks sum the
    float32 POD's products, the GP fits' flat optima and the search may
    carry the roundoff further: printed, not held."""
    from gp_bayesopinf_torch.pipeline.scaled.search import REJECTED

    sv, sv1 = res["svdvals"], one["svdvals"]
    dsv = float(np.abs(sv - sv1).max() / sv1[0])
    dhyp = float(np.abs(np.log(res["hyperparameters"] / one["hyperparameters"])).max())
    dmean = float(np.linalg.norm(res["ensemble_mean"] - one["ensemble_mean"])
                  / np.linalg.norm(one["ensemble_mean"]))
    same = {k: bool(np.array_equal(res[k], one[k])) for k in
            ("svdvals", "hyperparameters", "grid_errors", "ensemble_mean")}
    print(f"[mesh] {tag}: lambda {res['regularizer']:.6e} (one device {one['regularizer']:.6e}), "
          f"stable fraction {res['stable_fraction']:.4f} ({one['stable_fraction']:.4f}), train "
          f"error {res['train_error']:.5f} ({one['train_error']:.5f}); singular values within "
          f"{dsv:.2e} of the largest, log hyperparameters within {dhyp:.2e}, ensemble mean "
          f"{dmean:.2e} relative; equal to the bit: {same}", flush=True)
    assert res["stable_fraction"] >= 0.7 and res["train_error"] < 2.0
    assert np.isfinite(res["ensemble_mean"]).all()
    if not strict:
        return
    errs, errs1 = res["grid_errors"], one["grid_errors"]
    assert np.array_equal(errs >= REJECTED, errs1 >= REJECTED), (errs, errs1)
    ibest = int(np.argmin(errs1))
    assert int(np.argmin(errs)) == ibest, (errs, errs1)
    grid = np.logspace(-12, 6, len(errs1))
    lo, hi = grid[max(ibest - 1, 0)], grid[min(ibest + 1, len(grid) - 1)]
    assert lo <= res["regularizer"] <= hi, (res["regularizer"], lo, hi)
    assert abs(res["stable_fraction"] - one["stable_fraction"]) <= 0.02
    assert dsv < 1e-4 and dhyp < 1e-3, (dsv, dhyp)


def mesh_phase(search, scaled_res):
    """Phase ``mesh``: the multi-device layer on the card. (a) one rank on
    cuda:0 through NCCL runs ``run_scaled`` at its defaults on {"draw": 1,
    "mode": 1} beside phase 9's one-device run; (b) two ranks share cuda:0
    through gloo (NCCL takes one rank a card): the ex1a search on {"draw":
    2} through kernel A, grid errors and lambda equal to the one-device
    search's to the bit and each rank's kernel A launches beside the
    one-device search's, then ``run_scaled`` at its defaults on {"draw": 2,
    "mode": 1}; (c) ``scaled --devices 1`` through the command line, one
    JSON line. Returns the kernel A launches of (b)'s ranks."""
    from gp_bayesopinf_torch.bayes import auto_regularize
    from gp_bayesopinf_torch.parallel import spawn

    one = scaled_digest(scaled_res)
    t0 = time.perf_counter()
    (a,) = spawn(mesh_scaled_rank, 1, ["cuda:0"], args=({"draw": 1, "mode": 1},), timeout=600)
    print(f"[mesh] (a) one rank on cuda:{a['card']}, backend {a['backend']}: spawn and run "
          f"{time.perf_counter() - t0:.2f} s, run_scaled {a['wall']:.2f} s ({a['collectives']} "
          f"collectives, {a['collective_seconds']:.3f} s); stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in a["stages"].items()), flush=True)
    compare_scaled("(a) world 1 against one device", a, one, strict=True)
    tally_4c(a["phase_4c"])

    args, kw = search_args(search)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = auto_regularize(*args, **kw)
    torch.cuda.synchronize()
    wall1, launches1 = time.perf_counter() - t0, read_launches()["quadratic_ensemble_screen"]
    tally_4c()
    t0 = time.perf_counter()
    pair = spawn(mesh_pair_rank, 2, ["cuda:0", "cuda:0"], backend="gloo", args=(search,),
                 timeout=900)
    print(f"[mesh] (b) two ranks share cuda:0 through backend {pair[0]['scaled']['backend']} "
          f"(NCCL takes one rank a card): spawn and run {time.perf_counter() - t0:.2f} s",
          flush=True)
    for rank, out in enumerate(pair):
        srch = out["search"]
        print(f"[mesh] (b) rank {rank}: ex1a search {srch['wall']:.3f} s (one device "
              f"{wall1:.3f} s), kernel A launches {srch['launches']} (one device {launches1}; by "
              f"family {srch['families']}), lambda {srch['regularizer']:.6e} (one device "
              f"{res1.regularizer:.6e})", flush=True)
        assert np.array_equal(srch["grid_errors"], res1.grid_errors), "grid errors differ"
        assert srch["regularizer"] == res1.regularizer and srch["refined"] == res1.refined
        assert 0 < srch["launches"] < launches1
        tally_4c(srch["phase_4c"])
        tally_4c(out["scaled"]["phase_4c"])
    print(f"[mesh] (b) the {len(res1.grid_errors)}-point grid's errors and lambda equal one "
          f"device's to the bit on both ranks ({int((res1.grid_errors < 1e12).sum())} candidates "
          "accepted)", flush=True)
    for rank, out in enumerate(pair):
        sc = out["scaled"]
        print(f"[mesh] (b) rank {rank}: run_scaled on {{'draw': 2, 'mode': 1}} {sc['wall']:.2f} s "
              f"(one device {sum(one['stages'].values()):.2f} s of stages), "
              f"{sc['collectives']} collectives {sc['collective_seconds']:.3f} s; stages (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sc["stages"].items()), flush=True)
        assert sc["regularizer"] == pair[0]["scaled"]["regularizer"]
        assert np.array_equal(sc["ensemble_mean"], pair[0]["scaled"]["ensemble_mean"])
    compare_scaled("(b) world 2 against one device", pair[0]["scaled"], one, strict=False)

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    # (c)'s launches are not read: its rank runs in a grandchild process.
    # (a) runs the same run_scaled on a mesh, and is counted.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gp_bayesopinf_torch.pipeline.cli"] + MESH_CLI,
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"scaled --devices 1 exited {proc.returncode}:\n" \
        f"{proc.stderr[-4000:]}"
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    summary = json.loads(lines[0])
    print(f"[mesh] (c) {' '.join(MESH_CLI)}: {time.perf_counter() - t0:.2f} s, {lines[0]}",
          flush=True)
    assert summary["regularizer"] > 0 and summary["stable_fraction"] >= 0.7
    return sum(out["search"]["launches"] for out in pair)


def load_script(rel):
    """A script of the checkout (``examples/``, ``scripts/``) as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class ReplayUniforms:
    """Stands in for a NumPy ``Generator``: hands the host noise twin the
    uniforms the device drew."""

    def __init__(self, u):
        self.u = u

    def uniform(self, size):
        assert tuple(size) == self.u.shape
        return self.u


def examples_phase(ex1a_res):
    """Phase ``examples``: the port's demos, studies and notebooks' model
    cells on the card; returns kernel A's launches in its runs."""
    from gp_bayesopinf_torch.models.heat import CubicHeatBimodal
    from gp_bayesopinf_torch.models.seird import SEIRD2, _truncnorm_noise_np
    from gp_bayesopinf_torch.pipeline.odes import ensemble_error

    kernel = "quadratic_ensemble_screen"
    out = Path(__file__).resolve().parent / "build" / "chip_smoke" / "examples"
    shutil.rmtree(out, ignore_errors=True)
    try:
        import matplotlib  # noqa: F401
        import h5py  # noqa: F401  (the port's viz needs both)
        figures = True
    except ImportError:
        figures = False
    print("[examples] figures: " + (f"matplotlib and h5py present, drawn into {out}" if figures
                                    else "matplotlib or h5py missing here, none drawn"),
          flush=True)

    # (a) The SEIRD demo at --full, with its crosscheck; phase 7's gates.
    demo = load_script("examples/torch_seird_demo.py")
    res, wall, seird_launches, evals = call_counted(
        lambda: demo.compute(True, device="cuda", verbose=False), kernel)
    n_valid, n_new, nd = int(res.valid.sum()), int(res.newic_valid.sum()), len(res.valid)
    err, err_new = ensemble_error(res), ensemble_error(res, newic=True)
    print(f"[examples] SEIRD demo --full: wall {wall:.2f} s, lambda {res.regularizer:.6e}, "
          f"valid {n_valid}/{nd}, {n_new}/{nd} from the new initial conditions; errors {err:.4f}, "
          f"new {err_new:.4f}; kernel A launches {seird_launches} in {evals} objective "
          "evaluations; crosscheck " + ", ".join(
              f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
              for k, v in res.crosscheck.items()),
          flush=True)
    assert seird_launches >= 4 and seird_launches == 2 * evals, (seird_launches, evals)
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 420 and n_new >= 420, (n_valid, n_new)
    assert bool(torch.isfinite(res.draws[res.valid]).all())
    assert bool(torch.isfinite(res.newic_draws[res.newic_valid]).all())
    assert err < 0.5 and err_new < 0.5, (err, err_new)
    np.testing.assert_allclose(res.bayesian_model.mean.tolist(), list(res.model.parameters),
                               rtol=0.5)
    printed = demo.report(res, str(out / "seird"), figures=figures)
    assert math.isclose(printed, err, rel_tol=1e-12), (printed, err)
    del res

    # (b) The Euler demo's report on phase 5's result, its error against
    # ensemble_error's formula restricted to the training span.
    edemo = load_script("examples/torch_euler_demo.py")
    printed = edemo.report(ex1a_res, str(out / "euler"), figures=figures)
    inside = torch.as_tensor(ex1a_res.time_domain <= ex1a_res.t_estimation[-1], device="cuda")
    truth = ex1a_res.basis.compress(ex1a_res.true_states)[:, inside]
    valid = ex1a_res.valid
    mean = ex1a_res.draws_compressed[valid].sum(dim=0)[:, inside] / max(int(valid.sum()), 1)
    independent = float(torch.linalg.norm(mean - truth) / torch.linalg.norm(truth))
    print(f"[examples] Euler demo on phase 5's run: training-domain error {printed!r} against "
          f"{independent!r} computed on the card", flush=True)
    assert math.isclose(printed, independent, rel_tol=1e-12), (printed, independent)

    # (c) The extrapolation study: domain_errors of phase 5's run, and ex2a.
    study = load_script("examples/torch_extrapolation_study.py")
    errs = study.domain_errors(ex1a_res, study.T_TRAIN)
    print("[examples] ex1a domain errors (all variables): " + ", ".join(
        f"{d} {errs[(d, 'all')]:.4f}" for d in study.DOMAINS), flush=True)
    assert all(math.isfinite(e) for e in errs.values())
    res, wall, ex2a_launches, evals = call_counted(
        lambda: study.run_workload("ex2a", device="cuda", verbose=False)[0], kernel)
    n_valid, nd = int(res.valid.sum()), int(res.valid.shape[0])
    errs = study.domain_errors(res, study.T_TRAIN)
    print(f"[examples] ex2a (50 samples, 1% noise, m' 400, r 6, {nd} draws): wall {wall:.2f} s, "
          f"lambda {res.regularizer:.6e}, valid {n_valid}/{nd}; errors (all variables) "
          + ", ".join(f"{d} {errs[(d, 'all')]:.4f}" for d in study.DOMAINS)
          + f"; kernel A launches {ex2a_launches} in {evals} objective evaluations", flush=True)
    assert ex2a_launches >= 12 and ex2a_launches == 2 * evals, (ex2a_launches, evals)
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 0.7 * nd, f"only {n_valid}/{nd} draws valid"
    assert all(math.isfinite(e) for e in errs.values()), errs
    del res

    # (d) Three rungs of the stability ladder on phase 5's factorization.
    stab = load_script("scripts/torch_ex1a_stability_study.py")
    ladder = stab.Ladder.from_result(ex1a_res)
    t0 = time.perf_counter()
    for j, lam in enumerate((ex1a_res.regularizer, 1e-2, 1e-1)):
        n_final, n_screen, p20, rung_err = stab.rung(
            ladder, lam, 600, generator=stab.rung_generator(j, "cuda"))
        print(f"[examples] ladder rung lambda {lam:.6e}: final {n_final}/600, screen "
              f"{n_screen}/600, P(20-draw screen) {p20:.3f}, error {rung_err:.4f}", flush=True)
        assert 0 <= n_screen <= 600 and 0 < n_final <= 600 and math.isfinite(rung_err)
    print(f"[examples] three rungs: {time.perf_counter() - t0:.2f} s", flush=True)

    # (e) The notebooks' model cells on the card against the host twins,
    # float64: SEIRD2.solve and noise, CubicHeatBimodal.solve (the
    # notebook's coarse grid).
    seird = SEIRD2(parameters=tuple(
        SEIRD2.convert_parameters((1.0, 0.25, 0.1, 0.1, 0.05, 0.05)).tolist()))
    t = np.linspace(0, 200, 500)
    q0 = [0.994, 0.005, 0.001, 0.0, 0.0]
    t0 = time.perf_counter()
    solution = seird.solve(torch.tensor(q0, dtype=torch.float64, device="cuda"),
                           torch.as_tensor(t, device="cuda"), strict=True)
    host = seird.solve_host(np.array(q0), t)
    np.testing.assert_allclose(solution.cpu().numpy(), host, rtol=1e-10, atol=0)
    noisy = seird.noise(solution, 0.1, generator=torch.Generator(device="cuda").manual_seed(0))
    u = torch.rand(solution.shape, generator=torch.Generator(device="cuda").manual_seed(0),
                   dtype=torch.float64, device="cuda")
    assert torch.equal(noisy, seird.noise(solution, 0.1, u=u))
    noisy_host = _truncnorm_noise_np(ReplayUniforms(u.cpu().numpy()), host, 0.1)
    np.testing.assert_allclose(noisy.cpu().numpy(), noisy_host, rtol=1e-10, atol=0)
    assert float(noisy.min()) >= 0.0 and float(noisy.max()) <= 1.0
    seird_s = time.perf_counter() - t0
    xc, tc = np.linspace(0, 1, 41), np.linspace(0, 2, 41)
    heat = CubicHeatBimodal(xc, 0.0, 1.0, diffusion=5e-3, a=1.0, b=1.0)
    qc0 = xc * (1 - xc) + xc
    t0 = time.perf_counter()
    on_card = heat.solve(torch.as_tensor(qc0, device="cuda"), tc)
    torch.cuda.synchronize()
    heat_s = time.perf_counter() - t0
    heat_host = heat.solve_host(qc0, tc)
    np.testing.assert_allclose(on_card.cpu().numpy(), heat_host, rtol=1e-10, atol=0)

    def dev(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    print(f"[examples] notebooks on the card against the host, float64 (rtol 1e-10): SEIRD2.solve "
          f"(5, 500) {dev(solution.cpu().numpy(), host):.1e}, noise {dev(noisy.cpu().numpy(), noisy_host):.1e} "
          f"({seird_s:.2f} s); CubicHeatBimodal.solve (41, 41) {dev(on_card.cpu().numpy(), heat_host):.1e} "
          f"({heat_s:.2f} s)", flush=True)
    print(f"[examples] kernel A launches: SEIRD demo {seird_launches}, ex2a {ex2a_launches}",
          flush=True)
    return seird_launches + ex2a_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gp_bayesopinf_torch.ops.build import build
    from gp_bayesopinf_torch.utils.reporting import card_line

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)

    names = ("quadratic_screen", "cahbn_screen", "euler_truth")
    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(build, names)))
    print(f"[build] all in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in infos.items():
        print(f"[build] {info.path.name} in {info.seconds:.1f} s", flush=True)
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    def phase(label, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {label}: {time.perf_counter() - t1:.1f} s", flush=True)
        return out

    fields = {"quadratic_ensemble_screen": phase("kernel A", kernel_phase)}
    wide_a = phase("kernel A, capacity", capacity_a_phase)
    fields["cahbn_ensemble_screen"] = phase("kernel B", cahbn_phase)
    wide_b = phase("kernel B, capacity", capacity_b_phase)
    wide = phase("kernels A and B, wide and runtime", wide_phase_4c)
    truth = phase("euler truth", euler_truth_phase)
    dirk2, dirk2_ptxas = phase("fused SDIRK2", dirk2_phase)
    fields["quadratic_ensemble_screen"]["launches"], ex1a_search, ex1a_res, truth_launches = \
        phase("ex1a", pipeline_phase)
    fields["cahbn_ensemble_screen"]["launches"], dirk2_launches = phase("ex3", heat_phase)
    # Kernel A carries several main paths: its launches are those of all runs.
    seird_launches, seird_res = phase("seird", seird_phase)
    by_path = {"ex1a": fields["quadratic_ensemble_screen"]["launches"], "seird": seird_launches,
               "ex1c": phase("ex1c", ex1c_phase)}
    # The capacity-templated kernels' main paths: the two searches above the
    # templated instances.
    wide_launches = {"quadratic_ensemble_screen": phase(
        "euler r=16", wide_phase, EULER16, "quadratic_ensemble_screen", 16)}
    wide_launches["cahbn_ensemble_screen"] = phase(
        "heat r=9", wide_phase, HEAT9, "cahbn_ensemble_screen", 9)
    _, scaled_res = phase("scaled", scaled_phase)
    by_path["mesh"] = phase("mesh", mesh_phase, ex1a_search, scaled_res)
    del ex1a_search, scaled_res
    phase("scaled, 4 windows", windowed_phase)
    phase("scaled, 8 local windows", local_phase)
    by_path["serve"] = phase("serve", serve_phase, seird_res, seird_launches)
    del seird_res
    phase("checkpoint", checkpoint_phase)
    by_path["examples"] = phase("examples", examples_phase, ex1a_res)
    del ex1a_res
    fields["quadratic_ensemble_screen"].update(
        launches=sum(by_path.values()), launches_by_path=by_path)

    print(f"[total] {time.perf_counter() - t_start:.1f} s after the card check", flush=True)

    def entry(name, f, **more):
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": f["launches"], "max_abs_err": f["max_abs_err"], "ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
                "library_ms": None, **more}

    A, B = fields["quadratic_ensemble_screen"], fields["cahbn_ensemble_screen"]
    kernels = [
        entry("quadratic_ensemble_screen", A, shape="ex1a: G 16, nd 20, r 6, k 400, error term",
              launches_by_path=by_path, seird=A["seird"]),
        entry("cahbn_ensemble_screen", B, shape="ex3: G 16, nd 20, r 5, nu 2, k 80, error term"),
        # The same kernel at the ex1c estimation grid, with that run's launches.
        entry("quadratic_ensemble_screen", dict(A["ex1c"], launches=by_path["ex1c"]),
              shape="ex1c: G 16, nd 20, r 6, k 3200, error term"),
    ]
    # The capacity-templated kernels, each shape with the launches of its
    # family's main path (euler ... 400 16 for A, heat ... 80 9 for B) and
    # PR 7's runtime-dimension kernel timed in turns beside it (runtime_ms).
    launches_a, launches_b = (wide_launches[k] for k in KERNELS)

    def extra(f):
        return {n: v for n, v in f.items() if n not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                        "max_abs_err", "launches")}

    kernels += [entry("quadratic_ensemble_screen", dict(f, launches=launches_a),
                      family="capacity", shape=f"G 16, nd 20, r {r}, k 400, error term",
                      launches_path="euler 0.06 200 0.03 400 16, at r 16", **extra(f))
                for r, f in wide_a.items()]
    kernels += [entry("cahbn_ensemble_screen", dict(f, launches=launches_b),
                      family="capacity", shape=f"G 16, nd 20, r {r}, nu {nu}, k 80, error term",
                      launches_path="heat 1.0 20 0.05 80 9, at r 9 and nu 2", **extra(f))
                for (r, nu), f in wide_b.items()]
    # Phase 4c's shapes: the runtime-dimension kernels and the wide
    # kernels, with their launches summed over every main-path run: no main
    # path screens above r 32 (A) or r 16 / nu 4 (B).
    print(f"[wide and runtime kernels] launches on the main paths: {MAIN_PATH_4C}", flush=True)
    assert not any(n for by_family in MAIN_PATH_4C.values() for n in by_family.values()), \
        MAIN_PATH_4C
    none = "none: no main path screens above r 32 (A) or r 16 / nu 4 (B)"
    names = {"A": "quadratic_ensemble_screen", "B": "cahbn_ensemble_screen"}
    for family in ("runtime", "wide"):
        kernels += [entry(names[label[0]],
                          dict(f[family], launches=MAIN_PATH_4C[names[label[0]]][family]),
                          family=family, launches_path=none, **extra(f[family]))
                    for label, f in wide.items()]
    # The fused Euler truth solve replaces no TPU kernel: the JAX package's
    # truth solve is a lax.scan that XLA fuses. Phase 5 counts the ex1a
    # run's launches, its two shapes' together; no main path runs the
    # scaled source's widths.
    kernels += [{"name": "euler_rk4_wide" if f["nx"] > 2048 else "euler_rk4", "route": "cuda",
                 "source": "gp_bayesopinf_torch/csrc/euler_truth.cu", "replaces": None,
                 "launches": truth_launches if name.startswith("ex1a") else 0,
                 "launches_path": ("ex1a: its prediction and sample solves together"
                                   if name.startswith("ex1a") else
                                   "none: only scaled --source euler runs this width"),
                 "shape": name, "ms": f["ms"], "loop_ms": f["loop_ms"], "steps": f["steps"]}
                for name, f in truth.items()]
    # The fused SDIRK2 integration replaces no TPU kernel either (the JAX
    # package's ensemble is dirk2_solve's lax.scan); phase 6 counts the ex3
    # run's launches, one an ensemble.
    kernels += [{"name": "cahbn_dirk2", "route": "cuda",
                 "source": "gp_bayesopinf_torch/csrc/cahbn_screen.cu", "replaces": None,
                 "launches": dirk2_launches, "launches_path": "ex3: its two ensembles together",
                 "shape": name, "ms": f["ms"], "loop_ms": f["loop_ms"], "gap": f["gap"],
                 **dirk2_ptxas}
                for name, f in dirk2.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
