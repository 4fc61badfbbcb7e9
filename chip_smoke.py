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
   candidate, a NaN draw, and a run with nd = 7; time both with CUDA
   events;
4. the same for kernel B (SDIRK2 "cAHBN" screen) at the heat ex3 screen
   shapes (G = 16, r = 5, nu = 2, d = 33, 4 substeps, 6 Newton steps,
   the ex3 input family): k = 80 with the error term, k = 120 over [0, 2]
   without it, and nd = 7; the kernel is also timed at the full
   prediction grid, k = 500;
5. run the full ex1a workload through the port's CLI entry
   (``euler 0.06 200 0.03 400 6 --ndraws 600`` on ``cuda``) and check
   that the grid search went through kernel A and that the posterior
   ensemble is sound;
6. run the full heat ex3 workload (``heat 1.0 20 0.05 80 5 --ndraws
   600``) and check that its search went through kernel B and that every
   trajectory's ensemble is sound.

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
    cases = [(16, 20, 401, 0.15, False), (16, 20, 400, 0.06, True), (16, 7, 400, 0.06, True)]
    for G, nd, k, t_max, track in cases:
        a = screen_case(G, nd, k, t_max, rng, track)
        f = {n: None if v is None else v.to(f32).contiguous() for n, v in a.items()}
        kw = dict(nd=nd, substeps=8, track_error=track)
        s_k, e_k = es.quadratic_ensemble_screen(*a.values(), **kw)
        torch.cuda.synchronize()
        s_p, e_p, maxdev = es._plain(*f.values(), nd, 8, track)
        # Every draw must sit clear of its limit, so the flags are decided
        # by construction, not by the last bits.
        lim = f["limits"][None, :]
        clear = ~torch.isfinite(maxdev) | ((maxdev - lim).abs() > 1e-3 * lim)
        assert bool(clear.all()), "a draw's maxdev lies within 1e-3 of its limit"
        assert torch.equal(s_k, s_p), f"flags differ: {torch.nonzero(s_k != s_p).flatten()}"
        assert not bool(s_k[3]), "the NaN draw came out stable"
        by_cand = s_p.reshape(G, nd).all(dim=1)
        assert not bool(by_cand[-1]) and not bool(by_cand[-2]) and bool(by_cand[1:-2].all())
        if track:
            ok = by_cand & torch.isfinite(e_p)
            assert int(ok.sum()) >= G - 3
            torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)
            max_err = max(max_err, float((e_k[ok] - e_p[ok]).abs().max()))
        else:
            assert bool((e_k == 0).all())
        print(f"[kernel vs plain] G={G} nd={nd} k={k} track_error={track}: "
              f"flags identical ({int(s_k.sum())}/{s_k.numel()} stable)", flush=True)
        if (G, nd, k) == (16, 20, 400):
            ms = cuda_ms(lambda: es.quadratic_ensemble_screen_cuda(*f.values(), **kw), 10)
            plain_ms = cuda_ms(lambda: es._plain(*f.values(), nd, 8, track), 2)
            bound, by = bound_ms(quadratic_flops(G * nd, 6, k, 8),
                                 screen_bytes(f.values(), G * nd, G))
            times = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel vs plain] k=400 with error: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms (CUDA events), bound {bound:.4f} ms "
                  f"({by})", flush=True)
    return dict(max_abs_err=max_err, **times)


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

    rng = np.random.default_rng(20261016)
    f32 = torch.float32
    max_err, fields = 0.0, None
    cases = [(16, 20, 80, 1.0, True), (16, 20, 120, 2.0, False), (16, 7, 80, 1.0, True)]
    for G, nd, k, t_max, track in cases:
        a = cahbn_case(G, nd, k, t_max, rng, track)
        f = {n: None if v is None else v.to(f32).contiguous() for n, v in a.items()}
        kw = dict(nd=nd, substeps=4, newton_iters=6, track_error=track)
        s_k, e_k = cs.cahbn_ensemble_screen(*a.values(), **kw)
        torch.cuda.synchronize()
        s_p, e_p, maxdev = cs._plain(*f.values(), nd, 4, 6, track)
        lim = f["limits"][None, :]
        clear = ~torch.isfinite(maxdev) | ((maxdev - lim).abs() > 1e-3 * lim)
        assert bool(clear.all()), "a draw's maxdev lies within 1e-3 of its limit"
        assert torch.equal(s_k, s_p), f"flags differ: {torch.nonzero(s_k != s_p).flatten()}"
        assert not bool(s_k[3]), "the NaN draw came out stable"
        by_cand = s_p.reshape(G, nd).all(dim=1)
        assert not bool(by_cand[-1]) and not bool(by_cand[-2]) and bool(by_cand[1:-2].all())
        if track:
            ok = by_cand & torch.isfinite(e_p)
            assert int(ok.sum()) >= G - 3
            torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)
            max_err = max(max_err, float((e_k[ok] - e_p[ok]).abs().max()))
        else:
            assert bool((e_k == 0).all())
        print(f"[kernel B vs plain] G={G} nd={nd} k={k} track_error={track}: "
              f"flags identical ({int(s_k.sum())}/{s_k.numel()} stable)", flush=True)
        if (nd, k, track) == (20, 80, True):
            ms = cuda_ms(lambda: cs.cahbn_ensemble_screen_cuda(*f.values(), **kw), 10)
            plain_ms = cuda_ms(lambda: cs._plain(*f.values(), nd, 4, 6, track), 1)
            bound, by = bound_ms(cahbn_flops(G * nd, 5, 2, k, 4, 6),
                                 screen_bytes(f.values(), G * nd, G))
            fields = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"[kernel B vs plain] k=80 with error: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms (CUDA events), bound {bound:.4f} ms ({by})", flush=True)
    # The prediction grid of the ex3 search: k = 500 over [0, 2], no error.
    a = cahbn_case(16, 20, 500, 2.0, rng, False)
    f = {n: None if v is None else v.to(f32).contiguous() for n, v in a.items()}
    kw = dict(nd=20, substeps=4, newton_iters=6, track_error=False)
    ms = cuda_ms(lambda: cs.cahbn_ensemble_screen_cuda(*f.values(), **kw), 5)
    bound, by = bound_ms(cahbn_flops(320, 5, 2, 500, 4, 6), screen_bytes(f.values(), 320, 16))
    print(f"[kernel B] k=500 without error: kernel {ms:.3f} ms (CUDA events), "
          f"bound {bound:.4f} ms ({by})", flush=True)
    return dict(max_abs_err=max_err, **fields)


def reset_launches():
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    ensemble_screen.launches = cahbn_screen.launches = 0


def read_launches():
    from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen

    return {"quadratic_ensemble_screen": ensemble_screen.launches,
            "cahbn_ensemble_screen": cahbn_screen.launches}


def pipeline_phase():
    """Phase 5; returns the kernel A launches of the run."""
    from gp_bayesopinf_torch.pipeline import cli, ensemble_error

    reset_launches()
    t0 = time.perf_counter()
    res = cli.run(EX1A)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()["quadratic_ensemble_screen"]

    n_valid = int(res.valid.sum())
    err = ensemble_error(res)
    print(f"[ex1a] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex1a] lambda {res.regularizer:.6e}, "
          f"valid {n_valid}/600, ensemble-mean error vs compressed truth {err:.4f}, "
          f"kernel launches {launches}", flush=True)
    assert launches >= 12, f"only {launches} kernel launches in the ex1a run"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert n_valid >= 420, f"only {n_valid}/600 draws valid"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.draws).all())
    assert err < 0.5, f"ensemble-mean error {err:.4f}"
    return launches


def heat_phase():
    """Phase 6; returns the kernel B launches of the run."""
    from gp_bayesopinf_torch.pipeline import cli, ensemble_errors

    reset_launches()
    t0 = time.perf_counter()
    res = cli.run(EX3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()["cahbn_ensemble_screen"]

    n_valid = res.valid.sum(dim=1).tolist()
    errs, err_new = ensemble_errors(res)
    full, full_new = ensemble_errors(res, full_state=True)
    print(f"[ex3] wall {wall:.2f} s; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()), flush=True)
    print(f"[ex3] lambda {res.regularizer:.6e}, valid {n_valid} of 600 per trajectory, "
          f"{int(res.newparam_valid.sum())}/600 at the test parameters; kernel B "
          f"launches {launches}", flush=True)
    print(f"[ex3] ensemble-mean errors vs compressed truth {[round(e, 4) for e in errs]}, "
          f"test {err_new:.4f}; vs full-state truth {[round(e, 4) for e in full]}, "
          f"test {full_new:.4f}", flush=True)
    assert launches >= 60, f"only {launches} kernel B launches in the ex3 run"
    assert math.isfinite(res.regularizer) and res.regularizer > 0
    assert min(n_valid) >= 420, f"valid draws per trajectory {n_valid}"
    assert bool(torch.isfinite(res.draws_compressed[res.valid]).all())
    assert bool(torch.isfinite(res.newparam_draws[res.newparam_valid]).all())
    # 0.5, as the ex1a gate: the compressed error follows where the 20-draw
    # screen lets lambda land, 0.04-0.10 for lambda <= 1 and 0.31 at this
    # seed's lambda of 6.9 (PERF.md, section 6: the heat-multi entry).
    assert max(errs) < 0.5 and err_new < 0.5, f"ensemble-mean errors {errs}, {err_new}"
    return launches


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

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": f["launches"], "max_abs_err": f["max_abs_err"], "ms": f["ms"],
         "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
         "library_ms": None}
        for name, (source, replaces) in KERNELS.items()
        for f in [fields[name]]
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
