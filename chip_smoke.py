"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each failing loudly (an uncaught exception exits non-zero):

1. require CUDA; print the card's name and power limit; turn TF32 off;
2. build the ensemble-screen kernel from ``gp_bayesopinf_torch/csrc``;
3. hold the kernel against its plain PyTorch version on the card at the
   Euler ex1a screen shapes (G = 16 candidates, nd = 20 draws, r = 6,
   d = 28, 8 RK4 substeps; k = 401 without the error term, k = 400 with
   it), with a diverging candidate, an envelope-rejected candidate, a NaN
   draw, and a run with nd = 7; time both with CUDA events;
4. run the full ex1a workload through the port's CLI entry
   (``euler 0.06 200 0.03 400 6 --ndraws 600`` on ``cuda``) and check
   that the grid search went through the kernel and that the posterior
   ensemble is sound.

The last two lines of standard output are a JSON summary of the kernels
and a JSON status line.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SOURCE = "gp_bayesopinf_torch/csrc/quadratic_screen.cu"
REPLACES = "gp_bayesopinf_tpu/ops/ensemble_pallas.py:177"
EX1A = ["euler", "0.06", "200", "0.03", "400", "6", "--ndraws", "600", "--device", "cuda"]


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


def kernel_phase():
    """Phase 3; returns (max_abs_err, kernel ms, plain ms) of the k = 400
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
            times = (ms, plain_ms)
            print(f"[kernel vs plain] k=400 with error: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms (CUDA events)", flush=True)
    return max_err, times[0], times[1]


def pipeline_phase():
    """Phase 4; returns the kernel launches of the run."""
    from gp_bayesopinf_torch.ops import ensemble_screen as es
    from gp_bayesopinf_torch.pipeline import cli, ensemble_error

    es.launches = 0
    t0 = time.perf_counter()
    res = cli.run(EX1A)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = es.launches

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gp_bayesopinf_torch.ops.build import build

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)

    info = build("quadratic_screen")
    print(f"[build] {info.path.name} in {info.seconds:.1f} s", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    max_err, ms, plain_ms = kernel_phase()
    launches = pipeline_phase()

    print(json.dumps({"kernels": [{
        "name": "quadratic_ensemble_screen", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
