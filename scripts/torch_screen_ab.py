"""The screen kernels of this checkout against those of another checkout
(for example the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists), or two kernel families of this
checkout against each other, timed on one CUDA card in turns.

    python3 scripts/torch_screen_ab.py --other build/parent [--reps 5]
    python3 scripts/torch_screen_ab.py --family wide --other-family runtime

Each side runs in a process of its own, since two checkouts' packages
share a name, in the order other, this, this, other. Without ``--other``
both sides are this checkout. ``--family`` (this side) and
``--other-family`` force a kernel family (``"wide"``, ``"runtime"``, ...)
on the cases above the templated instances, where the side's wrappers
take ``family=`` and the family takes the shape; without them each
wrapper chooses. Each process builds its two
kernels and times them with CUDA events at the shapes of PERF.md's
kernel table: kernel A (RK4 "cAH") at the Euler ex1a screen shapes (G =
16, nd = 20, r = 6, 8 substeps, k = 400 with the error term), kernel B
(SDIRK2 "cAHBN") at the heat ex3 ones (G = 16, nd = 20, r = 5, nu = 2, 4
substeps, 6 Newton steps; k = 80 with the error term and k = 500 without)
and, where the version's wrappers take several problems at once, the
same with L = 2 (A) and L = 5 (B) problems in one call; then the state
dimensions above the templated instances, where the version's wrappers
take them: kernel A at r = 13, 16 and 24 (k = 400 with the error term),
kernel B at (r, nu) = (9, 2), (12, 2) and (6, 3) (k = 80 with the error
term) and at (9, 2) with k = 500, no error term and L = 5 (the heat
search's other grid); and above the capacity kernels, where the wide
kernels take the wrappers' choice: kernel A at r = 40 and 64 (k = 400),
kernel B at (20, 2) and (6, 5) (k = 80), each with the error term.
Inputs are made from a seed; every draw decays, so no draw takes a
kernel's slow paths.
Each process prints one JSON line: the card, the version, the family it
forced and the milliseconds per call of each case.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def worker(root: str, reps: int, family=None) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from gp_bayesopinf_torch.ops import cahbn_screen as cs
    from gp_bayesopinf_torch.ops import ensemble_screen as es
    from gp_bayesopinf_torch.ops.build import build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for name in ("quadratic_screen", "cahbn_screen"):
        build(name)
    rng = np.random.default_rng(20261016)
    dev, f32 = "cuda", torch.float32

    def t(x):
        return torch.as_tensor(x, dtype=f32, device=dev).contiguous()

    def operators(r, d, N):
        Ohat = 0.3 * rng.standard_normal((N, r, d))
        Ohat[:, :, 1 : 1 + r] += -20.0 * np.eye(r)
        Ohat[:, :, 1 + r :] *= 0.1
        return t(Ohat)

    def per_problem(L, make):
        return make() if L == 0 else torch.stack([make() for _ in range(L)])

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    times = {}
    r, G, nd = 6, 16, 20
    OA = operators(r, 1 + r + r * (r + 1) // 2, G * nd)
    tA = t(np.linspace(0.0, 0.06, 400))
    for L in (0, 2):
        args = (OA, per_problem(L, lambda: t(0.5 * rng.standard_normal(r))), tA,
                per_problem(L, lambda: t(np.zeros(r))), per_problem(L, lambda: t(np.full(r, 10.0))),
                per_problem(L, lambda: t(0.2 * rng.standard_normal((r, 400)))))
        try:
            times[f"A k=400 L={L or 1}"] = ms(
                lambda: es.quadratic_ensemble_screen_cuda(*args, nd=nd, substeps=8))
        except ValueError:  # this version takes one problem a call
            pass

    r, nu = 5, 2
    OB = operators(r, 1 + r + r * (r + 1) // 2 + nu + nu * r, G * nd)
    for k, t_max, track in ((80, 1.0, True), (500, 2.0, False)):
        t64 = torch.linspace(0.0, t_max, k, dtype=torch.float64, device=dev)
        ts = cs.input_stage_times(t64, 4)

        def inputs():
            a, b = rng.uniform(-2.0, 2.0, 2)
            return t(torch.stack([a * torch.sin(2 * np.pi * ts), b * torch.sin(4 * np.pi * ts)], -1))

        for L in (0, 5):
            args = (OB, per_problem(L, lambda: t(0.5 * rng.standard_normal(r))), t(t64),
                    per_problem(L, lambda: t(np.zeros(r))), per_problem(L, lambda: t(np.full(r, 10.0))),
                    per_problem(L, inputs),
                    per_problem(L, lambda: t(0.2 * rng.standard_normal((r, k)))) if track else None)
            try:
                times[f"B k={k} L={L or 1}"] = ms(lambda: cs.cahbn_ensemble_screen_cuda(
                    *args, nd=nd, substeps=4, newton_iters=6, track_error=track))
            except ValueError:
                pass
    forced = {} if family is None else {"family": family}
    # Above the templated instances (a version without them raises, and one
    # without ``family=`` or a family that does not take the shape too).
    for r in (13, 16, 24, 40, 64):
        d = 1 + r + r * (r + 1) // 2
        args = (operators(r, d, G * nd), t(0.5 * rng.standard_normal(r)), tA, t(np.zeros(r)),
                t(np.full(r, 10.0)), t(0.2 * rng.standard_normal((r, 400))))
        try:
            times[f"A r={r} k=400"] = ms(lambda: es.quadratic_ensemble_screen_cuda(
                *args, nd=nd, substeps=8, **forced))
        except (ValueError, TypeError):
            pass
    for r, nu, k, t_max, L in ((9, 2, 80, 1.0, 0), (12, 2, 80, 1.0, 0), (6, 3, 80, 1.0, 0),
                               (9, 2, 500, 2.0, 5), (20, 2, 80, 1.0, 0),
                               (6, 5, 80, 1.0, 0)):
        t64 = torch.linspace(0.0, t_max, k, dtype=torch.float64, device=dev)
        ts = cs.input_stage_times(t64, 4)

        def inputs():
            amp = rng.uniform(-2.0, 2.0, max(3, nu))
            return t(torch.stack([amp[c] * torch.sin(2 * np.pi * (c + 1) * ts)
                                  for c in range(nu)], -1))

        track = k == 80
        d = 1 + r + r * (r + 1) // 2 + nu + nu * r
        args = (operators(r, d, G * nd), per_problem(L, lambda: t(0.5 * rng.standard_normal(r))),
                t(t64), per_problem(L, lambda: t(np.zeros(r))),
                per_problem(L, lambda: t(np.full(r, 10.0))), per_problem(L, inputs),
                per_problem(L, lambda: t(0.2 * rng.standard_normal((r, k)))) if track else None)
        try:
            times[f"B r={r} nu={nu} k={k} L={L or 1}"] = ms(lambda: cs.cahbn_ensemble_screen_cuda(
                *args, nd=nd, substeps=4, newton_iters=6, track_error=track, **forced))
        except (ValueError, TypeError):
            pass
    print(json.dumps({"card": card(), "version": root, "family": family, "ms": times}),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--other", help="root of the checkout to compare with (default: this)")
    parser.add_argument("--family", help="kernel family this side forces above the templated "
                                         "instances (default: the wrappers' choice)")
    parser.add_argument("--other-family", help="the family the other side forces")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.worker, args.reps, args.family)
        return 0
    if args.other is None and args.family == args.other_family:
        parser.error("give --other, or two different families")
    other = (os.path.abspath(args.other) if args.other else REPO, args.other_family)
    this = (REPO, args.family)
    for root, family in (other, this, this, other):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                        "--reps", str(args.reps)] + (["--family", family] if family else []),
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
