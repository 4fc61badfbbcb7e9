"""Readings that the check's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --data-seeds 11 12 ... [--control 11 12 13]
                                   [--runs-through N]

For each data seed in turn, one experiment of the cell as the window runs
it; then every compared number of the program against the float64
reference (the lower readings). For the seeds given to ``--control``,
also the reference computed in the next lower precision in the program's
place against it (float32 for the float64 stages and bfloat16 for the
float32 screen: the upper readings), and ``gp_fit`` of two planted fits
that stop short: the program's fit without its Adam descent and Newton
polish (the best of its starts), and its first guess alone. With
``--runs-through N`` it stops once N experiments have run through, and
an experiment whose search raises is reported and passed over: how the
traffic's pool of data seeds is chosen. One JSON line per seed and side
on standard output; the program's set-up is paid once.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

CONTROL = {"float": np.float32, "screen": torch.bfloat16}


def short_fits(seed: int, obs: dict, config: dict, device) -> dict:
    """``gp_fit`` of the program's fit stopped short, on the experiment's
    own compressed snapshots and starts: {"no descent": ..., "first
    guess": ...}."""
    from gp_bayesopinf_torch.gp.fit import fit_gp_hyperparameters
    from gp_bayesopinf_torch.gp.nlml import BoxTransform

    from benchmark.reference import common, experiment

    b = config["config"]["gp_bounds"]
    comp = obs["compressed"]
    L, r, m = comp.shape
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.as_tensor(obs["t_sampled"], **f64)
    Y = torch.as_tensor(comp.reshape(L * r, m), **f64)
    box = BoxTransform.from_bounds(b["constant"], b["length_scale"], b["noise_level"], **f64)
    bounds = [b[k] for k in ("constant", "length_scale", "noise_level")]
    starts = common.fit_starts(common.stage_streams(seed, common.STREAMS, device)["fit"], L * r,
                               b["n_restarts"], bounds, device).reshape(L, r, -1, 3)
    out = {}
    for name, restarts in (("no descent", b["n_restarts"]), ("first guess", 0)):
        gen = common.stage_streams(seed, common.STREAMS, device)["fit"]
        fit = fit_gp_hyperparameters(t, Y, box, gen, n_restarts=restarts, adam_steps=0,
                                     polish_iters=0)
        theta = torch.stack([fit.sigma2, fit.ell, fit.chi], 1).cpu().numpy().reshape(L, r, 3)
        out[name] = float(np.max(experiment.fit_gaps(obs["t_sampled"], comp, b, theta, starts)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--data-seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--runs-through", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import drive, judge, measure, spec

    cell = spec.Cell(spec.load(ROOT), args.workload, ROOT, ROOT / "benchmark")
    run, _ = measure.set_up(cell, args.device)
    cache, through = {}, 0
    for s in args.data_seeds:
        if args.runs_through and through >= args.runs_through:
            break
        pick = drive.pick_for(s, cell.check)
        with drive.Instruments(run.config, run.runner_module) as inst:
            try:
                wall, res = run.experiment(s, inst)
            except Exception as exc:  # passed over: the pool holds seeds that run through
                print(json.dumps({"experiment_seed": s, "raised": repr(exc)}), flush=True)
                continue
            capture = dict(inst.capture)
        through += 1
        obs = run.observe(res, capture, pick)
        stages = res.stage_seconds
        del res
        t0 = time.perf_counter()
        control = s in args.control
        sides = run.judge_sides(s, obs, cache, [CONTROL] if control else [])
        ref_s = time.perf_counter() - t0
        faults = short_fits(s, obs, cell.config, args.device) if control else {}
        for side, values in zip(("program", "control"), sides):
            ok, _ = judge.verdict(values, cell.check["limits"])
            print(json.dumps({"experiment_seed": s, "side": side, "wall_s": wall,
                              "stage_seconds": stages, "reference_s": ref_s,
                              "lambda": obs["lam"], "refined": obs["refined"], "within": ok,
                              "numbers": {k: measure._num(v) for k, v in values.items()},
                              **({"gp_fit_short": faults} if side == "control" else {})}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
