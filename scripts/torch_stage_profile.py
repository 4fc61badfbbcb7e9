"""Stage times, device-busy shares and accuracy of the PyTorch port's
flagship runs on one CUDA card.

    python3 scripts/torch_stage_profile.py heat [--seeds 29012024 1 2] [--profile] [--ladder]
    python3 scripts/torch_stage_profile.py euler [--seeds 27092023] [--profile]
    python3 scripts/torch_stage_profile.py seird [--seeds 21092023 1 2] [--profile]
    python3 scripts/torch_stage_profile.py ex1c [--seeds 27092023] [--profile]
    python3 scripts/torch_stage_profile.py scaled [--seeds 0 1 2] [--profile]

Builds the screen kernels first, so no run pays for nvcc. Then, for each
seed, runs the flagship workload (heat ex3: ``1.0 20 0.05 80 5``, euler
ex1a: ``0.06 200 0.03 400 6``, seird ex1a: ``90 90 0.10 360``, euler ex1c:
``0.06 200 0.03 3200 6`` with the low-rank weight roots; 600 draws; or
``scaled`` at its defaults: n 6000, 10,000 snapshots, 30 modes, m' 2048,
256 draws) on ``cuda`` and prints one JSON
line: the card (name, power limit), the seed, the stage wall seconds, the
chosen lambda, the valid draws, the screen-kernel launches and the
relative ensemble-mean errors against the compressed truth (heat: also
against the full-state truth, the reference's own metric; seird: against
the truth, with the posterior mean beside the true parameters; scaled:
the regularizer, the stable share, the training error, the grid errors
and the roots' ranks instead). With
``--profile`` the first seed is run once more under ``torch.profiler``,
and its line adds, for each stage, the device operations (kernels and
copies) launched in it, the time the device was busy with them and its
share of the stage's wall time, and the screen kernels' launches and
summed device time. With ``--ladder`` (heat only) the first
seed's regression is kept and, for each lambda of a ladder, the 600-draw
ensemble is drawn anew at that lambda: one JSON line each with the valid
draws and the ensemble-mean errors per trajectory, and the chance that
all 20 draws of every trajectory pass the screen if each draw passes
with the ensemble's valid share.
"""

import argparse
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gp_bayesopinf_torch.bayes import BayesianROM, OperatorPosterior  # noqa: E402
from gp_bayesopinf_torch.ops import cahbn_screen, ensemble_screen  # noqa: E402
from gp_bayesopinf_torch.ops.build import build  # noqa: E402
from gp_bayesopinf_torch.pipeline import (  # noqa: E402
    EulerConfig,
    HeatMultiConfig,
    SEIRDConfig,
    ensemble_error,
    ensemble_errors,
    run_euler,
    run_heat_multi,
    run_scaled,
    run_seird,
)
from gp_bayesopinf_torch.pipeline import odes, pdes_multi  # noqa: E402
from gp_bayesopinf_torch.utils.reporting import card_line  # noqa: E402

WORKLOADS = {
    "heat": (run_heat_multi, HeatMultiConfig, ((0.0, 1.0), 20, 0.05, 80, 5)),
    "euler": (run_euler, EulerConfig, ((0.0, 0.06), 200, 0.03, 400, 6)),
    "seird": (run_seird, SEIRDConfig, ((0.0, 90.0), 90, 0.10, 360)),
    "ex1c": (run_euler, EulerConfig, ((0.0, 0.06), 200, 0.03, 3200, 6)),
    "scaled": (run_scaled, None, ()),  # its defaults; the seed is an argument
}


def stage_device_time(prof, stages):
    """{stage: (device operations, device-busy ms, screen-kernel launches,
    screen-kernel ms)} from the profiler's raw events: the kernels and
    copies that start inside the stage's range, their busy time the union
    of their intervals (overlaps count once). The stage ranges' own
    projections onto the device timeline (events named after the stage)
    are not operations and are left out."""
    events = prof.profiler.kineto_results.events()
    device = sorted(
        (d.start_ns(), d.start_ns() + d.duration_ns(), "screen_kernel" in d.name())
        for d in events
        if d.device_type() == torch.autograd.DeviceType.CUDA and d.name() not in stages
    )
    out = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in stages:
            lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
            inside = [iv for iv in device if lo <= iv[0] < hi]
            screens = [b - a for a, b, is_screen in inside if is_screen]
            busy, end = 0, None
            for a, b, _ in inside:
                if end is None or a > end:
                    busy, end = busy + (b - a), b
                elif b > end:
                    busy, end = busy + (b - end), b
            out[e.name()] = (len(inside), busy / 1e6, len(screens), sum(screens) / 1e6)
    return out


def heat_ladder(seed, lams):
    """Re-draw the 600-draw ensembles of one heat run at each lambda."""
    with mock.patch.object(pdes_multi, "auto_regularize",
                           wraps=pdes_multi.auto_regularize) as search:
        res = run_heat_multi((0.0, 1.0), 20, 0.05, 80, 5, ndraws=600, device="cuda",
                             config=HeatMultiConfig(seed=seed), verbose=False,
                             generalization_test=False)
    fac, rom, ics, t_pred, _, state_ests = search.call_args.args[:6]
    qbar = torch.mean(state_ests, dim=2)
    bound = 5.0 * torch.amax(torch.abs(state_ests - qbar[..., None]), dim=2)
    truth_c = [res.basis.compress(t) for t in res.true_states]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for lam in sorted(set(lams) | {res.regularizer}):
        model = BayesianROM(rom, OperatorPosterior.from_lstsq(fac, lam), lam)
        draws, valid = model.solution_posterior(
            ics, t_pred, 600, generator=gen, stability_envelope=(qbar, bound),
            input_func=pdes_multi.stacked_input_func(res.input_parameters, "cuda"),
        )
        share = valid.double().mean(dim=1)
        print(json.dumps({
            "card": card_line(), "workload": "heat", "seed": seed, "lambda": lam,
            "chosen": lam == res.regularizer, "spd": bool(fac.posterior_spd(
                torch.tensor([lam], dtype=torch.float64, device="cuda"))[0]),
            "valid": valid.sum(dim=1).tolist(),
            "err_compressed": [pdes_multi._mean_error(d, v, t)
                               for d, v, t in zip(draws, valid, truth_c)],
            "p_screen_pass": float(torch.prod(share**20)),
        }), flush=True)


def run_once(name, seed, profile=False):
    runner, config_cls, args = WORKLOADS[name]
    ensemble_screen.launches = cahbn_screen.launches = 0
    if name == "scaled":
        kw = dict(seed=seed, device="cuda", verbose=False)
    else:
        kw = dict(config=config_cls(seed=seed), ndraws=600, device="cuda", verbose=False)
    t0 = time.perf_counter()
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            res = runner(*args, **kw)
    else:
        res = runner(*args, **kw)
    torch.cuda.synchronize()
    line = {
        "card": card_line(), "workload": name, "seed": seed, "profiled": profile,
        "wall_s": time.perf_counter() - t0, "stage_s": res.stage_seconds,
        "lambda": res.regularizer,
        "launches": {"quadratic_ensemble_screen": ensemble_screen.launches,
                     "cahbn_ensemble_screen": cahbn_screen.launches},
    }
    if name == "scaled":
        line.update(stable_fraction=res.stable_fraction, train_error=res.train_error,
                    grid_errors=res.grid_errors.tolist(), weight_method=res.weight_method,
                    ranks=res.weight_ranks.tolist())
    elif name == "heat":
        errs, err_new = ensemble_errors(res)
        full, full_new = ensemble_errors(res, full_state=True)
        line.update(valid=res.valid.sum(dim=1).tolist(),
                    valid_test=int(res.newparam_valid.sum()),
                    err_compressed=errs, err_compressed_test=err_new,
                    err_full=full, err_full_test=full_new)
    elif name == "seird":
        line.update(valid=int(res.valid.sum()), valid_newic=int(res.newic_valid.sum()),
                    err=odes.ensemble_error(res), err_newic=odes.ensemble_error(res, newic=True),
                    posterior_mean=res.bayesian_model.mean.tolist(),
                    true_parameters=list(res.model.parameters))
    else:
        line.update(valid=int(res.valid.sum()), err_compressed=ensemble_error(res),
                    ranks=[g.lowrank_root.rank for g in res.gps if g.lowrank_root is not None])
    if profile:
        dev = stage_device_time(prof, set(res.stage_seconds))
        line["device"] = {
            s: {"ops": n, "busy_ms": ms, "busy": ms / 1e3 / res.stage_seconds[s],
                "screen_launches": ns, "screen_ms": sms}
            for s, (n, ms, ns, sms) in dev.items()
        }
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workload", choices=sorted(WORKLOADS))
    parser.add_argument("--seeds", type=int, nargs="+")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--ladder", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kernel in ("quadratic_screen", "cahbn_screen"):
        build(kernel)
    config_cls = WORKLOADS[args.workload][1]
    seeds = args.seeds or [0 if config_cls is None else config_cls().seed]
    for seed in seeds:
        run_once(args.workload, seed)
    if args.profile:
        run_once(args.workload, seeds[0], profile=True)
    if args.ladder and args.workload == "heat":
        heat_ladder(seeds[0], np.logspace(-8, 2, 11).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
