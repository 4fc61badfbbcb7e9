"""A whole run of one cell: set-up, window, check, metrics, the result line."""

import math
import sys
import time
import traceback

import torch

from . import drive, judge
from .trace import DeviceTrace

#: What a number that is not finite is printed as: JSON has no infinity.
NOT_FINITE = 1e300


def _num(x):
    x = float(x)
    return x if math.isfinite(x) else NOT_FINITE


def set_up(cell, device):
    """Loads the cell's kernel library (built on a checkout's first run)
    and warms up its shapes; returns the ``drive.Run`` and the warm-up's
    walls."""
    from gp_bayesopinf_torch.ops.build import load_library

    run = drive.Run(cell, device)
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        load_library(cell.config["library"])
    warm = drive.warm_up(cell.config, cell.traffic, device)
    return run, warm


def window(run, seed: int, seconds: float, tracer=None):
    """The measured window: experiments back to back, each started only
    while the time left is at least the longest so far. Returns (start,
    end, [(seed, wall, result, capture, launches)], [seeds of experiments
    that raised], instruments)."""
    counter = drive.resolve(run.config["screen"]["function"].split(":")[0])
    pool = run.traffic["data_seeds"]
    done, failures = [], []
    with drive.Instruments(run.config, run.runner_module) as inst:
        if tracer is not None:
            tracer.start()
        start = time.perf_counter()
        longest = 0.0
        while not done and not failures or start + seconds - time.perf_counter() >= longest:
            s = drive.experiment_seed(seed, len(done) + len(failures), pool)
            n0 = counter.launches
            t0 = time.perf_counter()
            try:
                wall, res = run.experiment(s, inst)
            except Exception:  # every seed of the pool runs through: a failure
                traceback.print_exc(file=sys.stderr)
                failures.append(s)
                longest = max(longest, time.perf_counter() - t0)
                continue
            done.append((s, wall, res, dict(inst.capture), counter.launches - n0))
            longest = max(longest, wall)
        end = time.perf_counter()
        if tracer is not None:
            tracer.stop()
    return start, end, done, failures, inst


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(result line, [(number, value, limit)]) of one run."""
    run, warm = set_up(cell, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = DeviceTrace() if trace else None
    setup_s = time.perf_counter() - t_start  # the window starts next
    start, end, done, failures, inst = window(run, seed, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    experiments, observed = [], []
    for s, wall, res, capture, launches in done:
        observed.append((s, run.observe(res, capture, drive.pick_for(s, cell.check))))
        experiments.append({"seed": s, "wall_s": wall, "stage_seconds": res.stage_seconds,
                            "launches": launches})
        print(f"experiment seed {s}: {wall:.4f} s, stages {res.stage_seconds}, "
              f"screen launches {launches}, lambda {res.regularizer!r}", file=sys.stderr)
    del done
    if cuda:
        torch.cuda.empty_cache()

    limits = cell.check["limits"]
    t_check = time.perf_counter()
    cache, per_experiment, wrong = {}, [], 0
    for s, obs in observed:
        per_experiment.append(run.judge(s, obs, cache))
        wrong += not judge.verdict(per_experiment[-1], limits)[0]
    for s in failures:
        print(f"experiment seed {s} raised", file=sys.stderr)
    print(f"reference check of {len(per_experiment)} experiment(s): "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    values = judge.worst(per_experiment) if per_experiment else {}
    _, rows = judge.verdict(values, limits)
    done_count = len(observed)
    correct = wrong == 0 and not failures and done_count > 0

    metrics = {}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {}
    if not trace:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        if done_count:
            metrics["experiment_s"] = {"value": (end - start) / done_count,
                                       "unit": units["experiment_s"]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    else:
        state = {"experiments": experiments, "warmup": warm, "screens": inst.screens,
                 "stages": inst.stages, "trace": tracer, "window_s": end - start}
        for name, reader in cell.readers.items():
            value = reader.read(state)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        device_info.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
        result["breakdown"] = tracer.breakdown(inst.stages)
        for stage, (ops, busy_ms, launches, screen_ms) in tracer.stage_busy(inst.stages).items():
            print(f"stage {stage}: {ops} device operations, busy {busy_ms:.3f} ms, "
                  f"screen launches {launches} ({screen_ms:.3f} ms)", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": len(observed) + len(failures),
              "failed": len(failures) + wrong,
              "metrics": metrics, "device": device_info, **result,
              "checks": {name: {"value": _num(v), "limit": lim} for name, v, lim in rows}}
    return result, [(name, _num(v), lim) for name, v, lim in rows]
