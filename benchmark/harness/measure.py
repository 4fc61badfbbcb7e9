"""A whole run of one cell: set-up, window, check, metrics, the result line."""

import math
import multiprocessing
import os
import sys
import time
import traceback

import torch

from . import drive, judge, spec
from .trace import DeviceTrace

#: What a number that is not finite is printed as: JSON has no infinity.
NOT_FINITE = 1e300
#: The check holds the window's experiments against the reference in at
#: most this many processes, each on one thread: the reference's work is
#: the host's, and an experiment's is independent of the others'.
CHECK_PROCESSES = 6
#: Top-level modules that no process of a run may load: JAX's and the JAX
#: package's, compared by whole names.
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_bayesopinf_tpu")


class ForbiddenModules(RuntimeError):
    """A process of the check loaded modules of JAX or the JAX package."""


def forbidden_modules():
    """This process's loaded modules whose top-level name is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _num(x):
    x = float(x)
    return x if math.isfinite(x) else NOT_FINITE


def set_up(cell, device):
    """Loads every kernel library the cell's configuration names (built
    on a checkout's first run) and warms up its shapes; returns the
    ``drive.Run`` and the warm-up's walls."""
    from gp_bayesopinf_torch.ops.build import load_library

    run = drive.Run(cell, device)
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        for name in cell.config["library"]:
            load_library(name)
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


def _judge_share(root, home, name, device, share):
    """(the numbers of each (seed, observations) of ``share``, the
    forbidden modules loaded), in a process of the check's own."""
    cell = spec.Cell(spec.load(root), name, root, home)
    run, cache = drive.Run(cell, device), {}
    return [run.judge(s, obs, cache) for s, obs in share], forbidden_modules()


def check(run, observed, device) -> list:
    """Each experiment's numbers, in the order of ``observed`` [(seed,
    observations)]: one experiment in this process; more shared out, in
    the order of their data seeds, over up to ``CHECK_PROCESSES`` spawned
    processes, which end before it returns. Raises ``ForbiddenModules``
    where one of those processes loaded modules of JAX or the JAX
    package (this process's own are the caller's to look for)."""
    if len(observed) < 2:
        return [run.judge(s, obs, {}) for s, obs in observed]
    order = sorted(range(len(observed)), key=lambda i: observed[i][0])
    k = min(CHECK_PROCESSES, len(order))
    shares = [order[j::k] for j in range(k)]
    cell = run.cell
    saved = {v: os.environ.get(v) for v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    os.environ.update(dict.fromkeys(saved, "1"))  # read as each process starts
    try:
        with multiprocessing.get_context("spawn").Pool(k) as pool:
            results = pool.starmap(_judge_share, [
                (cell.root, cell.home, cell.name, device, [observed[i] for i in share])
                for share in shares])
    finally:
        for v, value in saved.items():
            if value is None:
                del os.environ[v]
            else:
                os.environ[v] = value
    found = sorted({m for _, loaded in results for m in loaded})
    if found:
        raise ForbiddenModules(f"the check's processes loaded modules of JAX or the JAX "
                               f"package: {found}")
    out = [None] * len(observed)
    for share, (numbers, _) in zip(shares, results):
        for i, n in zip(share, numbers):
            out[i] = n
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(result line, [(number, value, limit)]) of one run; raises
    ``ForbiddenModules`` as ``check`` does."""
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
    per_experiment = check(run, observed, device)
    wrong = sum(not judge.verdict(n, limits)[0] for n in per_experiment)
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
