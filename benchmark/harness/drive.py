"""One run of a cell: set-up, the measured window, the check.

Set-up loads the program, builds or loads only the cell's kernel library,
and warms up the shapes that the traffic's ``warmup`` block lists: one GP
fit at its (rows, m, m') on data of a fixed seed of its own, and one
screen launch on each of its grids. The window then runs the experiment
back to back with one client (closed loop). Each experiment takes a data
seed from the traffic's fixed pool, in an order drawn from ``--seed``, so
that every run does the same work; one starts only while the time left is
at least the longest experiment seen so far (the first always starts).
After the window, each experiment's outputs are held against the plain
reference (``judge``).
"""

import dataclasses
import importlib
import inspect
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from ..counts import screens as counts
from ..reference import common
from . import judge
from .spec import SpecError


def resolve(path: str):
    """The object ``module:attribute`` names."""
    module, _, attr = path.partition(":")
    obj = importlib.import_module(module)
    return getattr(obj, attr) if attr else obj


def experiment_seed(seed: int, index: int, pool) -> int:
    """The data seed of experiment ``index`` of a run with ``--seed``: the
    pool's seeds in an order drawn from ``--seed``, cycled."""
    order = np.random.default_rng(np.random.SeedSequence(seed % 2**64)).permutation(len(pool))
    return int(pool[order[index % len(pool)]])


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _convert(spec, like):
    if isinstance(like, np.ndarray):
        return common.grid(spec)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{k: _convert(v, getattr(like, k))
                                            for k, v in spec.items()})
    if isinstance(like, (tuple, list)):
        return _tuples(spec)
    return type(like)(spec)


def program_config(config: dict, seed: int):
    """The program's configuration object: every field as the config file
    states it, the seed ``seed``. The file has to state every field."""
    cls = resolve(config["config_class"])
    base = cls()
    values = config["config"]
    fields = {f.name for f in dataclasses.fields(cls)} - {"seed"}
    if set(values) != fields:
        raise SpecError(f"config file fields differ from {cls.__name__}'s: "
                        f"{sorted(set(values) ^ fields)}")
    return dataclasses.replace(base, seed=seed,
                               **{k: _convert(v, getattr(base, k)) for k, v in values.items()})


def reference_config(config: dict, traffic: dict) -> dict:
    """The plain values the reference reads: the config file's, arrays
    made, and the traffic's arguments."""
    out = {k: (common.grid(v) if isinstance(v, dict) and not set(v) - {
        "linspace", "logspace", "drop_last"} else v) for k, v in config["config"].items()}
    out["t_pred"] = out["time_domain"]
    out["gp_regularizer"] = traffic["args"].get("gp_regularizer", 1e-8)
    return out


class Instruments:
    """Wraps, for the window only, what the check and the readers take
    from a run: each stage's host range (time.time_ns(), the profiler's
    clock), the GP fits' NLML, the search's result, and each screen
    launch's least time, counted from its arguments."""

    def __init__(self, config: dict, runner_module):
        self.config, self.module = config, runner_module
        self.stages, self.screens = [], []
        self.capture = {}
        self._stack = ExitStack()

    def __enter__(self):
        inst = self
        base = self.module.TimedBlock

        class Recorded(base):
            def __enter__(self):
                out = base.__enter__(self)
                self._ns0 = time.time_ns()
                return out

            def __exit__(self, *exc):
                out = base.__exit__(self, *exc)
                inst.stages.append((self._range.name, self._ns0, time.time_ns()))
                return out

        search = self.module.auto_regularize

        def searched(*a, **kw):
            res = search(*a, **kw)
            self.capture["search"] = res
            return res

        fit_mod = importlib.import_module("gp_bayesopinf_torch.gp.gp")
        fit = fit_mod.fit_gp_hyperparameters

        def fitted(*a, **kw):
            res = fit(*a, **kw)
            self.capture["nlml"] = res.nlml.detach().cpu().numpy()
            return res

        screen_mod, name = self.config["screen"]["function"].split(":")
        screen_mod = importlib.import_module(screen_mod)
        screen = getattr(screen_mod, name)
        signature = inspect.signature(screen)
        kernel = self.config["screen"]["kernel"]

        def screened(*a, **kw):
            args = signature.bind(*a, **kw)
            args.apply_defaults()
            self.screens.append(launch_bound(kernel, args.arguments))
            return screen(*a, **kw)

        for target, attr, new in ((self.module, "TimedBlock", Recorded),
                                  (self.module, "auto_regularize", searched),
                                  (fit_mod, "fit_gp_hyperparameters", fitted),
                                  (screen_mod, name, screened)):
            self._stack.enter_context(mock.patch.object(target, attr, new))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


def launch_bound(kernel: str, a: dict) -> dict:
    """The operations, bytes and least milliseconds of one screen launch
    (``counts.screens``), counted from what its inputs need: every draw
    of every problem through every step."""
    O, q0, t = a["Ohat"], a["q0"], a["t_eval"]
    N, r, _ = O.shape
    n_prob = q0.shape[0] if q0.ndim == 2 else 1
    G = N // a["nd"]
    track = a["track_error"] and a["snapshots"] is not None
    tensors = [a[k] for k in ("Ohat", "q0", "t_eval", "shift", "limits", "u_stages")
               if k in a] + [a["snapshots"] if track else None]
    if kernel == "quadratic":
        flops = counts.quadratic_flops(N, r, t.shape[0], a["substeps"])
    else:
        flops = counts.cahbn_flops(N, r, a["u_stages"].shape[-1], t.shape[0], a["substeps"],
                                   a["newton_iters"])
    flops *= n_prob
    nbytes = counts.screen_bytes(tensors, n_prob * N, n_prob * G)
    ms, bound_by = counts.bound_ms(flops, nbytes)
    return {"kernel": kernel, "flops": flops, "bytes": nbytes, "bound_ms": ms,
            "bound_by": bound_by}


def warm_up(config: dict, traffic: dict, device) -> dict:
    """The shapes of the traffic's ``warmup`` block, once: a GP fit at
    its (rows, m, m') on smooth data of a fixed seed, then one launch of
    the configuration's screen per entry of ``screens``, with zero
    operators at its batch. Returns their walls."""
    from gp_bayesopinf_torch.gp import fit_gaussian_processes

    w = traffic["warmup"]
    g = w["gp"]
    f64 = dict(dtype=torch.float64, device=device)
    rows, m, mp = g["rows"], g["samples"], g["points"]
    lo, hi = g["span"]
    rng = np.random.default_rng(w["seed"])
    t = np.sort(rng.uniform(lo, hi, m))
    t[0], t[-1] = lo, hi
    phase = rng.uniform(0, 2 * np.pi, (rows, 1))
    y = np.sin(2 * np.pi * (t - lo) / (hi - lo) + phase) + 0.01 * rng.standard_normal((rows, m))
    bounds = config["config"]["gp_bounds"]
    gen = torch.Generator(device=device)
    gen.manual_seed(w["seed"])
    t0 = time.perf_counter()
    fit_gaussian_processes(
        torch.linspace(lo, hi, mp, **f64), torch.as_tensor(t, **f64), torch.as_tensor(y, **f64),
        constant_bounds=tuple(bounds["constant"]), length_scale_bounds=tuple(bounds["length_scale"]),
        noise_level_bounds=tuple(bounds["noise_level"]), n_restarts_optimizer=bounds["n_restarts"],
        generator=gen,
    )
    torch.cuda.synchronize(device) if torch.device(device).type == "cuda" else None
    fit_s = time.perf_counter() - t0

    screen = resolve(config["screen"]["dispatch"])
    f32 = dict(dtype=torch.float32, device=device)
    t1 = time.perf_counter()
    for sc in w["screens"]:
        r, d, L, nu = sc["r"], sc["d"], sc["trajectories"], sc.get("inputs", 0)
        t_grid = common.grid(sc["grid"])
        k = len(t_grid)
        kw = dict(Ohat=torch.zeros((sc["candidates"] * sc["draws"], r, d), **f32),
                  q0=torch.zeros((L, r), **f32), t_eval=torch.as_tensor(t_grid, **f32),
                  shift=torch.zeros((L, r), **f32), limits=torch.ones((L, r), **f32),
                  snapshots=torch.zeros((L, r, k), **f32) if sc["error"] else None,
                  nd=sc["draws"], substeps=sc["substeps"], track_error=sc["error"])
        if nu:
            kw["u_stages"] = torch.zeros((L, (k - 1) * sc["substeps"] * sc["input_stages"], nu),
                                         **f32)
        screen(**kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"fit_s": fit_s, "screen_s": time.perf_counter() - t1}


def pick_for(seed: int, check: dict):
    """The sample the check reads of an experiment, drawn from its seed:
    ``check["draws"]`` ensemble draws, the grid's best candidate with
    ``check["kept"]`` other kept and ``check["rejected"]`` rejected ones,
    and ``check["decompressed"]`` of the sampled valid draws."""
    rng = np.random.default_rng([seed, 7])

    def pick(ndraws, grid_errors):
        J = np.sort(rng.choice(ndraws, size=min(check["draws"], ndraws), replace=False))
        kept = np.flatnonzero(grid_errors < judge.MAXOPTVAL)
        best = int(np.argmin(grid_errors))
        others = kept[kept != best]
        rejected = np.flatnonzero(grid_errors >= judge.MAXOPTVAL)
        chosen = [best]
        for pool, n in ((others, check["kept"]), (rejected, check["rejected"])):
            if len(pool):
                chosen += rng.choice(pool, size=min(n, len(pool)), replace=False).tolist()
        return J, sorted(int(c) for c in chosen), check.get("decompressed", 0)

    return pick


def follow_of(obs: dict) -> dict:
    """The program's state that the reference follows (``reference.
    experiment``), from its observations."""
    return {"theta": obs["theta"], "lam": obs["lam"], "refined": obs["refined"],
            "best": int(np.argmin(obs["grid_errors"])),
            "covariance": obs["covariance"], "roots": obs["roots"],
            "mean": obs["post_mean"], "factor": obs["factor"],
            "compressed": obs["compressed"], "candidates": obs["candidates"],
            "draws": obs["draws_index"], "decompressed_index": obs.get("decompressed_index")}


class Run:
    """A cell's program and reference, as the run and its tests drive
    them."""

    def __init__(self, cell, device):
        self.cell, self.device = cell, device
        self.config, self.traffic, self.check = cell.config, cell.traffic, cell.check
        self.runner_module = resolve(self.config["runner"].split(":")[0])
        self.runner = resolve(self.config["runner"])
        self.observe = resolve(f"benchmark.observe.{self.config['observe']}:observe")
        self.reference = resolve(f"benchmark.reference.{self.config['reference']}:compute")

    def experiment(self, seed: int, instruments: Instruments):
        """One experiment at data seed ``seed``: (wall seconds, result);
        ``instruments.capture`` holds its captures afterwards."""
        args = {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in self.traffic["args"].items()}
        cfg = program_config(self.config, seed)
        instruments.capture.clear()
        t0 = time.perf_counter()
        res = self.runner(**args, **self.traffic.get("kwargs", {}), verbose=False,
                          device=self.device, config=cfg)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0, res

    def judge_sides(self, seed: int, obs: dict, cache: dict, controls=()) -> list:
        """The numbers of one experiment: first the program's observations
        against the float64 reference, then for each precision in
        ``controls`` the reference computed in it, stage by stage from the
        float64 reference's inputs to each stage, in the program's place,
        against the same reference."""
        follow = follow_of(obs)
        rcfg = reference_config(self.config, self.traffic)
        args = dict(self.traffic["args"], **self.traffic.get("kwargs", {}))
        f64 = {"float": np.float64, "screen": torch.float64}
        nblocks = self.config["variables"]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the reference's many small operations run fastest on one
        try:
            ref = self.reference(rcfg, args, seed, self.device, follow, f64, cache)
            out = [judge.numbers(judge.as_observed(obs), ref, nblocks)]
            for precision in controls:
                ctrl = self.reference(rcfg, args, seed, self.device, follow, precision, cache,
                                      upstream=ref)
                out.append(judge.numbers(judge.control_observed(ctrl, follow), ref, nblocks))
        finally:
            torch.set_num_threads(threads)
        return out

    def judge(self, seed: int, obs: dict, cache: dict) -> dict:
        """The numbers of one experiment's observations."""
        return self.judge_sides(seed, obs, cache)[0]
