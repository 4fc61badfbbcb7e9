"""The comparison that decides ``correct``: each number the check
compares, from an experiment's observations and the reference's outputs
for it, against the limit the cell's check file gives.

Every number is a gap that a sound run keeps near roundoff and a run in
lower precision, or with a fault, does not:

* ``truth``, ``snapshots``: the largest difference of the truth states
  (and, for heat, the test parameters' truth) and of the noisy samples,
  over the largest magnitude of its variable;
* ``pod``: each compressed snapshot row against the reference's, in
  2-norm over the reference row's;
* ``gp_nlml``: the fitted GPs' negative log marginal likelihood against
  the reference's at the same hyperparameters, over max(1, |reference|);
* ``gp_fit``: how far each GP's NLML at its fitted hyperparameters lies
  above where L-BFGS-B descends to from them, or above the least at the
  method's own starts, over max(1, |NLML|): a fit that stops short reads
  high (``reference.experiment.fit_gaps``);
* ``estimates``: the GP state and derivative estimates, row by row, in
  max-norm, and each GP's derivative covariance C in Frobenius norm;
* ``roots``: each GP's weight root (C + eta I)^{-1/2} against the
  reference's from the measured run's own C, in Frobenius norm;
* ``posterior``: each operator row's posterior mean (2-norm) and
  covariance (Frobenius norm) at the chosen regularizer;
* ``search_err``: the search objective at the sampled grid candidates
  that both sides keep, relative;
* ``search_choice``: the chosen regularizer against the grid's best by
  the run's own grid errors: infinite unless it is that candidate or,
  refined, lies in the refinement's bracket around it; refined, how far
  the reference's refinement objective there lies above its value at the
  grid's best on the same draws, relative;
* ``ensemble``: each sampled draw that both sides keep, its trajectory's
  largest difference over its largest magnitude (and the decompressed
  draws' likewise, per variable).

A sampled candidate (or the refinement's choice) or draw that one side
keeps and the other rejects, where the reference's largest ratio to the
stability envelope is farther than ``MARGIN`` from 1, makes its number
infinite, as does a gap that is not a number.
"""

import math

import numpy as np

MAXOPTVAL = 1e12
#: The allowance at the envelope's edge: the screens are float32 by
#: contract, so a draw within this share of its limit may flip.
MARGIN = 0.01


def _finite(x):
    x = float(x)
    return x if math.isfinite(x) else math.inf


def _blocks_gap(obs, ref, nblocks):
    """max over leading rows and variable blocks of max|obs - ref| /
    max|ref| (arrays (..., n, k), the n rows split into ``nblocks``)."""
    worst = 0.0
    obs, ref = np.asarray(obs, np.float64), np.asarray(ref, np.float64)
    for o, r in zip(obs.reshape(-1, *obs.shape[-2:]), ref.reshape(-1, *ref.shape[-2:])):
        for ob, rb in zip(np.split(o, nblocks), np.split(r, nblocks)):
            worst = max(worst, _finite(np.max(np.abs(ob - rb)) / np.max(np.abs(rb))))
    return worst


def _rows_gap(obs, ref, ord=2):
    """max over rows (the last axis, or the last two) of ||obs - ref|| /
    ||ref||."""
    obs, ref = np.asarray(obs, np.float64), np.asarray(ref, np.float64)
    if ord == "fro":
        o = obs.reshape(-1, obs.shape[-2] * obs.shape[-1])
        r = ref.reshape(o.shape)
        ord = 2
    else:
        o, r = obs.reshape(-1, obs.shape[-1]), ref.reshape(-1, ref.shape[-1])
    num = np.linalg.norm(o - r, ord=ord, axis=1)
    den = np.linalg.norm(r, ord=ord, axis=1)
    return _finite(np.max(num / den))


def _flip(kept: bool, margin: float) -> int:
    """1 where one side keeps what the other rejects, away from the edge."""
    ref_kept = margin <= 1.0
    return int(kept != ref_kept and not abs(margin - 1.0) <= MARGIN)


def as_observed(program: dict) -> dict:
    """The judged form of the program's observations: the grid errors,
    kept flags and draws at the sampled indices."""
    out = dict(program)
    out["best"] = int(np.argmin(program["grid_errors"]))
    out["grid"] = {c: program["grid_errors"][c] for c in program["candidates"]}
    # A refinement that returned ended on a kept candidate.
    out["refine_kept"] = program["refined"]
    out["draw_kept"] = program["valid"][:, program["draws_index"]]
    if "newparam_valid" in program:
        out["newparam_kept"] = program["newparam_valid"][program["draws_index"]]
    return out


def control_observed(control: dict, follow: dict) -> dict:
    """The judged form of a reference computed in lower precision, which
    stands in the program's place, with the program's sample ``follow``."""
    out = dict(control, lam=follow["lam"], refined=follow["refined"], best=follow["best"])
    idx = follow.get("decompressed_index") or []
    out["decompressed_index"] = idx
    out["decompressed"] = control["decompress"](control["draws"][0][idx]) if idx else None
    out["grid"] = control["grid_err"]
    out["refine_kept"] = (control["refine_margin"] is not None
                          and control["refine_margin"] <= 1.0)
    out["draw_kept"] = control["draw_margin"] <= 1.0
    if "newparam_margin" in control:
        out["newparam_kept"] = control["newparam_margin"] <= 1.0
    return out


def bracket(grid, best: int):
    """The bounds of the search's refinement around grid candidate
    ``best``: its neighbours, or a hundredfold beyond an end."""
    if best == 0:
        return grid[0] / 100.0, grid[1]
    if best == len(grid) - 1:
        return grid[-2], grid[-1] * 100.0
    return grid[best - 1], grid[best + 1]


def choice_gap(obs: dict, ref: dict) -> float:
    """``search_choice`` (see the module's doc)."""
    grid, best, lam = ref["reg_grid"], obs["best"], obs["lam"]
    if not obs["refined"]:
        return 0.0 if abs(lam - grid[best]) <= 1e-12 * grid[best] else math.inf
    lo, hi = np.log10(bracket(grid, best))
    if not lo - 1e-9 <= math.log10(lam) <= hi + 1e-9:
        return math.inf
    at_lam, at_best = ref["refine_err"]
    if at_lam >= MAXOPTVAL or at_best >= MAXOPTVAL:  # flips are the refinement's verdict's
        return 0.0
    return max(0.0, _finite((at_lam - at_best) / at_best))


def numbers(obs: dict, ref: dict, nblocks: int) -> dict:
    """Every compared number of one experiment (see the module's doc)."""
    out = {}
    out["truth"] = _blocks_gap(obs["truth"], ref["truth"], nblocks)
    if "newparam_truth" in obs:
        out["truth"] = max(out["truth"], _blocks_gap(obs["newparam_truth"][None],
                                                     ref["newparam_truth"][None], nblocks))
    out["snapshots"] = _blocks_gap(obs["snapshots"], ref["snapshots"], nblocks)
    out["pod"] = _rows_gap(obs["compressed"], ref["compressed"])
    nl_o, nl_r = np.asarray(obs["nlml"], np.float64), np.asarray(ref["nlml"], np.float64)
    out["gp_nlml"] = _finite(np.max(np.abs(nl_o - nl_r) / np.maximum(1.0, np.abs(nl_r))))
    # The reference measured the program's fit; the control measured its own.
    out["gp_fit"] = _finite(np.max(obs.get("fit_gap", ref["fit_gap"])))
    out["estimates"] = max(_rows_gap(obs["state_est"], ref["state_est"], np.inf),
                           _rows_gap(obs["ddt_est"], ref["ddt_est"], np.inf),
                           _rows_gap(obs["covariance"], ref["covariance"], "fro"))
    out["roots"] = _rows_gap(obs["roots"], ref["roots"], "fro")
    out["posterior"] = max(_rows_gap(obs["post_mean"], ref["post_mean"]),
                           _rows_gap(obs["post_cov"], ref["post_cov"], "fro"))
    out["search_choice"] = choice_gap(obs, ref)

    gaps, flips = [0.0], 0
    for c, e_obs in obs["grid"].items():
        margin = float(ref["grid_margin"][c])
        flips += _flip(e_obs < MAXOPTVAL, margin)
        if e_obs < MAXOPTVAL and margin <= 1.0:
            gaps.append(_finite(abs(e_obs - ref["grid_err"][c]) / ref["grid_err"][c]))
    if ref["refine_margin"] is not None:
        flips += _flip(obs["refine_kept"], ref["refine_margin"])
    out["search_err"] = math.inf if flips else max(gaps)

    gaps, flips = [0.0], 0
    kept, margins = np.asarray(obs["draw_kept"]), np.asarray(ref["draw_margin"])
    for idx in np.ndindex(*kept.shape):
        flips += _flip(bool(kept[idx]), float(margins[idx]))
        if kept[idx] and margins[idx] <= 1.0:
            o, r = obs["draws"][idx], ref["draws"][idx]
            gaps.append(_finite(np.max(np.abs(o - r)) / np.max(np.abs(r))))
    if obs.get("decompressed") is not None:
        picked = ref["draws"][0][obs["decompressed_index"]]
        gaps.append(_blocks_gap(obs["decompressed"], ref["decompress"](picked), nblocks))
    if "newparam_kept" in obs:
        for j, k in enumerate(obs["newparam_kept"]):
            margin = float(ref["newparam_margin"][j])
            flips += _flip(bool(k), margin)
            if k and margin <= 1.0:
                o, r = obs["newparam_draws"][j], ref["newparam_draws"][j]
                gaps.append(_finite(np.max(np.abs(o - r)) / np.max(np.abs(r))))
    out["ensemble"] = math.inf if flips else max(gaps)
    return out


def worst(per_experiment) -> dict:
    """Each number's worst reading over the experiments of a run that
    read it."""
    keys = {k for n in per_experiment for k in n}
    return {k: max(n[k] for n in per_experiment if k in n) for k in keys}


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at most its limit;
    a number that was not read fails (it reads as infinite)."""
    unknown = set(values) - set(limits)
    if unknown:
        raise ValueError(f"numbers without a limit: {sorted(unknown)}")
    rows = [(k, values.get(k, math.inf), limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
