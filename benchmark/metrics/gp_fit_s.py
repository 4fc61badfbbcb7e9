"""Seconds of the GP stage an experiment: the batched hyperparameter fit and the estimates with their weight roots (gp/fit.py, gp/estimates.py)."""

NAME = "gp_fit_s"
UNIT = "s"
LAYER = "GP fit and estimation"
MOVES = "experiment_s"
STAGES = ("gp_fit",)


def read(run):
    """The mean over the window's experiments of the stages' seconds, as
    the program's stage timers report them; None without experiments."""
    times = [sum(e["stage_seconds"].get(s, 0.0) for s in STAGES) for e in run["experiments"]]
    return sum(times) / len(times) if times else None
