"""Seconds of the regression stage an experiment: the weighted regression and the regularization search through the screen kernel (solve/lstsq.py, bayes/regsearch.py)."""

NAME = "regression_s"
UNIT = "s"
LAYER = "regression and search"
MOVES = "experiment_s"
STAGES = ("regression",)


def read(run):
    """The mean over the window's experiments of the stages' seconds, as
    the program's stage timers report them; None without experiments."""
    times = [sum(e["stage_seconds"].get(s, 0.0) for s in STAGES) for e in run["experiments"]]
    return sum(times) / len(times) if times else None
