"""Seconds of the posterior ensembles an experiment: the ensemble with its decompression (Euler) or with the ensemble at the test parameters (heat) (bayes/posterior.py, solve/ivp.py)."""

NAME = "ensemble_s"
UNIT = "s"
LAYER = "ensemble"
MOVES = "experiment_s"
STAGES = ("ensemble", "decompress", "newparam")


def read(run):
    """The mean over the window's experiments of the stages' seconds, as
    the program's stage timers report them; None without experiments."""
    times = [sum(e["stage_seconds"].get(s, 0.0) for s in STAGES) for e in run["experiments"]]
    return sum(times) / len(times) if times else None
