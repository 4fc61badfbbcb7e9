"""Seconds of the ODE posterior ensembles an experiment: the ensemble from
the fitted initial state and the one from the unseen initial state
(SEIRD: bayes/posterior.py ``BayesianODE``, models/seird.py,
solve/ivp.py)."""

NAME = "ode_ensemble_s"
UNIT = "s"
LAYER = "ensemble"
MOVES = "experiment_s"
STAGES = ("ensemble", "newic")


def read(run):
    """The mean over the window's experiments of the stages' seconds, as
    the program's stage timers report them; None without experiments."""
    times = [sum(e["stage_seconds"].get(s, 0.0) for s in STAGES) for e in run["experiments"]]
    return sum(times) / len(times) if times else None
