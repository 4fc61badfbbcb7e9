"""Seconds of the data stage an experiment: the truth solve and the noisy samples (models/euler.py on the device, models/heat.py on the host)."""

NAME = "data_s"
UNIT = "s"
LAYER = "data"
MOVES = "experiment_s"
STAGES = ("data",)


def read(run):
    """The mean over the window's experiments of the stages' seconds, as
    the program's stage timers report them; None without experiments."""
    times = [sum(e["stage_seconds"].get(s, 0.0) for s in STAGES) for e in run["experiments"]]
    return sum(times) / len(times) if times else None
