"""Seconds of a process's first GP fit: the warm-up's fit at the cell's
(r, m, m'), which carries the one-time costs of the fit's first calls."""

NAME = "first_fit_s"
UNIT = "s"
LAYER = "GP fit and estimation"
MOVES = "setup_s"


def read(run):
    return run["warmup"]["fit_s"]
