"""Objective evaluations of the regularization search an experiment:
its screen launches, read from the screen wrapper's own counter, over 2
(one launch on each of the two time grids an evaluation)."""

NAME = "objective_evals"
UNIT = "evals"
LAYER = "regression and search"
MOVES = "experiment_s"


def read(run):
    counts = [e["launches"] / 2 for e in run["experiments"]]
    return sum(counts) / len(counts) if counts else None
