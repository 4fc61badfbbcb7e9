"""Device operations a step of the data stage's RK4 truth solves: the
operations that start inside the window's ``data`` spans over the
``rk4_steps`` counted in them (models/euler.py; the samples' noise
included). Read from the program's span recorder against the traced
run's device operations; None without a trace, without spans, or where
no RK4 step was counted (heat's truth solves run on the host)."""

from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "truth_ops_per_step"
UNIT = "ops/step"
LAYER = "data"
MOVES = "experiment_s"


def read(run):
    return spans.ops_per_step(timing, run["trace"], ("data",), ("rk4_steps",))
