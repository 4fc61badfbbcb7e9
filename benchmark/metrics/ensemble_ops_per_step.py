"""Device operations a step of the posterior ensembles: the operations
that start inside the window's ``ensemble`` and ``newparam`` spans over
the ``rk4_steps`` and ``dirk2_steps`` counted in them (bayes/posterior.py,
solve/ivp.py; the host truth solve at the test parameters counts no
step). Read from the program's span recorder against the traced run's
device operations; None without a trace, without spans or steps."""

from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "ensemble_ops_per_step"
UNIT = "ops/step"
LAYER = "ensemble"
MOVES = "experiment_s"


def read(run):
    return spans.ops_per_step(timing, run["trace"], ("ensemble", "newparam"),
                              ("rk4_steps", "dirk2_steps"))
