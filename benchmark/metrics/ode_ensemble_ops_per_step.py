"""Device operations a step of the ODE posterior ensembles: the
operations that start inside the window's ``ensemble`` and ``newic``
spans over the ``rk4_steps`` counted in them (SEIRD: bayes/posterior.py
``BayesianODE``, models/seird.py, solve/ivp.py). Read from the program's
span recorder against the traced run's device operations; None without
a trace, without spans or steps."""

from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "ode_ensemble_ops_per_step"
UNIT = "ops/step"
LAYER = "ensemble"
MOVES = "experiment_s"


def read(run):
    return spans.ops_per_step(timing, run["trace"], ("ensemble", "newic"), ("rk4_steps",))
