"""Share of the data stage's RK4 steps that the fused Euler truth-solve
kernel took: 100 times the ``rk4_fused_steps`` over the ``rk4_steps``
counted in the window's ``data`` spans (models/euler.py: a truth solve on
the card runs ``ops/euler_truth.py``'s kernel, one on the CPU the
``rk4_solve`` loop). Read from the program's span recorder; None without
a trace, without spans or without steps. A program that counts no fused
steps reads 0."""

from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "truth_fused_share"
UNIT = "%"
LAYER = "data"
MOVES = "experiment_s"


def read(run):
    window = spans.in_window(timing, run["trace"])
    if window is None:
        return None
    tops = [s for s in window if s.name == "data"]
    steps = spans.subtree_counter(window, tops, "rk4_steps")
    if not steps:
        return None
    return 100.0 * spans.subtree_counter(window, tops, "rk4_fused_steps") / steps
