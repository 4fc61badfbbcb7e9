"""Share of the posterior ensembles' SDIRK2 steps that the fused SDIRK2
kernel took: 100 times the ``dirk2_fused_steps`` over the ``dirk2_steps``
counted in the window's ``ensemble`` and ``newparam`` spans
(rom/model.py: a dirk2 "cAHBN" ROM on the card runs
``ops/cahbn_dirk2.py``'s kernel, any other the ``dirk2_solve`` loop).
Read from the program's span recorder; None without a trace, without
spans or without SDIRK2 steps. A program that counts no fused steps
reads 0."""

from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "ensemble_fused_share"
UNIT = "%"
LAYER = "ensemble"
MOVES = "experiment_s"


def read(run):
    window = spans.in_window(timing, run["trace"])
    if window is None:
        return None
    tops = [s for s in window if s.name in ("ensemble", "newparam")]
    steps = spans.subtree_counter(window, tops, "dirk2_steps")
    if not steps:
        return None
    return 100.0 * spans.subtree_counter(window, tops, "dirk2_fused_steps") / steps
