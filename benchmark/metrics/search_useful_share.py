"""Share of the regularization search's screened slots that hold a
distinct real candidate: 100 times the ``search_candidates`` over the
``search_slots`` counted in the window's ``regression`` spans
(bayes/regsearch.py: the grid's wrap padding and the refinement's 15
copies of its one candidate are the rest). Read from the program's span
recorder; None without a trace, without spans or slots."""

from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "search_useful_share"
UNIT = "%"
LAYER = "regression and search"
MOVES = "experiment_s"


def read(run):
    window = spans.in_window(timing, run["trace"])
    if window is None:
        return None
    tops = [s for s in window if s.name == "regression"]
    slots = spans.subtree_counter(window, tops, "search_slots")
    if not slots:
        return None
    return 100.0 * spans.subtree_counter(window, tops, "search_candidates") / slots
