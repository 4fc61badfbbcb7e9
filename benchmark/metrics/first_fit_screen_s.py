"""Seconds of ``gp.screen`` in a process's first GP fit, the set-up's
warm-up fit: the Adam screen of every (mode, restart) start, the starts'
draw included (gp/fit.py, phase 1); read from the program's span
recorder. None without a trace or where the program records no spans.

The phase spans synchronize nothing, so this is the host's time from
the phase's first launch to its last: device work it queued may finish
inside a later phase, which then waits for it. Confirm a gain read here
against ``first_fit_s``."""


from gp_bayesopinf_torch.utils import timing

from benchmark.counts import spans

NAME = "first_fit_screen_s"
UNIT = "s"
LAYER = "GP fit and estimation"
MOVES = "setup_s"
PHASE = "gp.screen"


def read(run):
    return spans.first_fit_phase_s(timing, run["trace"], PHASE)
