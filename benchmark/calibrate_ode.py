"""``calibrate.py`` for a configuration whose GPs are fit at each
variable's own sample times (SEIRD), on the card.

    python3 benchmark/calibrate_ode.py --workload seird.ex1a --data-seeds 11 12 ... [--control 11]

The same readings and arguments as ``calibrate.py``; only the two planted
fits that stop short (``gp_fit_short``, read for the ``--control`` seeds)
are fit at each variable's own times, from the experiment's "fit" stream
of ``reference.seird.STREAMS``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def short_fits(seed: int, obs: dict, config: dict, device) -> dict:
    """``gp_fit`` of the program's fit stopped short, on the experiment's
    own snapshots, times and starts: {"no descent": ..., "first guess":
    ...}."""
    from gp_bayesopinf_torch.gp.fit import fit_gp_hyperparameters
    from gp_bayesopinf_torch.gp.nlml import BoxTransform

    from benchmark.reference import common, seird

    b = config["config"]["gp_bounds"]
    y, t = obs["compressed"][0], obs["t_sampled"]
    n = y.shape[0]
    f64 = dict(dtype=torch.float64, device=device)
    box = BoxTransform.from_bounds(b["constant"], b["length_scale"], b["noise_level"], **f64)
    bounds = [b[k] for k in ("constant", "length_scale", "noise_level")]
    fit_stream = lambda: common.stage_streams(seed, seird.STREAMS, device)["fit"]
    starts = common.fit_starts(fit_stream(), n, b["n_restarts"], bounds,
                               device).reshape(1, n, -1, 3)
    out = {}
    for name, restarts in (("no descent", b["n_restarts"]), ("first guess", 0)):
        fit = fit_gp_hyperparameters(torch.as_tensor(t, **f64), torch.as_tensor(y, **f64), box,
                                     fit_stream(), n_restarts=restarts, adam_steps=0,
                                     polish_iters=0)
        theta = torch.stack([fit.sigma2, fit.ell, fit.chi], 1).cpu().numpy().reshape(1, n, 3)
        out[name] = float(np.max(seird.fit_gaps(t, y, b, theta, starts)))
    return out


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import calibrate

    calibrate.short_fits = short_fits
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
