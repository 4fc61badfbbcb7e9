"""SEIRD parameter-estimation demo on the PyTorch port (the counterpart of
``examples/seird_demo.py``; reference ``models/seird.ipynb`` + ``ODEs/``
pipeline walk-through).

Runs a reduced-size version of the paper's ex1a workload end to end on
one device, draws the GP fit and posterior figures next to this script
and prints the ensemble-mean error. Usage::

    python examples/torch_seird_demo.py [--full] [--device cuda] [--no-figures]

``--device`` defaults to ``cuda``; the CPU runs only when asked for
(``--device cpu``). The figures need matplotlib (and the port's ``viz``
needs h5py); without them pass ``--no-figures``, or the script stops with
an ImportError naming the package before the run starts.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gp_bayesopinf_torch.pipeline.odes import run_seird  # noqa: E402
from gp_bayesopinf_torch.pipeline.report import summarize_posterior  # noqa: E402
from gp_bayesopinf_torch.utils.device import to_host  # noqa: E402
from gp_bayesopinf_torch.utils.reporting import require_figures  # noqa: E402

OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "figures")

#: run_seird's positional workload: (training span, samples, noise, m'), draws.
REDUCED = dict(training_span=(0.0, 90.0), num_samples=40, noiselevel=0.10,
               num_regression_points=120, ndraws=100)
# The paper workload (reference ODEs/experiments.sh ex1a).
FULL = dict(training_span=(0.0, 90.0), num_samples=90, noiselevel=0.10,
            num_regression_points=360, ndraws=600)

#: The files ``report`` draws, in the order the JAX demo saves them.
FIGURES = ("seird_train.pdf", "seird_posterior.pdf", "seird_newics.pdf")


def compute(full: bool = False, *, device, config=None, verbose: bool = True, **overrides):
    """The demo's SEIRD run with the second-backend crosscheck on
    ``device``; ``overrides`` replace entries of the workload."""
    kw = dict(FULL if full else REDUCED, **overrides)
    return run_seird(**kw, config=config, crosscheck=True, verbose=verbose, device=device)


def ensemble_mean_error(res) -> float:
    """Relative L2 error of the valid draws' mean against the truth."""
    draws = to_host(res.draws)[to_host(res.valid)]
    truth = np.asarray(res.true_states)
    return float(np.linalg.norm(draws.mean(axis=0) - truth) / np.linalg.norm(truth))


def report(res, outdir: str = OUTDIR, figures: bool = True) -> float:
    """Draw the figures (unless ``figures`` is false), append the
    posterior summary to ``<outdir>/report.txt``, print the error line and
    return the error."""
    os.makedirs(outdir, exist_ok=True)
    if figures:
        plt = require_figures()
        from gp_bayesopinf_torch import viz
        gp_preds = [gp.predict(gp.t_estimation) for gp in res.gps]
        valid, newic_valid = to_host(res.valid), to_host(res.newic_valid)
        plotter = viz.ODEPlotter(
            np.stack(res.sample_times),
            res.t_estimation,
            res.time_domain,
            res.snapshots,
            res.true_states,
            np.stack([to_host(m) for m, _ in gp_preds]),
            np.stack([to_host(s) for _, s in gp_preds]),
            to_host(res.draws)[valid],
        )
        train, posterior, newics = (os.path.join(outdir, name) for name in FIGURES)
        plotter.plot_gp_training_fit().savefig(train, bbox_inches="tight")
        plotter.plot_posterior().savefig(posterior, bbox_inches="tight")
        plotter.plot_posterior(
            newic_draws=to_host(res.newic_draws)[newic_valid]
        ).savefig(newics, bbox_inches="tight")
        plt.close("all")
    summarize_posterior(np.asarray(res.model.parameters), res.bayesian_model, folder=outdir)
    err = ensemble_mean_error(res)
    print(f"ensemble-mean relative error vs truth: {err:.3%} ({err!r})")
    if figures:
        print(f"figures written to {outdir}")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="paper-size workload")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--no-figures", action="store_true", help="skip matplotlib entirely")
    args = ap.parse_args(argv)
    if not args.no_figures:
        require_figures()
        import gp_bayesopinf_torch.viz  # noqa: F401  (and its h5py, before the run)
    res = compute(args.full, device=args.device)
    report(res, figures=not args.no_figures)


if __name__ == "__main__":
    main()
