"""Compressible-Euler GP-BayesOpInf demo on the PyTorch port (the
counterpart of ``examples/euler_demo.py``; reference ``PDEs/`` pipeline +
``models/euler.ipynb`` visuals).

Runs a reduced-size version of the flagship ex1a workload on one device,
draws the reduced- and full-space posterior figures and prints the
ensemble mean's reduced-space error on the training domain. Usage::

    python examples/torch_euler_demo.py [--full] [--device cuda] [--no-figures]

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

from gp_bayesopinf_torch.pipeline.pdes import run_euler  # noqa: E402
from gp_bayesopinf_torch.utils.device import to_host  # noqa: E402
from gp_bayesopinf_torch.utils.reporting import require_figures  # noqa: E402

OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "figures")

#: run_euler's positional workload (span, samples, noise, m', modes), draws.
REDUCED = dict(training_span=(0.0, 0.06), num_samples=80, noiselevel=0.01,
               num_regression_points=120, num_pod_modes=4, ndraws=60)
# Flagship ex1a (reference PDEs/experiments.sh:13).
FULL = dict(training_span=(0.0, 0.06), num_samples=200, noiselevel=0.03,
            num_regression_points=400, num_pod_modes=6, ndraws=600)

#: The files ``report`` draws, in the order the JAX demo saves them; the
#: last one once per lifted variable (u, p, zeta).
FIGURES = ("euler_train.pdf", "euler_posterior_reduced.pdf", "euler_posterior_full_var{}.pdf")


def compute(full: bool = False, *, device, config=None, verbose: bool = True, **overrides):
    """The demo's Euler run on ``device``; ``overrides`` replace entries of
    the workload."""
    kw = dict(FULL if full else REDUCED, **overrides)
    return run_euler(**kw, config=config, verbose=verbose, device=device)


def training_domain_error(res) -> float:
    """Relative L2 error of the valid compressed draws' mean against the
    compressed truth, over the prediction times inside the training span."""
    true_c = to_host(res.basis.compress(res.true_states))
    tr_mask = res.time_domain <= res.t_estimation[-1]
    mean_c = to_host(res.draws_compressed)[to_host(res.valid)].mean(axis=0)
    return float(np.linalg.norm((mean_c - true_c)[:, tr_mask])
                 / np.linalg.norm(true_c[:, tr_mask]))


def report(res, outdir: str = OUTDIR, figures: bool = True) -> float:
    """Draw the figures (unless ``figures`` is false), print the error line
    and return the error."""
    if figures:
        plt = require_figures()
        from gp_bayesopinf_torch import viz

        os.makedirs(outdir, exist_ok=True)
        gp_preds = [gp.predict(gp.t_estimation) for gp in res.gps]
        valid = to_host(res.valid)
        red = viz.ReducedPlotter(
            res.time_domain_sampled,
            res.t_estimation,
            res.time_domain,
            to_host(res.snapshots_compressed),
            to_host(res.basis.compress(res.true_states)),
            np.stack([to_host(m) for m, _ in gp_preds]),
            np.stack([to_host(s) for _, s in gp_preds]),
            to_host(res.draws_compressed)[valid],
        )
        train, reduced, full = FIGURES
        red.plot_gp_training_fit(width=3).savefig(os.path.join(outdir, train),
                                                  bbox_inches="tight")
        red.plot_posterior().savefig(os.path.join(outdir, reduced), bbox_inches="tight")
        plt.close("all")

        if res.draws is not None and len(res.draws):
            state = viz.StatePlotter(
                res.time_domain_sampled,
                res.t_estimation,
                res.time_domain,
                np.asarray(res.model.spatial_domain),
                res.model.num_variables,
                to_host(res.snapshots_sampled),
                to_host(res.true_states),
                to_host(res.basis.project(res.true_states)),
                to_host(res.draws),
                numspatialpoints=4,
            )
            for v, fig in enumerate(state.plot_posterior()):
                fig.savefig(os.path.join(outdir, full.format(v)), bbox_inches="tight")
            plt.close("all")

    err = training_domain_error(res)
    print(f"reduced-space training-domain error of ensemble mean: {err:.3%} ({err!r})")
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
