"""Command-line interface (counterpart of
``gp_bayesopinf_tpu/pipeline/cli.py``, the euler subcommand)::

    python -m gp_bayesopinf_torch.pipeline.cli euler T_MAX NUM_SAMPLES NOISE \\
        NUM_PTS NUM_MODES [--ndraws N] [--gpreg ETA] [--device DEVICE]

The flagship ex1a run is ``euler 0.06 200 0.03 400 6``. ``--device``
defaults to ``cuda`` and does not fall back to the CPU.
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gp_bayesopinf_torch.pipeline.cli",
        description="GP-BayesOpInf experiment pipelines (PyTorch port)",
    )
    subs = parser.add_subparsers(dest="pipeline", required=True)
    euler = subs.add_parser("euler", help="Euler GP-BayesOpInf (PDEs/)")
    euler.add_argument("t_max", type=float, help="training time-span upper bound")
    euler.add_argument("num_samples", type=int, help="training snapshots to sample")
    euler.add_argument("noiselevel", type=float, help="noise percentage")
    euler.add_argument("num_regression_points", type=int, help="GP estimation points m'")
    euler.add_argument("numPODmodes", type=int, help="POD modes r")
    euler.add_argument("--gpreg", type=float, default=1e-8, help="GP eta")
    euler.add_argument("--ndraws", type=int, default=100, help="posterior draws")
    euler.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return parser


def run(argv=None):
    """Parse ``argv`` and run the pipeline; returns its result object."""
    args = build_parser().parse_args(argv)
    from .pdes import run_euler

    return run_euler(
        training_span=(0.0, args.t_max),
        num_samples=args.num_samples,
        noiselevel=args.noiselevel,
        num_regression_points=args.num_regression_points,
        num_pod_modes=args.numPODmodes,
        gp_regularizer=args.gpreg,
        ndraws=args.ndraws,
        device=args.device,
    )


def main(argv=None) -> int:
    result = run(argv)
    valid = int(result.valid.sum())
    print(f"chosen regularizer: {result.regularizer:.6e}")
    print(f"stable draws: {valid}/{result.valid.numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
