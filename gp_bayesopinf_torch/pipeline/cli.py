"""Command-line interface (counterpart of
``gp_bayesopinf_tpu/pipeline/cli.py``, the euler and heat subcommands)::

    python -m gp_bayesopinf_torch.pipeline.cli euler T_MAX NUM_SAMPLES NOISE \\
        NUM_PTS NUM_MODES [--ndraws N] [--gpreg ETA] [--device DEVICE]
    python -m gp_bayesopinf_torch.pipeline.cli heat T_MAX NUM_SAMPLES NOISE \\
        NUM_PTS NUM_MODES [--ndraws N] [--gpreg ETA] [--device DEVICE]

The flagship runs are ``euler 0.06 200 0.03 400 6`` (ex1a) and
``heat 1.0 20 0.05 80 5`` (ex3). ``--device`` defaults to ``cuda`` and
does not fall back to the CPU.
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gp_bayesopinf_torch.pipeline.cli",
        description="GP-BayesOpInf experiment pipelines (PyTorch port)",
    )
    subs = parser.add_subparsers(dest="pipeline", required=True)
    for name, help_ in (
        ("euler", "Euler GP-BayesOpInf (PDEs/)"),
        ("heat", "multi-trajectory cubic heat (PDEsMulti/)"),
    ):
        sub = subs.add_parser(name, help=help_)
        sub.add_argument("t_max", type=float, help="training time-span upper bound")
        sub.add_argument("num_samples", type=int, help="training snapshots to sample")
        sub.add_argument("noiselevel", type=float, help="noise percentage")
        sub.add_argument("num_regression_points", type=int, help="GP estimation points m'")
        sub.add_argument("numPODmodes", type=int, help="POD modes r")
        sub.add_argument("--gpreg", type=float, default=1e-8, help="GP eta")
        sub.add_argument("--ndraws", type=int, default=100, help="posterior draws")
        sub.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return parser


def run(argv=None):
    """Parse ``argv`` and run the pipeline; returns its result object."""
    args = build_parser().parse_args(argv)
    if args.pipeline == "euler":
        from .pdes import run_euler as runner
    else:
        from .pdes_multi import run_heat_multi as runner
    return runner(
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
    print(f"chosen regularizer: {result.regularizer:.6e}")
    valid = result.valid.reshape(-1, result.valid.shape[-1])
    for ell, row in enumerate(valid):
        tag = f"trajectory {ell} " if valid.shape[0] > 1 else ""
        print(f"{tag}stable draws: {int(row.sum())}/{row.numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
