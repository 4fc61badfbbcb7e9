"""Command-line interface (counterpart of
``gp_bayesopinf_tpu/pipeline/cli.py``: the seird, euler, heat and scaled
subcommands)::

    python -m gp_bayesopinf_torch.pipeline.cli seird T_MAX NUM_SAMPLES NOISE \\
        NUM_PTS [--ndraws N] [--gpreg ETA] [--crosscheck] [--device DEVICE]
    python -m gp_bayesopinf_torch.pipeline.cli euler T_MAX NUM_SAMPLES NOISE \\
        NUM_PTS NUM_MODES [--ndraws N] [--gpreg ETA] [--weights ROOT] \\
        [--ddtdata] [--device DEVICE]
    python -m gp_bayesopinf_torch.pipeline.cli heat T_MAX NUM_SAMPLES NOISE \\
        NUM_PTS NUM_MODES [--ndraws N] [--gpreg ETA] [--device DEVICE]
    python -m gp_bayesopinf_torch.pipeline.cli scaled [--source euler] \\
        [--windows W] [--regularization blocked] [--weights lowrank] ... \\
        [--device DEVICE]

``scaled`` is the production-scale pipeline (``pipeline.scaled.run_scaled``;
its defaults are n = 6000, 10,000 snapshots, 30 modes, m' = 2048) and
prints a JSON summary line. The paper's runs are ``seird 90 90 0.10 360``
(ODE ex1a), ``euler 0.06 200 0.03 400 6`` (ex1a; ex1c with 3200 points) and
``heat 1.0 20 0.05 80 5`` (ex3), each with ``--ndraws 600``. ``--device`` defaults to ``cuda`` and does not fall back
to the CPU.
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
        ("seird", "SEIRD parameter estimation (ODEs/)"),
        ("euler", "Euler GP-BayesOpInf (PDEs/)"),
        ("heat", "multi-trajectory cubic heat (PDEsMulti/)"),
    ):
        sub = subs.add_parser(name, help=help_)
        sub.add_argument("t_max", type=float, help="training time-span upper bound")
        sub.add_argument("num_samples", type=int, help="training snapshots to sample")
        sub.add_argument("noiselevel", type=float, help="noise percentage")
        sub.add_argument("num_regression_points", type=int, help="GP estimation points m'")
        if name != "seird":
            sub.add_argument("numPODmodes", type=int, help="POD modes r")
        sub.add_argument("--gpreg", type=float, default=1e-8, help="GP eta")
        sub.add_argument("--ndraws", type=int, default=100, help="posterior draws")
        sub.add_argument("--device", default="cuda", help="torch device (default cuda)")
        if name == "seird":
            sub.add_argument(
                "--crosscheck", action="store_true",
                help="compare GP products and the posterior against a NumPy/SciPy backend",
            )
        if name == "euler":
            sub.add_argument(
                "--ddtdata", action="store_true",
                help="also compute the derivative-estimate comparison data",
            )
            sub.add_argument(
                "--weights", choices=("auto", "eigh", "chol", "lowrank"), default="auto",
                help="GP weight-root factorization (auto: lowrank at m' >= 1024)",
            )
    _add_scaled(subs)
    return parser


def _add_scaled(subs):
    sub = subs.add_parser(
        "scaled",
        help="production-scale pipeline (pipeline.scaled.run_scaled): randomized POD, "
        "batched GP fits, regularization search and ensemble at deployment shapes, with "
        "low-rank weight roots, blocked Tikhonov and time-windowed ROMs",
    )
    sub.add_argument("--n-space", type=int, default=6000,
                     help="full spatial dimension n (euler source: 3 nx lifted)")
    sub.add_argument("--k", type=int, default=10000, dest="n_snapshots",
                     help="training snapshots")
    sub.add_argument("--modes", type=int, default=30, dest="num_modes", help="POD modes r")
    sub.add_argument("--gp-samples", type=int, default=512, help="GP sample points m")
    sub.add_argument("--mprime", type=int, default=2048, help="regression points m'")
    sub.add_argument("--restarts", type=int, default=32, help="GP fit optimizer restarts")
    sub.add_argument("--ndraws", type=int, default=256, help="posterior ensemble draws")
    sub.add_argument("--grid-size", type=int, default=16, help="regularization grid size")
    sub.add_argument("--seed", type=int, default=0)
    sub.add_argument("--modelform", default="cA", help="ROM structure: cA | cAH")
    sub.add_argument("--source", choices=("synthetic", "euler"), default="synthetic",
                     dest="data_source", help="snapshot source (euler: the physical model)")
    sub.add_argument("--regularization", choices=("scalar", "blocked", "gamma"),
                     default="scalar",
                     help="one ridge lambda, a lambda per operator block, or a scaled "
                     "user-shaped Gamma (see --gamma)")
    sub.add_argument("--gamma", default="colnorm", dest="tikhonov_gamma",
                     help="Tikhonov shape for --regularization gamma: 'colnorm' (a diagonal "
                     "per row from the weighted data matrix's column norms) or a .npy file "
                     "holding (d,), (r, d), (d, d) or (r, d, d)")
    sub.add_argument("--windows", type=int, default=1, dest="time_windows",
                     help="W > 1: a separate ROM on each of W parts of the span; goes with "
                     "any --regularization")
    sub.add_argument("--chaining", choices=("draws", "mean", "anchor"), default="draws",
                     dest="window_chaining",
                     help="W > 1, the boundary scheme of the full-span rollout: draw-wise "
                     "propagation, ensemble-mean handoff, or GP re-anchoring")
    sub.add_argument("--window-basis", choices=("global", "local"), default="global",
                     dest="window_basis",
                     help="W > 1: one POD basis of the full span, or a basis per window "
                     "(local: not ported, raises)")
    sub.add_argument("--weights", choices=("auto", "eigh", "chol", "lowrank"), default="auto",
                     dest="weight_method",
                     help="GP weight-root factorization (eigh and chol: the dense root, "
                     "applied through its Cholesky factor)")
    sub.add_argument("--checkpoint-dir", help="checkpoint directory (not ported, raises)")
    sub.add_argument("--quiet", action="store_true")
    sub.add_argument("--device", default="cuda", help="torch device (default cuda)")


def run_scaled_args(args):
    """Run the scaled pipeline on parsed arguments; returns its result."""
    import numpy as np

    from .scaled import run_scaled

    gamma = None
    if args.regularization == "gamma":
        gamma = args.tikhonov_gamma
        if gamma.endswith(".npy"):
            gamma = np.load(gamma)
    return run_scaled(
        n_space=args.n_space, n_snapshots=args.n_snapshots, num_modes=args.num_modes,
        num_gp_samples=args.gp_samples, num_regression_points=args.mprime,
        n_restarts=args.restarts, ndraws=args.ndraws, grid_size=args.grid_size,
        seed=args.seed, modelform=args.modelform, data_source=args.data_source,
        regularization=args.regularization, time_windows=args.time_windows,
        window_chaining=args.window_chaining, window_basis=args.window_basis,
        tikhonov_gamma=gamma, weight_method=args.weight_method,
        checkpoint_dir=args.checkpoint_dir, verbose=not args.quiet, device=args.device,
    )


def scaled_summary(res) -> dict:
    """The JSON summary of a scaled run."""
    import numpy as np

    summary = {
        "regularizer": float(res.regularizer),
        "stable_fraction": float(res.stable_fraction),
        "train_error": float(res.train_error),
    }
    if res.regularizer_quad is not None:
        summary["regularizer_quad"] = float(res.regularizer_quad)
    if res.time_windows > 1:
        summary.update(
            time_windows=res.time_windows, chaining=res.chaining,
            window_basis=res.window_basis, window_error=float(res.window_error),
            chained_error_mean=float(res.chained_error_mean),
            chained_error_draws=float(res.chained_error_draws),
            window_regularizers=np.asarray(res.window_regularizers).tolist(),
        )
    return summary


def run(argv=None):
    """Parse ``argv`` and run the pipeline; returns its result object."""
    args = build_parser().parse_args(argv)
    if args.pipeline == "scaled":
        return run_scaled_args(args)
    common = dict(
        training_span=(0.0, args.t_max),
        num_samples=args.num_samples,
        noiselevel=args.noiselevel,
        num_regression_points=args.num_regression_points,
        gp_regularizer=args.gpreg,
        ndraws=args.ndraws,
        device=args.device,
    )
    if args.pipeline == "seird":
        from .odes import run_seird

        return run_seird(crosscheck=args.crosscheck, **common)
    if args.pipeline == "euler":
        from .pdes import run_euler

        return run_euler(
            num_pod_modes=args.numPODmodes, ddtdata=args.ddtdata,
            weight_method=args.weights, **common,
        )
    from .pdes_multi import run_heat_multi

    return run_heat_multi(num_pod_modes=args.numPODmodes, **common)


def main(argv=None) -> int:
    result = run(argv)
    if not hasattr(result, "valid"):  # a scaled run
        import json

        print(json.dumps(scaled_summary(result)))
        return 0
    print(f"chosen regularizer: {result.regularizer:.6e}")
    valid = result.valid.reshape(-1, result.valid.shape[-1])
    for ell, row in enumerate(valid):
        tag = f"trajectory {ell} " if valid.shape[0] > 1 else ""
        print(f"{tag}stable draws: {int(row.sum())}/{row.numel()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
