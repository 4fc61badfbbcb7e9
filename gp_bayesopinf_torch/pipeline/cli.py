"""Command-line interface (counterpart of
``gp_bayesopinf_tpu/pipeline/cli.py``), installed as ``gpboi-torch``::

    gpboi-torch seird T_MAX NUM_SAMPLES NOISE NUM_PTS [--ndraws N] [--gpreg ETA] \\
        [--crosscheck] [--exportto PREFIX] [--profile LOGDIR] [--nolog] [--device DEVICE]
    gpboi-torch euler T_MAX NUM_SAMPLES NOISE NUM_PTS NUM_MODES [--weights ROOT] \\
        [--ddtdata] ... (the flags of seird but --crosscheck)
    gpboi-torch heat T_MAX NUM_SAMPLES NOISE NUM_PTS NUM_MODES ...
    gpboi-torch scaled [--source euler] [--windows W] [--regularization blocked] \\
        [--weights lowrank] [--checkpoint-dir DIR] ... [--device DEVICE]
    gpboi-torch serve
    gpboi-torch warmup [seird euler heat] [--ndraws N] [--device DEVICE]

(or ``python -m gp_bayesopinf_torch.pipeline.cli ...``). ``scaled`` is the
production-scale pipeline (``pipeline.scaled.run_scaled``; its defaults
are n = 6000, 10,000 snapshots, 30 modes, m' = 2048) and prints a JSON
summary line. The paper's runs are ``seird 90 90 0.10 360`` (ODE ex1a),
``euler 0.06 200 0.03 400 6`` (ex1a; ex1c with 3200 points) and ``heat 1.0
20 0.05 80 5`` (ex3), each with ``--ndraws 600``. ``--device`` defaults to
``cuda`` and does not fall back to the CPU.

A ``seird``, ``euler`` or ``heat`` run keeps the reference's records
unless ``--nolog``: ``log.log`` in the working directory, a dated folder
``figures/<monthday>/<H-M-S>`` with ``report.txt`` (for ``seird`` with the
posterior summary). ``--exportto PREFIX`` writes the HDF5 files of
``io.hdf5.export_result`` (needs ``h5py``); ``--profile LOGDIR`` records a
``torch.profiler`` trace of the run (``utils.timing.profile_trace``);
``--noopen`` is accepted and does nothing, as in the reference.

``run(argv)`` returns a run's result object; ``main(argv)`` keeps the
records, prints and returns 0 (the console script's exit code).
"""

import argparse
import sys

#: The workload that ``warmup`` runs for each pipeline.
FLAGSHIP = {"seird": "ex1a", "euler": "ex1a", "heat": "ex3"}


def _add_records(sub):
    sub.add_argument("--exportto", metavar="PREFIX", help="HDF5 export prefix (needs h5py)")
    sub.add_argument("--noopen", action="store_true", help="do not open figures (no effect)")
    sub.add_argument("--profile", metavar="LOGDIR",
                     help="record a torch.profiler trace of the run into LOGDIR")
    sub.add_argument("--nolog", action="store_true",
                     help="skip the log.log / figures folder / report.txt records")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gpboi-torch",
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
        _add_records(sub)
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
    subs.add_parser(
        "serve",
        help="one resident process: read one command per stdin line (plain argv text or "
        'a JSON {"argv": [...]} object), run it in this process and print one JSON ack '
        "line after it; 'quit', 'exit' or end of input ends the session",
    )
    warm = subs.add_parser(
        "warmup",
        help="build the kernel libraries and run the flagship workloads once "
        "(see _warmup for what this does and does not do for a later process)",
    )
    # No list default: argparse checks a list default of nargs="*" against
    # the choices as one value and rejects it.
    warm.add_argument("pipelines", nargs="*", choices=list(FLAGSHIP),
                      help="which pipelines to run (default: all three)")
    warm.add_argument("--ndraws", type=int, default=600,
                      help="posterior draws (the paper's grids use 600)")
    warm.add_argument("--device", default="cuda", help="torch device (default cuda)")
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
    sub.add_argument("--checkpoint-dir",
                     help="save the front half (data, POD, GP fit) here, or resume from it")
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


def _run_pipeline(args):
    """Run the seird, euler or heat pipeline of parsed arguments, under
    ``profile_trace`` when ``--profile`` is given."""
    import contextlib

    common = dict(
        training_span=(0.0, args.t_max),
        num_samples=args.num_samples,
        noiselevel=args.noiselevel,
        num_regression_points=args.num_regression_points,
        gp_regularizer=args.gpreg,
        ndraws=args.ndraws,
        device=args.device,
    )
    if args.profile:
        from ..utils.timing import profile_trace

        profile = profile_trace(args.profile, args.device)
    else:
        profile = contextlib.nullcontext()
    with profile:
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


def run(argv=None):
    """Parse ``argv`` and run the pipeline (``--profile`` included);
    returns its result object. ``serve`` and ``warmup`` are not runs:
    ``main`` takes them."""
    args = build_parser().parse_args(argv)
    if args.pipeline in ("serve", "warmup"):
        raise ValueError(f"'{args.pipeline}' is not a pipeline run; call main")
    if args.pipeline == "scaled":
        return run_scaled_args(args)
    return _run_pipeline(args)


def _records_before(args):
    """The records a run starts with, in the reference's order: the
    log file, the dated figures folder and the scenario report. Returns
    the folder."""
    import logging

    from ..utils.logging import setup_logging
    from .report import figures_path, summarize_experiment

    setup_logging()
    folder = figures_path()
    summarize_experiment(
        training_span=(0.0, args.t_max),
        num_samples=args.num_samples,
        noiselevel=args.noiselevel,
        num_regression_points=args.num_regression_points,
        numPODmodes=getattr(args, "numPODmodes", None),
        gp_regularizer=args.gpreg,
        ndraws=args.ndraws,
        folder=folder,
    )
    logging.info(
        f"gpboi-torch {args.pipeline} t_max={args.t_max} m={args.num_samples} "
        f"noise={args.noiselevel} m'={args.num_regression_points} ndraws={args.ndraws} "
        f"device={args.device}"
    )
    return folder


def main(argv=None) -> int:
    """Run a command of ``build_parser``: a pipeline run with its records,
    printout and export, ``scaled`` with its JSON summary, ``serve`` or
    ``warmup``. Returns 0; a failure raises."""
    import logging

    args = build_parser().parse_args(argv)
    if args.pipeline == "serve":
        return _serve()
    if args.pipeline == "warmup":
        return _warmup(args.pipelines or list(FLAGSHIP), args.ndraws, args.device)
    if args.pipeline == "scaled":
        import json

        print(json.dumps(scaled_summary(run_scaled_args(args))), flush=True)
        return 0

    if args.exportto:  # fail before the run, not after it
        from ..io.hdf5 import require_h5py

        require_h5py()
    folder = None if args.nolog else _records_before(args)
    result = _run_pipeline(args)
    print(f"chosen regularizer: {result.regularizer:.6e}")
    valid = result.valid.reshape(-1, result.valid.shape[-1])
    for ell, row in enumerate(valid):
        tag = f"trajectory {ell} " if valid.shape[0] > 1 else ""
        print(f"{tag}stable draws: {int(row.sum())}/{row.numel()}")
    if not args.nolog:
        logging.info(f"chosen regularizer: {result.regularizer:.6e}")
        if args.pipeline == "seird":
            from .report import summarize_posterior

            summarize_posterior(result.model.parameters, result.bayesian_model, folder)
    if args.exportto:
        from ..io.hdf5 import export_result

        export_result(result, args.exportto)
        print(f"exported artifacts with prefix {args.exportto}")
        if not args.nolog:
            logging.info(f"artifacts exported with prefix {args.exportto}")
    sys.stdout.flush()
    return 0


def _decode_request(line: str):
    """The argv of one ``serve`` request line: a JSON object with an
    "argv" list, a JSON list, or plain text split like a shell. Raises
    ValueError for anything else."""
    import json
    import shlex

    try:
        req = json.loads(line)
    except json.JSONDecodeError:
        return shlex.split(line)
    if isinstance(req, dict):
        if "argv" not in req:
            raise ValueError('a JSON request needs an "argv" list')
        req = req["argv"]
    if not isinstance(req, list) or not req:
        raise ValueError("argv must be a non-empty list")
    return [str(a) for a in req]


def _serve() -> int:
    """One resident process answering commands from stdin.

    Every process pays a first-run cost that later runs do not: CUDA's
    context, cuBLAS and cuSOLVER set-up, the first GP fit and the loading
    of the kernel libraries. ``serve`` pays it once for many runs.

    Protocol: one command per line, plain argv text (``seird 90 90 0.10
    360 --ndraws 600 --nolog``) or JSON (``{"argv": ["seird", ...]}``).
    Blank lines and ``#`` lines are skipped; ``quit``, ``exit`` or end of
    input ends the session, with 0. After each command's own output comes
    one flushed JSON ack line, ``{"serve": {"rc": ..., "wall_s": ...,
    "argv": [...], "launches": {...}}}``, with ``"error"`` on failure: rc
    2 for a request that does not decode (``"argv": null``), a nested
    ``serve`` or argv that the parser rejects, rc 1 for a run that raised.
    No failed command ends the server. ``launches`` counts the screen
    kernels' launches during the command (the wrappers' counters).
    """
    import json
    import time

    from ..ops import cahbn_screen, ensemble_screen

    def counts():
        return {"quadratic_ensemble_screen": ensemble_screen.launches,
                "cahbn_ensemble_screen": cahbn_screen.launches}

    for line in sys.stdin:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line in ("quit", "exit"):
            break
        t0, before = time.perf_counter(), counts()
        argv = None
        try:
            argv = _decode_request(line)
        except ValueError as exc:
            ack = {"rc": 2, "error": f"bad request: {exc}"}
        else:
            if argv[:1] == ["serve"]:
                ack = {"rc": 2, "error": "cannot nest serve"}
            else:
                try:
                    ack = {"rc": int(main(argv) or 0)}
                except SystemExit as exc:  # the parser rejected argv
                    ack = {"rc": exc.code if isinstance(exc.code, int) else 2,
                           "error": "argparse rejected argv"}
                except Exception as exc:  # the run failed; keep serving
                    ack = {"rc": 1, "error": repr(exc)}
        ack["wall_s"] = time.perf_counter() - t0
        ack["argv"] = argv
        ack["launches"] = {name: n - before[name] for name, n in counts().items()}
        print(json.dumps({"serve": ack}), flush=True)
    return 0


def _warmup(pipelines, ndraws: int, device) -> int:
    """Build the kernel libraries, then run each pipeline's flagship
    workload once (``experiments.run_workload``: SEIRD ex1a, Euler ex1a,
    heat ex3) on ``device``.

    What persists for a later process is the kernel build: each
    ``csrc/*.cu`` library stays under ``build/gp_bayesopinf_torch/``, keyed
    by a hash of its source, and a later process loads it without
    ``nvcc``. What does not persist is everything else of a process's
    first run: the CUDA context, cuBLAS and cuSOLVER set-up, and the first
    GP fit; no compile cache stands behind them. Run ``warmup`` as the
    first command of ``serve`` to pay that once for the server's later
    runs.
    """
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.device import resolve_device
    from .experiments import run_workload

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops.build import build

        names = ("quadratic_screen", "cahbn_screen")
        with ThreadPoolExecutor(len(names)) as pool:
            for info in pool.map(build, names):
                how = f"built in {info.seconds:.1f} s" if info.seconds else "already built"
                print(f"[warmup] kernel library {info.path} {how}", flush=True)
    for name in pipelines:
        t0 = time.perf_counter()
        print(f"[warmup] {name} {FLAGSHIP[name]} (ndraws={ndraws}) on {dev} ...", flush=True)
        run_workload(name, FLAGSHIP[name], ndraws=ndraws, device=dev, verbose=False)
        print(f"[warmup] {name} done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
