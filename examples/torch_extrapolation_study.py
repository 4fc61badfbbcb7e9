"""Euler extrapolation-quality study on the PyTorch port (the counterpart
of ``examples/extrapolation_study.py``).

Quantifies the ensemble mean's accuracy on the TRAINING domain t in
[0, t_train] against the EXTRAPOLATION domain t in (t_train, t_max], per
lifted variable (velocity u, pressure p, specific volume zeta = 1/rho)
and overall, for the paper workloads

    ex1a: 200 samples, 3% noise, m' = 400 (PDEs/experiments.sh:13)
    ex2a:  50 samples, 1% noise, m' = 400 (PDEs/experiments.sh:22)

and writes ``<outdir>/extrapolation_study.md`` (the table, each run's
wall beside the card's name and power limit, and the findings set beside
``docs/extrapolation_study.md``'s), ``extrapolation_study.json`` (the
numbers it was written from) and, unless ``--no-figures``, the per-time
error figure ``extrapolation_error.png``::

    python examples/torch_extrapolation_study.py [--outdir docs/torch] [--ndraws 400]
        [--device cuda] [--no-figures]
    python examples/torch_extrapolation_study.py --from-json docs/torch/extrapolation_study.json

``--from-json`` writes the document and the figure again from a saved
study without running it, so a study run on a card without matplotlib is
drawn where matplotlib is.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gp_bayesopinf_torch.pipeline.pdes import run_euler  # noqa: E402
from gp_bayesopinf_torch.utils.device import to_host  # noqa: E402
from gp_bayesopinf_torch.utils.reporting import card_line, require_figures  # noqa: E402

WORKLOADS = {
    "ex1a": dict(num_samples=200, noiselevel=0.03),
    "ex2a": dict(num_samples=50, noiselevel=0.01),
}
T_TRAIN = 0.06
DOMAINS, VARIABLES = ("train", "extrap", "full"), ("u", "p", "zeta", "all")

#: docs/extrapolation_study.md's table (the JAX package, 400 draws):
#: workload -> (lambda, stable draws, {domain: error over all variables}).
JAX_DOC = {
    "ex1a": (3.162e-10, 325, {"train": 0.0039, "extrap": 0.0161, "full": 0.0127}),
    "ex2a": (3.168e-02, 360, {"train": 0.0034, "extrap": 0.0185, "full": 0.0145}),
}


def ensemble_mean(result):
    """Mean over the stable decompressed draws: (n, k)."""
    return np.mean(to_host(result.draws), axis=0)


def domain_errors(result, t_train):
    """Relative L2 errors split by domain and lifted variable."""
    t = np.asarray(result.time_domain)
    truth = to_host(result.true_states)
    mean = ensemble_mean(result)
    n = truth.shape[0]
    nx = n // 3
    segments = {"u": slice(0, nx), "p": slice(nx, 2 * nx),
                "zeta": slice(2 * nx, 3 * nx), "all": slice(0, n)}
    domains = {
        "train": t <= t_train + 1e-12,
        "extrap": t > t_train + 1e-12,
        "full": np.ones_like(t, dtype=bool),
    }
    errs = {}
    for dname, tmask in domains.items():
        for sname, seg in segments.items():
            T, M = truth[seg][:, tmask], mean[seg][:, tmask]
            errs[(dname, sname)] = float(
                np.linalg.norm(M - T) / np.linalg.norm(T)
            )
    return errs


def per_time_error(result):
    """The ensemble mean's relative error at each prediction time: (k,)."""
    truth = to_host(result.true_states)
    denom = np.linalg.norm(truth, axis=0)
    return np.linalg.norm(ensemble_mean(result) - truth, axis=0) / np.maximum(denom, 1e-300)


def run_workload(name, *, device, ndraws=400, verbose=True):
    """One workload of the study on ``device``: (EulerResult, wall seconds)."""
    t0 = time.perf_counter()
    res = run_euler(
        training_span=(0.0, T_TRAIN), num_regression_points=400, num_pod_modes=6,
        ndraws=ndraws, verbose=verbose, device=device, **WORKLOADS[name],
    )
    to_host(res.valid)  # waits for the device
    return res, time.perf_counter() - t0


def summarize(name, res, wall):
    """One workload's row of the study, as plain numbers."""
    errs = domain_errors(res, T_TRAIN)
    return {
        "workload": name, "lambda": float(res.regularizer),
        "stable": int(to_host(res.valid).sum()), "ndraws": int(res.valid.shape[0]),
        "wall_s": wall,
        "errors": {f"{d}/{v}": errs[(d, v)] for d in DOMAINS for v in VARIABLES},
        "t": np.asarray(res.time_domain).tolist(), "per_time": per_time_error(res).tolist(),
    }


def compute(*, device, ndraws=400):
    """Run the study's workloads on ``device``; returns the study as plain
    numbers (``write_report``'s input)."""
    rows = []
    for name in WORKLOADS:
        res, wall = run_workload(name, device=device, ndraws=ndraws)
        rows.append(summarize(name, res, wall))
        del res
    return {"card": card_line(device), "device": str(device), "ndraws": ndraws,
            "t_train": T_TRAIN, "rows": rows}


def study_figure(study, path):
    """Per-time relative error curves, training cutoff marked."""
    plt = require_figures()
    fig, ax = plt.subplots(figsize=(7.0, 3.2), constrained_layout=True)
    for row in study["rows"]:
        ax.semilogy(row["t"], row["per_time"], label=row["workload"], linewidth=1.2)
    t_train = study["t_train"]
    ax.axvline(t_train, color="k", linestyle="--", linewidth=0.8)
    ax.text(t_train, ax.get_ylim()[1], " training cutoff", va="top", fontsize=8)
    ax.set_xlabel("t")
    ax.set_ylabel("relative error of ensemble mean")
    ax.legend(loc="upper left", fontsize=8)
    fig.savefig(path, dpi=150)
    plt.close(fig)


def verdict(port, jax, factor=2.0):
    """``held`` where the port's number is within ``factor`` of the JAX
    document's either way, else ``moved``."""
    return "held" if jax / factor <= port <= jax * factor else "moved"


def findings(study):
    """The findings, each set beside docs/extrapolation_study.md's."""
    rows = {r["workload"]: r for r in study["rows"]}
    out = []
    for name, row in rows.items():
        e = row["errors"]
        lam, stable, jerr = JAX_DOC[name]
        marks = ", ".join(
            f"{d} {e[d + '/all']:.4f} against {jerr[d]:.4f} ({verdict(e[d + '/all'], jerr[d])})"
            for d in DOMAINS
        )
        out.append(
            f"- **{name}**: lambda {row['lambda']:.3e} (JAX {lam:.3e}), "
            f"{row['stable']}/{row['ndraws']} stable (JAX {stable}/400); "
            f"error over all variables: {marks}. Held means within 2x either way."
        )
    train = [r["errors"]["train/all"] for r in rows.values()]
    extrap = [r["errors"]["extrap/all"] for r in rows.values()]
    zeta = [r["errors"]["extrap/zeta"] for r in rows.values()]
    worse = all(x > t for x, t in zip(extrap, train))
    out.append(
        "- JAX finding: training-domain accuracy ~0.3-0.5%, degrading to "
        "~1-2% overall (~3% for zeta) past the cutoff. Port: training "
        f"{min(train):.2%}-{max(train):.2%}, extrapolation {min(extrap):.2%}-"
        f"{max(extrap):.2%} ({min(zeta):.2%}-{max(zeta):.2%} for zeta); "
        + ("extrapolation is worse than training in every workload, as in the JAX study."
           if worse else "extrapolation is NOT worse than training in every workload.")
    )
    lams = [r["lambda"] for r in rows.values()]
    out.append(
        "- The lambda each run lands at differs from the JAX study's: the port's "
        "random streams (one torch.Generator a stage, from SeedSequence) are not "
        "JAX's threefry keys, so the data instance and the 20-draw screens differ, "
        f"and lambda moves with them (here {', '.join(f'{x:.3e}' for x in lams)}; "
        "docs/torch/ex1a_stability_study.md measures how far the error depends on it)."
    )
    return out


def write_report(study, outdir, figures=True):
    """Write ``extrapolation_study.md`` and ``.json`` (and the figure unless
    ``figures`` is false) into ``outdir``; returns the document's path."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "extrapolation_study.json"), "w") as fh:
        json.dump(study, fh)
    if figures:
        study_figure(study, os.path.join(outdir, "extrapolation_error.png"))
    lines = [
        "# Euler extrapolation-quality study (PyTorch port)",
        "",
        "Ensemble-mean relative L2 error of the port's Euler pipeline",
        "(`gp_bayesopinf_torch.pipeline.run_euler`), split into the training",
        f"domain t in [0, {study['t_train']}] and the extrapolation domain",
        f"t in ({study['t_train']}, 0.15], per lifted variable (velocity u,",
        "pressure p, zeta = 1/rho). The JAX package's study is",
        "`docs/extrapolation_study.md`.",
        "",
        f"Run on `{study['device']}`: {study['card']}; {study['ndraws']} draws a workload.",
        "",
        "| workload | lambda* | stable draws | wall (s) | domain | u | p | zeta | all |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for row in study["rows"]:
        e = row["errors"]
        for dom in DOMAINS:
            lines.append(
                f"| {row['workload']} | {row['lambda']:.3e} | {row['stable']}/{row['ndraws']} | "
                f"{row['wall_s']:.2f} | {dom} | "
                + " | ".join(f"{e[f'{dom}/{v}']:.4f}" for v in VARIABLES) + " |"
            )
    if figures:
        lines += ["", "![per-time error](extrapolation_error.png)"]
    lines += [
        "",
        "Walls: `run_euler` start to finish in one process, the first run paying",
        "the process's first GP fit; the card's name and power limit are above.",
        "",
        "## Findings",
        "",
        *findings(study),
        "",
        "Reproduce: `python examples/torch_extrapolation_study.py --outdir docs/torch` "
        "(`--no-figures` where matplotlib is missing, then `--from-json` where it is).",
    ]
    out = os.path.join(outdir, "extrapolation_study.md")
    with open(out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--outdir", default=os.path.join("docs", "torch"))
    parser.add_argument("--ndraws", type=int, default=400)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--no-figures", action="store_true", help="skip matplotlib entirely")
    parser.add_argument("--from-json", metavar="PATH",
                        help="write the report from a saved study instead of running it")
    args = parser.parse_args(argv)
    if not args.no_figures:
        require_figures()
    if args.from_json:
        with open(args.from_json) as fh:
            study = json.load(fh)
    else:
        study = compute(device=args.device, ndraws=args.ndraws)
    for row in study["rows"]:
        print(json.dumps({k: v for k, v in row.items() if k not in ("t", "per_time")}))
    write_report(study, args.outdir, figures=not args.no_figures)


if __name__ == "__main__":
    main()
