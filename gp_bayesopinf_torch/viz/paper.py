"""Artifact-driven figure regeneration (counterpart of
``gp_bayesopinf_tpu/viz/paper.py``; reference ``*/plots_paper.py``).

Each function reloads the HDF5 artifacts exported by the pipelines
(``gp_bayesopinf_torch.io.hdf5.export_result``, which writes the JAX
package's schema) and draws a composite figure, so the paper's
figures are reproducible from artifacts alone — the reference's L5 layer
and its schema-regression check (SURVEY.md section 4, golden artifacts).
"""

import os
from typing import Optional, Sequence

import numpy as np
import h5py
import matplotlib.pyplot as plt

from .baseplots import COLORS, BasePlotter
from .plotters import ODEPlotter, ReducedPlotter

NUMDRAWS_FIGURES = 500  # the reference uses 500 of the exported 600 draws


def _load(path):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return h5py.File(path, "r")


def seird_figure(prefix: str, savedir: Optional[str] = None):
    """GP fits + posterior bands for a SEIRD run (``<prefix>_data.h5``)."""
    with _load(f"{prefix}_data.h5") as hf:
        p = ODEPlotter(
            hf["sampling_time_domain"][:],
            hf["training_time_domain"][:],
            hf["prediction_time_domain"][:],
            hf["snapshots"][:],
            hf["true_states"][:],
            hf["gp_means"][:],
            hf["gp_stds"][:],
            hf["draws"][:][:NUMDRAWS_FIGURES],
        )
    figs = {
        "seird_train": p.plot_gp_training_fit(),
        "seird_posterior": p.plot_posterior(),
        "seird_draws": p.plot_posterior(individual=True),
    }
    return _save_or_return(figs, savedir)


def euler_reduced_figure(prefix: str, savedir: Optional[str] = None):
    """Reduced-space GP fits and posterior for an Euler run
    (``<prefix>_data-reduced.h5``)."""
    with _load(f"{prefix}_data-reduced.h5") as hf:
        valid = hf["draws_valid"][:].astype(bool)
        draws = hf["draws_compressed"][:][valid][:NUMDRAWS_FIGURES]
        p = ReducedPlotter(
            hf["sampling_time_domain"][:],
            hf["training_time_domain"][:],
            hf["prediction_time_domain"][:],
            hf["snapshots_compressed"][:],
            None,  # compressed truth is not part of the reduced artifact
            hf["gp_means"][:],
            hf["gp_stds"][:],
            draws,
        )
    figs = {
        "euler_train": p.plot_gp_training_fit(width=3),
        "euler_posterior": p.plot_posterior(),
    }
    return _save_or_return(figs, savedir)


def euler_ddt_figure(prefix: str, savedir: Optional[str] = None, maxmodes=4):
    """Derivative-estimate comparison: GP mean/band vs finite differences
    vs intrusive truth (reference ``PDEs/plots_paper.py:440-542``,
    consuming ``<prefix>-ddtdata.h5``)."""
    with _load(f"{prefix}-ddtdata.h5") as hf:
        t_fd = hf["time_domain_FD"][:]
        fd = hf["ddts_finitedifferences"][:]
        t_gp = hf["time_domain_GP"][:]
        gp_mean = hf["ddts_GPmean"][:]
        gp_std = hf["ddts_GPstd"][:]
        t_truth = hf["time_domain_truth"][:]
        truth = hf["ddts_truth"][:]

    r = min(gp_mean.shape[0], maxmodes)
    fig, axes = plt.subplots(r, 1, figsize=(8, 2 * r), sharex=True)
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(t_truth, truth[i], color=COLORS["truth"], lw=1.2, label="truth")
        ax.plot(t_fd, fd[i], "o", color=COLORS["data"], ms=2.5,
                label="finite differences")
        ax.plot(t_gp, gp_mean[i], color=COLORS["gp"], lw=1.0, label="GP mean")
        ax.fill_between(
            t_gp, gp_mean[i] - 3 * gp_std[i], gp_mean[i] + 3 * gp_std[i],
            color=COLORS["gp"], alpha=0.25, lw=0,
        )
        ax.set_ylabel(rf"$d\hat{{q}}_{{{i + 1}}}/dt$")
    np.atleast_1d(axes)[0].legend(loc="best", fontsize="small")
    np.atleast_1d(axes)[-1].set_xlabel("$t$")
    return _save_or_return({"euler_ddt": fig}, savedir)


def svdval_decay_figure(prefix: str, savedir: Optional[str] = None):
    """Singular-value decay from the ``<prefix>-svdvals.npy`` side export."""
    svdvals = np.load(f"{prefix}-svdvals.npy")
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.semilogy(
        np.arange(1, svdvals.size + 1), svdvals / svdvals[0],
        "o-", ms=3, color=COLORS["samplemean"],
    )
    ax.set_xlim(right=min(20, svdvals.size))
    ax.set_ylim(bottom=1e-4)
    ax.set_xlabel("index")
    ax.set_ylabel("normalized singular value")
    return _save_or_return({"svdvals": fig}, savedir)


def heat_multi_figure(prefix: str, savedir: Optional[str] = None):
    """Per-trajectory posterior bands for the multi-trajectory run
    (``<prefix>_data.h5``)."""
    figs = {}
    with _load(f"{prefix}_data.h5") as hf:
        t_s = hf["sampling_time_domain"][:]
        t_tr = hf["training_time_domain"][:]
        t_pr = hf["prediction_time_domain"][:]
        ells = sorted(
            int(k.split("_")[1]) for k in hf.keys() if k.startswith("trajectory_")
        )
        for ell in ells:
            grp = hf[f"trajectory_{ell}"]
            draws = grp["draws_compressed"][:]
            valid = grp["draws_valid"][:].astype(bool)
            draws = draws[valid][:NUMDRAWS_FIGURES]
            comp = grp["snapshots_compressed"][:]
            plotter = BasePlotter(t_s, t_tr, t_pr)
            r = comp.shape[0]
            fig, axes = plt.subplots(r, 1, figsize=(8, 1.8 * r), sharex=True)
            for i, ax in enumerate(np.atleast_1d(axes)):
                plotter.plot_data(ax, comp[i])
                if draws.size:
                    plotter.plot_percentiles(ax, draws[:, i, :])
                    plotter.plot_samplemean(ax, draws[:, i, :].mean(axis=0))
                ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}$")
            np.atleast_1d(axes)[-1].set_xlabel("$t$")
            figs[f"heat_traj{ell}"] = fig
    return _save_or_return(figs, savedir)


def comparison_reduced_figure(
    prefixes: Sequence[str],
    labels: Sequence[str],
    mode: int = 0,
    savedir: Optional[str] = None,
):
    """Side-by-side posterior bands for one reduced mode across several
    runs (the reference's noise/sparsity comparison figures,
    ``PDEs/plots_paper.py:966-1053``; e.g. m' in {50, 400, 3200} or
    noise in {1%, 3%, 5%})."""
    n = len(prefixes)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.2 * n), sharex=True)
    for ax, prefix, label in zip(np.atleast_1d(axes), prefixes, labels):
        with _load(f"{prefix}_data-reduced.h5") as hf:
            t_pr = hf["prediction_time_domain"][:]
            t_tr = hf["training_time_domain"][:]
            valid = hf["draws_valid"][:].astype(bool)
            draws = hf["draws_compressed"][:][valid][:NUMDRAWS_FIGURES]
            snaps = hf["snapshots_compressed"][:]
            t_s = hf["sampling_time_domain"][:]
        p = BasePlotter(t_s, t_tr, t_pr)
        p.plot_data(ax, snaps[mode])
        if draws.size:
            p.plot_percentiles(ax, draws[:, mode, :])
            p.plot_samplemean(ax, draws[:, mode, :].mean(axis=0))
        ax.set_ylabel(label)
    np.atleast_1d(axes)[-1].set_xlabel("$t$")
    return _save_or_return({f"comparison_mode{mode}": fig}, savedir)


def comparison_full_figure(
    prefixes: Sequence[str],
    labels: Sequence[str],
    spatial_index: int,
    variable: int = 0,
    savedir: Optional[str] = None,
):
    """Full-state posterior comparison at one spatial point across runs
    (``PDEs/plots_paper.py:1056-1152``)."""
    n = len(prefixes)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.2 * n), sharex=True)
    for ax, prefix, label in zip(np.atleast_1d(axes), prefixes, labels):
        with _load(f"{prefix}_data-full.h5") as hf:
            t_pr = hf["prediction_time_domain"][:]
            t_s = hf["sampling_time_domain"][:]
            truth = hf["true_states"][:]
            draws = hf["draws"][:][:NUMDRAWS_FIGURES]
        nx = truth.shape[0] // 3 if truth.shape[0] % 3 == 0 else truth.shape[0]
        row = variable * nx + spatial_index
        p = BasePlotter(t_s, t_s, t_pr)
        p.plot_truth(ax, truth[row])
        if draws.size:
            p.plot_percentiles(ax, draws[:, row, :])
            p.plot_samplemean(ax, draws[:, row, :].mean(axis=0))
        ax.set_ylabel(label)
    np.atleast_1d(axes)[-1].set_xlabel("$t$")
    return _save_or_return({f"comparison_x{spatial_index}": fig}, savedir)


# ---- Euler composites (reference ``PDEs/plots_paper.py``) ---------------------
def _reduced_plotter(prefix):
    with _load(f"{prefix}_data-reduced.h5") as hf:
        valid = hf["draws_valid"][:].astype(bool)
        return ReducedPlotter(
            hf["sampling_time_domain"][:],
            hf["training_time_domain"][:],
            hf["prediction_time_domain"][:],
            hf["snapshots_compressed"][:],
            hf["true_states_compressed"][:]
            if "true_states_compressed" in hf else None,
            hf["gp_means"][:],
            hf["gp_stds"][:],
            hf["draws_compressed"][:][valid][:NUMDRAWS_FIGURES],
        )


def _full_arrays(prefix):
    with _load(f"{prefix}_data-full.h5") as hf:
        out = {k: hf[k][:] for k in hf.keys()}
        out["num_variables"] = int(hf.attrs.get("num_variables", 3))
    return out


def euler_fomdata_figure(
    prefix: str,
    init_params=None,
    nlocs: int = 4,
    savedir: Optional[str] = None,
):
    """Full-order data composite: initial-condition profiles (left column,
    with the spline knots when ``init_params`` is given) next to the truth
    + noisy observations at ``nlocs`` spatial points, colored by location
    (reference ``PDEs/plots_paper.py:162-285``)."""
    import matplotlib.colors as mcolors

    data = _full_arrays(prefix)
    x = data["spatial_domain"]
    truth = data["true_states"]
    snaps = data["snapshots"]
    t_pred = data["prediction_time_domain"]
    t_data = data["sampling_time_domain"]
    t_train_end = data["training_time_domain"][-1]
    end = int(np.searchsorted(t_pred, t_train_end, "right"))

    nx = truth.shape[0] // 3
    rows = np.linspace(0, nx - 1, nlocs).astype(int)
    var_names = ("Velocity", "Pressure", "$1/$Density")

    fig = plt.figure(constrained_layout=True, figsize=(12, 5))
    spec = fig.add_gridspec(
        nrows=3, ncols=2, width_ratios=[0.5, 1.5], hspace=0.05, wspace=0.025
    )
    axes = np.array(
        [[fig.add_subplot(spec[i, j]) for j in range(2)] for i in range(3)]
    )

    # Left column: initial conditions over space (+ knots).
    ics = truth[:, 0]
    L = x[-1] - x[0] + (x[1] - x[0])
    for i in range(3):
        axes[i, 0].plot(x, np.split(ics, 3)[i], lw=1, color="#a92c00")
        axes[i, 0].set_ylabel(var_names[i])
        axes[i, 0].set_xlim(x[0], x[0] + L)
    if init_params is not None:
        nodes = x[0] + np.array([0.0, L / 3, 2 * L / 3, L])
        knots = list(init_params)
        dots = dict(ls="none", color="black", marker="^", ms=5)
        axes[0, 0].plot(nodes, knots[3:] + [knots[3]], **dots)
        axes[2, 0].plot(
            nodes, 1.0 / np.array(knots[:3] + [knots[0]]), **dots
        )
    axes[0, 0].set_title("Initial conditions")
    axes[-1, 0].set_xlabel("$x$")

    # Right column: truth + observations at the selected points.
    colors = plt.cm.tab10(np.linspace(0, 1, nlocs + 1)[:-1])
    for i in range(3):
        tr = np.split(truth, 3)[i]
        sn = np.split(snaps, 3)[i]
        for c, j in zip(colors, rows):
            axes[i, 1].plot(t_pred[:end], tr[j, :end], "--", lw=0.75, color=c)
            axes[i, 1].plot(t_data, sn[j], "*", ms=5, color=c)
        axes[i, 1].set_yticklabels([])
        axes[i, 0].set_ylim(axes[i, 1].get_ylim())
    axes[0, 1].set_title("Snapshot data")
    axes[-1, 1].set_xlabel("$t$")

    mappable = plt.cm.ScalarMappable(
        norm=mcolors.Normalize(vmin=0, vmax=1),
        cmap=mcolors.LinearSegmentedColormap.from_list(
            "euler", colors, N=nlocs
        ),
    )
    cbar = fig.colorbar(mappable, ax=axes[:, 1:], pad=0.015)
    cbar.set_ticks(np.linspace(0, 1, 2 * nlocs + 1)[1::2])
    cbar.set_ticklabels([f"{x[j]:.1f}" for j in rows])
    cbar.set_label("Spatial coordinate")
    return _save_or_return({"euler_fomdata": fig}, savedir)


def euler_gpfit_figure(prefix: str, savedir: Optional[str] = None):
    """3x2 grid of GP fits per mode: compressed truth, observations, GP
    mean +/- 3 sigma (reference ``PDEs/plots_paper.py:288-348``)."""
    p = _reduced_plotter(prefix)
    r = p.gp_means.shape[0]
    nrows = (r + 1) // 2
    fig, axes = plt.subplots(nrows, 2, figsize=(12, 1.7 * nrows), sharex=True)
    end = p.end_train_index
    for i, ax in enumerate(np.atleast_1d(axes).flat):
        if i >= r:
            ax.axis("off")
            continue
        if p.true_states_compressed is not None:
            ax.plot(
                p.prediction_time_domain[:end],
                p.true_states_compressed[i, :end],
                color=COLORS["truth"], lw=1.2, label="truth",
            )
        p.plot_data(ax, p.snapshots_compressed[i])
        p.plot_gp(ax, p.gp_means[i], p.gp_stds[i], width=3)
        ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
    fig.axes[0].legend(loc="best", fontsize="small")
    return _save_or_return({"euler_gpfit": fig}, savedir)


def euler_dimension_figure(
    prefix: str, modes=(4, 5, 6), savedir: Optional[str] = None
):
    """Dimension study: singular-value decay (left) + GP fits of the
    trailing modes (right), the r=6-vs-r=8 evidence figure (reference
    ``PDEs/plots_paper.py:350-437``; expects an r=8 run's artifacts)."""
    p = _reduced_plotter(prefix)
    svdvals = np.load(f"{prefix}-svdvals.npy")

    fig = plt.figure(figsize=(12, 4.5))
    spec = fig.add_gridspec(
        nrows=len(modes), ncols=2, hspace=0.15, wspace=0.3
    )
    axbig = fig.add_subplot(spec[:, 0])
    axbig.semilogy(
        np.arange(svdvals.size) + 1, svdvals / svdvals[0],
        "o-", color="tab:blue", lw=0.5, ms=5,
    )
    axbig.set_xlabel("Singular value index")
    axbig.set_ylabel("Normalized singular value")
    axbig.set_xlim(0, min(20.5, svdvals.size + 0.5))

    end = p.end_train_index
    for row, i in enumerate(modes):
        ax = fig.add_subplot(spec[row, 1])
        if p.true_states_compressed is not None:
            ax.plot(
                p.prediction_time_domain[:end],
                p.true_states_compressed[i, :end],
                color=COLORS["truth"], lw=1.2,
            )
        p.plot_data(ax, p.snapshots_compressed[i])
        p.plot_gp(ax, p.gp_means[i], p.gp_stds[i], width=3)
        ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
        if row < len(modes) - 1:
            ax.set_xticklabels([])
    fig.axes[-1].set_xlabel("$t$")
    return _save_or_return({"euler_dims": fig}, savedir)


def euler_gpfit_and_derivatives_figure(
    prefix: str, nmodes: int = 3, savedir: Optional[str] = None
):
    """States (left) and their time derivatives (right) for alternating
    modes: truth, observations / finite differences, GP mean +/- 3 sigma
    (reference ``PDEs/plots_paper.py:544-676``)."""
    p = _reduced_plotter(prefix)
    with _load(f"{prefix}-ddtdata.h5") as hf:
        t_fd = hf["time_domain_FD"][:]
        fd = hf["ddts_finitedifferences"][:]
        t_gp = hf["time_domain_GP"][:]
        dmean = hf["ddts_GPmean"][:]
        dstd = hf["ddts_GPstd"][:]
        t_truth = hf["time_domain_truth"][:]
        dtruth = hf["ddts_truth"][:]

    r = p.gp_means.shape[0]
    modes = [m for m in range(0, 2 * nmodes, 2) if m < r][:nmodes]
    fig, axes = plt.subplots(
        len(modes), 2, figsize=(12, 1.7 * len(modes)), sharex=True
    )
    axes = np.atleast_2d(axes)
    end = p.end_train_index
    for row, i in enumerate(modes):
        axl, axr = axes[row]
        if p.true_states_compressed is not None:
            axl.plot(
                p.prediction_time_domain[:end],
                p.true_states_compressed[i, :end],
                color=COLORS["truth"], lw=1.5,
            )
        p.plot_data(axl, p.snapshots_compressed[i])
        p.plot_gp(axl, p.gp_means[i], p.gp_stds[i], width=3)
        axl.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")

        axr.plot(t_truth, dtruth[i], color=COLORS["truth"], lw=1.5)
        axr.plot(t_gp, dmean[i], color=COLORS["gp"], lw=0.8)
        axr.fill_between(
            t_gp, dmean[i] - 3 * dstd[i], dmean[i] + 3 * dstd[i],
            color=COLORS["gp"], alpha=0.25, lw=0,
        )
        axr.plot(t_fd, fd[i], "p", ms=3, color=COLORS["data"], zorder=0.001)
        axr.set_ylabel(rf"$d\hat{{q}}_{{{i + 1}}}/dt$")
    axes[0, 0].set_title("Reduced states")
    axes[0, 1].set_title("Reduced state time derivatives")
    for ax in axes[-1]:
        ax.set_xlabel("$t$")
    return _save_or_return({"euler_gpfit_ddts": fig}, savedir)


def euler_draws_and_iqr_figure(
    prefix: str, mode: int = 0, ndraws: int = 50,
    savedir: Optional[str] = None,
):
    """Mode-1 ensemble as individual draws (left) and as IQR + mean
    (right) (reference ``PDEs/plots_paper.py:679-731``)."""
    p = _reduced_plotter(prefix)
    fig, axes = plt.subplots(1, 2, figsize=(12, 3.5), sharex=True, sharey=True)
    draws = p.draws_compressed[:ndraws, mode, :]
    p.plot_draws(axes[0], draws)
    p.plot_percentiles(axes[1], draws)
    p.plot_samplemean(axes[1], draws.mean(axis=0))
    axes[0].set_ylabel(rf"$\hat{{q}}_{{{mode + 1}}}(t)$")
    for ax in axes:
        ax.set_xlabel("$t$")
    axes[0].set_title("Sampled ROM predictions")
    axes[1].set_title("Mean and IQR of ROM predictions")
    return _save_or_return({"euler_draws_iqr": fig}, savedir)


def euler_romsolution_figure(
    prefix: str, spread: bool = True, savedir: Optional[str] = None
):
    """All-modes posterior grid: truth, observations, sample mean, and
    IQR or individual draws (reference ``PDEs/plots_paper.py:734-801``)."""
    p = _reduced_plotter(prefix)
    r = p.draws_compressed.shape[1]
    nrows = (r + 1) // 2
    fig, axes = plt.subplots(nrows, 2, figsize=(12, 1.7 * nrows), sharex=True)
    for i, ax in enumerate(np.atleast_1d(axes).flat):
        if i >= r:
            ax.axis("off")
            continue
        if p.true_states_compressed is not None:
            p.plot_truth(ax, p.true_states_compressed[i])
        p.plot_data(ax, p.snapshots_compressed[i])
        draws = p.draws_compressed[:, i, :]
        if spread:
            p.plot_percentiles(ax, draws)
        else:
            p.plot_draws(ax, draws)
        p.plot_samplemean(ax, draws.mean(axis=0))
        ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
    for ax in np.atleast_2d(axes)[-1]:
        ax.set_xlabel("$t$")
    tag = "spread" if spread else "draws"
    return _save_or_return({f"euler_rom_{tag}": fig}, savedir)


def euler_fomsolution_figure(
    prefix: str, nlocs: int = 4, spread: bool = True,
    savedir: Optional[str] = None,
):
    """Full-order posterior grid: 3 variables x ``nlocs`` spatial points
    (reference ``PDEs/plots_paper.py:804-886``)."""
    data = _full_arrays(prefix)
    truth = data["true_states"]
    snaps = data["snapshots"]
    draws = data.get("draws")
    if draws is None:
        raise ValueError(f"{prefix}_data-full.h5 carries no decompressed draws")
    draws = draws[:NUMDRAWS_FIGURES]
    x = data["spatial_domain"]
    nx = truth.shape[0] // 3
    rows = np.linspace(0, nx - 1, nlocs).astype(int)
    var_names = ("Velocity", "Pressure", "$1/$Density")

    p = BasePlotter(
        data["sampling_time_domain"],
        data.get("training_time_domain", data["sampling_time_domain"]),
        data["prediction_time_domain"],
    )
    fig, axes = plt.subplots(
        3, nlocs, figsize=(12, 5), sharex=True, sharey="row"
    )
    for i in range(3):
        for col, j in enumerate(rows):
            ax = axes[i, col]
            row = i * nx + j
            p.plot_truth(ax, truth[row])
            p.plot_data(ax, snaps[row])
            d = draws[:, row, :]
            if spread:
                p.plot_percentiles(ax, d)
            else:
                p.plot_draws(ax, d)
            p.plot_samplemean(ax, d.mean(axis=0))
            if i == 0:
                ax.set_title(f"$x = {x[j]:.1f}$")
        axes[i, 0].set_ylabel(var_names[i])
    for ax in axes[-1]:
        ax.set_xlabel("$t$")
    tag = "spread" if spread else "draws"
    return _save_or_return({f"euler_fom_{tag}": fig}, savedir)


def euler_fomsolution_closeup_figure(
    prefix: str, spatial_index: int = 0, savedir: Optional[str] = None
):
    """Velocity + pressure closeup at one point: truth, PROJECTED truth,
    and the ensemble mean — isolating projection error from inference
    error (reference ``PDEs/plots_paper.py:889-963``)."""
    data = _full_arrays(prefix)
    truth = data["true_states"]
    proj = data["true_states_projected"]
    draws = data.get("draws")
    if draws is None:
        raise ValueError(f"{prefix}_data-full.h5 carries no decompressed draws")
    draws = draws[:NUMDRAWS_FIGURES]
    nx = truth.shape[0] // 3
    p = BasePlotter(
        data["sampling_time_domain"],
        data.get("training_time_domain", data["sampling_time_domain"]),
        data["prediction_time_domain"],
    )
    fig, axes = plt.subplots(2, 1, figsize=(12, 5), sharex=True)
    for i, (ax, name) in enumerate(zip(axes, ("Velocity", "Pressure"))):
        row = i * nx + spatial_index
        p.plot_truth(ax, truth[row])
        p.plot_truth_projected(ax, proj[row])
        p.plot_samplemean(ax, draws[:, row, :].mean(axis=0))
        ax.set_ylabel(name)
    axes[0].set_title(f"$x = {data['spatial_domain'][spatial_index]:.1f}$")
    axes[0].legend(loc="best", fontsize="small")
    axes[-1].set_xlabel("$t$")
    return _save_or_return({"euler_closeup": fig}, savedir)


# ---- SEIRD composites (reference ``ODEs/plots_paper.py``) ----------------------
def seird_solution_comparison_figure(
    prefixes: Sequence[str],
    labels: Sequence[str],
    spread: bool = True,
    savedir: Optional[str] = None,
):
    """5 state variables x len(prefixes) runs posterior comparison
    (reference ``ODEs/plots_paper.py`` ``plot_solution``; the paper's
    noisy-compare / sparse-compare figures)."""
    n = len(prefixes)
    fig, axes = plt.subplots(
        5, n, figsize=(4 * n, 7.5), sharex="col", sharey="row"
    )
    state_labels = ("S", "E", "I", "R", "D")
    for col, (prefix, label) in enumerate(zip(prefixes, labels)):
        with _load(f"{prefix}_data.h5") as hf:
            p = ODEPlotter(
                hf["sampling_time_domain"][:],
                hf["training_time_domain"][:],
                hf["prediction_time_domain"][:],
                hf["snapshots"][:],
                hf["true_states"][:],
                hf["gp_means"][:],
                hf["gp_stds"][:],
                hf["draws"][:][:NUMDRAWS_FIGURES],
            )
        for i in range(5):
            ax = axes[i, col]
            p.plot_truth(ax, p.true_states[i])
            times = (
                p.sampling_time_domain[i]
                if p.sampling_time_domain.ndim == 2
                else p.sampling_time_domain
            )
            p.plot_data(ax, p.snapshots[i], times=times)
            draws = p.draws[:, i, :]
            if spread:
                p.plot_percentiles(ax, draws)
            else:
                p.plot_draws(ax, draws)
            p.plot_samplemean(ax, draws.mean(axis=0))
            if col == 0:
                ax.set_ylabel(state_labels[i])
        axes[0, col].set_title(label)
        axes[-1, col].set_xlabel("$t$")
    return _save_or_return({"seird_compare": fig}, savedir)


def seird_icdiff_figure(
    prefix_true_ics: str,
    prefix_est_ics: str,
    spread: bool = False,
    savedir: Optional[str] = None,
):
    """Posteriors from true vs estimated initial conditions, side by side
    (reference ``ODEs/plots_paper.py:285-356``)."""
    fig, all_axes = plt.subplots(
        5, 2, figsize=(12, 7.5), sharex="col", sharey="row"
    )
    state_labels = ("S", "E", "I", "R", "D")
    for col, prefix in enumerate((prefix_true_ics, prefix_est_ics)):
        with _load(f"{prefix}_data.h5") as hf:
            p = ODEPlotter(
                hf["sampling_time_domain"][:],
                hf["training_time_domain"][:],
                hf["prediction_time_domain"][:],
                hf["snapshots"][:],
                hf["true_states"][:],
                hf["gp_means"][:],
                hf["gp_stds"][:],
                hf["draws"][:][:NUMDRAWS_FIGURES],
            )
        for i in range(5):
            ax = all_axes[i, col]
            p.plot_truth(ax, p.true_states[i])
            times = (
                p.sampling_time_domain[i]
                if p.sampling_time_domain.ndim == 2
                else p.sampling_time_domain
            )
            p.plot_data(ax, p.snapshots[i], times=times)
            draws = p.draws[:, i, :]
            if spread:
                p.plot_percentiles(ax, draws)
            else:
                p.plot_draws(ax, draws)
            p.plot_samplemean(ax, draws.mean(axis=0))
            if col == 0:
                ax.set_ylabel(state_labels[i])
        all_axes[-1, col].set_xlabel("$t$")
    all_axes[0, 0].set_title("True initial conditions")
    all_axes[0, 1].set_title("Estimated initial conditions")
    return _save_or_return({"seird_icdiff": fig}, savedir)


# ---- heat multi-trajectory composites (``PDEsMulti/plots_paper.py``) ----------
def _multi_plotter(prefix):
    from .plotters import MultiTrajectoryPlotter

    with _load(f"{prefix}_data.h5") as hf:
        ells = sorted(
            int(k.split("_")[1]) for k in hf.keys() if k.startswith("trajectory_")
        )
        snaps, truth_c, gmeans, gstds, draws = [], [], [], [], []
        for ell in ells:
            grp = hf[f"trajectory_{ell}"]
            snaps.append(grp["snapshots_compressed"][:])
            truth_c.append(grp["true_states_compressed"][:])
            gmeans.append(grp["gp_means"][:])
            gstds.append(grp["gp_stds"][:])
            valid = grp["draws_valid"][:].astype(bool)
            draws.append(
                grp["draws_compressed"][:][valid][:NUMDRAWS_FIGURES]
            )
        nmin = min(d.shape[0] for d in draws)
        draws = np.stack([d[:nmin] for d in draws])
        new = hf.get("new_trajectory")
        newparam_draws = newparam_truth = None
        if new is not None:
            valid = new["draws_valid"][:].astype(bool)
            newparam_draws = new["draws_compressed"][:][valid][:NUMDRAWS_FIGURES]
            newparam_truth = new["true_states_compressed"][:]
        return MultiTrajectoryPlotter(
            hf["sampling_time_domain"][:],
            hf["training_time_domain"][:],
            hf["prediction_time_domain"][:],
            hf["input_parameters"][:]
            if "input_parameters" in hf else np.zeros((len(ells), 2)),
            np.stack(snaps),
            np.stack(truth_c),
            np.stack(gmeans),
            np.stack(gstds),
            draws,
            test_parameters=hf["test_parameters"][:]
            if "test_parameters" in hf else None,
            newparam_draws=newparam_draws,
            newparam_true_compressed=newparam_truth,
        )


def heat_samples_figure(prefix: str, savedir: Optional[str] = None):
    """Training/test input parameters in the (a, b) plane + one example
    noisy snapshot in space (reference ``PDEsMulti/plots_paper.py:174-250``)."""
    with _load(f"{prefix}_data.h5") as hf:
        params = (
            hf["input_parameters"][:] if "input_parameters" in hf else None
        )
        test = hf["test_parameters"][:] if "test_parameters" in hf else None
        x = hf["spatial_domain"][:] if "spatial_domain" in hf else None
        grp = hf["trajectory_1" if "trajectory_1" in hf else "trajectory_0"]
        snaps = grp["snapshots"][:]
        truth = grp["true_states"][:]
        t_s = hf["sampling_time_domain"][:]
        t_pr = hf["prediction_time_domain"][:]

    fig, axes = plt.subplots(1, 2, figsize=(12, 3))
    if params is not None:
        axes[0].plot(
            params[:, 0], params[:, 1], "s", ms=5, color=COLORS["data"],
            label="Training parameter values",
        )
    if test is not None:
        axes[0].plot(
            [test[0]], [test[1]], "d", color=COLORS["gp"],
            label="Test parameter value",
        )
    axes[0].set_xlabel("$a$")
    axes[0].set_ylabel("$b$")
    axes[0].set_aspect("equal")
    axes[0].set_title("Training parameter values")
    axes[0].legend(fontsize="small", loc="best")

    # One noisy snapshot (mid-sample) against the truth at that instant.
    j = snaps.shape[1] // 2
    tj = t_s[j]
    col = int(np.argmin(np.abs(t_pr - tj)))
    if x is None:
        x = np.linspace(0, 1, snaps.shape[0])
    axes[1].plot(x, truth[:, col], color="#a92c00", lw=1.2, label="truth")
    axes[1].plot(x, snaps[:, j], "o", ms=3, color=COLORS["data"],
                 label="noisy data")
    axes[1].set_xlabel("$x$")
    axes[1].set_ylabel(rf"$q(x, t_j)$")
    axes[1].set_title(rf"Example snapshot, $t_j = {tj:.2f}$")
    axes[1].legend(fontsize="small", loc="upper left")
    return _save_or_return({"heat_samples": fig}, savedir)


def heat_gpfit_figure(
    prefix: str, trajectories=(0, 2, 4), savedir: Optional[str] = None
):
    """Modes x trajectories GP-fit grid (``PDEsMulti/plots_paper.py:253-318``)."""
    p = _multi_plotter(prefix)
    trajectories = [t for t in trajectories if t < p.num_trajectories]
    fig = p.plot_gp_training_fit(trajectories)
    return _save_or_return({"heat_gpfit": fig}, savedir)


def heat_romsolution_figure(
    prefix: str, trajectories=(0, 2, 4), spread: bool = True,
    savedir: Optional[str] = None,
):
    """Modes x trajectories posterior grid (``plots_paper.py:321-417``)."""
    p = _multi_plotter(prefix)
    trajectories = [t for t in trajectories if t < p.num_trajectories]
    fig = p.plot_posterior(trajectories, spread=spread)
    return _save_or_return({"heat_rom": fig}, savedir)


def heat_fomsolution_figure(
    prefix: str, trajectories=(1, 2, 3), spread: bool = True,
    savedir: Optional[str] = None,
):
    """Full-state posterior at the exported spatial rows, one column per
    trajectory (``PDEsMulti/plots_paper.py:420-480``)."""
    with _load(f"{prefix}_data.h5") as hf:
        t_s = hf["sampling_time_domain"][:]
        t_tr = hf["training_time_domain"][:]
        t_pr = hf["prediction_time_domain"][:]
        rows = hf["spatial_rows"][:]
        x = hf["spatial_domain"][:] if "spatial_domain" in hf else None
        ells = [
            t for t in trajectories if f"trajectory_{t}" in hf
        ]
        data = []
        for ell in ells:
            grp = hf[f"trajectory_{ell}"]
            data.append(
                (grp["true_states"][:], grp["draws_full"][:NUMDRAWS_FIGURES])
            )
    p = BasePlotter(t_s, t_tr, t_pr)
    npts = min(4, len(rows))
    sel = np.linspace(1, len(rows) - 2, npts).astype(int)
    fig, axes = plt.subplots(
        npts, len(ells), figsize=(4 * len(ells), 1.7 * npts),
        sharex=True, sharey="row",
    )
    axes = np.atleast_2d(axes).reshape(npts, len(ells))
    for col, (truth, draws) in enumerate(data):
        for rr, srow in enumerate(sel):
            ax = axes[rr, col]
            p.plot_truth(ax, truth[rows[srow]])
            d = draws[:, srow, :]
            if spread:
                p.plot_percentiles(ax, d)
            else:
                p.plot_draws(ax, d)
            p.plot_samplemean(ax, d.mean(axis=0))
            if col == 0 and x is not None:
                ax.set_ylabel(rf"$x = {x[rows[srow]]:.2f}$")
        axes[0, col].set_title(f"trajectory {ells[col]}")
        axes[-1, col].set_xlabel("$t$")
    return _save_or_return({"heat_fom": fig}, savedir)


def heat_newtrajectory_figure(
    prefix: str, spread: bool = True, savedir: Optional[str] = None
):
    """Generalization at unseen input parameters: reduced (left) and
    full-order (right) predictions (``PDEsMulti/plots_paper.py:483-574``)."""
    with _load(f"{prefix}_data.h5") as hf:
        if "new_trajectory" not in hf:
            raise ValueError(f"{prefix}_data.h5 has no new_trajectory group")
        t_s = hf["sampling_time_domain"][:]
        t_tr = hf["training_time_domain"][:]
        t_pr = hf["prediction_time_domain"][:]
        rows = hf["spatial_rows"][:]
        x = hf["spatial_domain"][:] if "spatial_domain" in hf else None
        test = hf["test_parameters"][:] if "test_parameters" in hf else None
        new = hf["new_trajectory"]
        valid = new["draws_valid"][:].astype(bool)
        truth_red = new["true_states_compressed"][:]
        truth_full = new["true_states"][:]
        draws_red = new["draws_compressed"][:][valid][:NUMDRAWS_FIGURES]
        draws_full = new["draws_full"][:NUMDRAWS_FIGURES]

    p = BasePlotter(t_s, t_tr, t_pr)
    npts = min(4, truth_red.shape[0], len(rows))
    fig, axes = plt.subplots(npts, 2, figsize=(12, 1.7 * npts), sharex=True)
    for i in range(npts):
        axl, axr = axes[i]
        p.plot_truth(axl, truth_red[i])
        d = draws_red[:, i, :]
        if spread:
            p.plot_percentiles(axl, d)
        else:
            p.plot_draws(axl, d)
        p.plot_samplemean(axl, d.mean(axis=0))
        axl.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")

        srow = int(np.linspace(1, len(rows) - 2, npts)[i])
        p.plot_truth(axr, truth_full[rows[srow]])
        d = draws_full[:, srow, :]
        if spread:
            p.plot_percentiles(axr, d)
        else:
            p.plot_draws(axr, d)
        p.plot_samplemean(axr, d.mean(axis=0))
        if x is not None:
            axr.set_ylabel(rf"$x = {x[rows[srow]]:.2f}$")
    axes[0, 0].set_title("Reduced-order predictions")
    axes[0, 1].set_title("Full-order predictions")
    for ax in axes[-1]:
        ax.set_xlabel("$t$")
    if test is not None:
        fig.suptitle(rf"$(a, b) = ({test[0]:g}, {test[1]:g})$", y=0.99)
    return _save_or_return({"heat_newtrajectory": fig}, savedir)


# ---- whole figure sets (reference ``paper()`` functions) ------------------------
def euler_paper(
    prefix_noisy: str = "ex1a",
    prefix_sparse: str = "ex2a",
    prefix_dims: str = "ex1r8",
    comparison_noise: Sequence[str] = ("ex1d", "ex1a", "ex1e"),
    comparison_sparse: Sequence[str] = ("ex2d", "ex2a", "ex2e"),
    datadir: str = ".",
    savedir: str = "figures/euler",
    init_params=None,
):
    """Regenerate every Euler paper figure from exported artifacts
    (reference ``PDEs/plots_paper.py:1223-1246``). Figures whose
    artifacts are absent are skipped with a note."""
    jp = lambda p: os.path.join(datadir, p)
    made, skipped = {}, []
    jobs = [
        ("fomdata", lambda: euler_fomdata_figure(
            jp(prefix_sparse), init_params=init_params, savedir=savedir)),
        ("gpfit", lambda: euler_gpfit_figure(jp(prefix_noisy), savedir)),
        ("dims", lambda: euler_dimension_figure(jp(prefix_dims), savedir=savedir)),
        ("ddts", lambda: euler_ddt_figure(jp(prefix_noisy), savedir)),
        ("gpfit_ddts", lambda: euler_gpfit_and_derivatives_figure(
            jp(prefix_sparse), savedir=savedir)),
        ("draws_iqr", lambda: euler_draws_and_iqr_figure(
            jp(prefix_noisy), savedir=savedir)),
        ("rom_noisy", lambda: euler_romsolution_figure(
            jp(prefix_noisy), savedir=savedir)),
        ("fom_noisy", lambda: euler_fomsolution_figure(
            jp(prefix_noisy), savedir=savedir)),
        ("closeup", lambda: euler_fomsolution_closeup_figure(
            jp(prefix_noisy), savedir=savedir)),
        ("rom_sparse", lambda: euler_romsolution_figure(
            jp(prefix_sparse), savedir=savedir)),
        ("fom_sparse", lambda: euler_fomsolution_figure(
            jp(prefix_sparse), savedir=savedir)),
        ("noise_comparison", lambda: comparison_full_figure(
            [jp(p) for p in comparison_noise],
            [r"$1\%$ noise", r"$3\%$ noise", r"$5\%$ noise"],
            spatial_index=2, savedir=savedir)),
        ("sparsity_comparison", lambda: comparison_reduced_figure(
            [jp(p) for p in comparison_sparse],
            ["$m = 50$", "$m = 200$", "$m = 450$"],
            savedir=savedir)),
    ]
    for name, job in jobs:
        try:
            made[name] = job()
        except (FileNotFoundError, KeyError, ValueError) as exc:
            skipped.append((name, str(exc)))
    if skipped:
        for name, why in skipped:
            print(f"[euler_paper] skipped {name}: {why}")
    return made


def seird_paper(
    comparison_noisy: Sequence[str] = ("ex1c", "ex1a", "ex1d"),
    comparison_sparse: Sequence[str] = ("ex2c", "ex2d", "ex2a"),
    datadir: str = ".",
    savedir: str = "figures/seird",
):
    """Regenerate the SEIRD paper figures (reference
    ``ODEs/plots_paper.py:386-411``)."""
    jp = lambda p: os.path.join(datadir, p)
    made, skipped = {}, []
    jobs = [
        ("noisy_compare", lambda: seird_solution_comparison_figure(
            [jp(p) for p in comparison_noisy],
            ["60 days of data", "90 days of data", "120 days of data"],
            savedir=savedir)),
        ("sparse_compare", lambda: seird_solution_comparison_figure(
            [jp(p) for p in comparison_sparse],
            ["10 obs over 60 days", "10 obs over 90 days",
             "10 obs over 120 days"],
            savedir=savedir)),
        ("single", lambda: seird_figure(jp(comparison_noisy[1]), savedir)),
    ]
    for name, job in jobs:
        try:
            made[name] = job()
        except (FileNotFoundError, KeyError, ValueError) as exc:
            skipped.append((name, str(exc)))
    for name, why in skipped:
        print(f"[seird_paper] skipped {name}: {why}")
    return made


def heat_paper(
    prefix: str = "ex3",
    datadir: str = ".",
    savedir: str = "figures/heat",
):
    """Regenerate the multi-trajectory heat paper figures (reference
    ``PDEsMulti/plots_paper.py:601-624``)."""
    jp = lambda p: os.path.join(datadir, p)
    made, skipped = {}, []
    jobs = [
        ("samples", lambda: heat_samples_figure(jp(prefix), savedir)),
        ("gpfit", lambda: heat_gpfit_figure(jp(prefix), savedir=savedir)),
        ("rom", lambda: heat_romsolution_figure(jp(prefix), savedir=savedir)),
        ("fom", lambda: heat_fomsolution_figure(jp(prefix), savedir=savedir)),
        ("newtrajectory", lambda: heat_newtrajectory_figure(
            jp(prefix), savedir=savedir)),
    ]
    for name, job in jobs:
        try:
            made[name] = job()
        except (FileNotFoundError, KeyError, ValueError) as exc:
            skipped.append((name, str(exc)))
    for name, why in skipped:
        print(f"[heat_paper] skipped {name}: {why}")
    return made


def _save_or_return(figs: dict, savedir: Optional[str]):
    if savedir is None:
        return figs
    os.makedirs(savedir, exist_ok=True)
    paths = {}
    for name, fig in figs.items():
        path = os.path.join(savedir, f"{name}.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        paths[name] = path
    return paths
