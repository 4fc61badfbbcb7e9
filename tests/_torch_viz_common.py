"""Shared by the plotting tests of the PyTorch port: a figure's artists as
plain data, and the comparison of two figures artist by artist.

For every axes of a figure (colorbars included, in the figure's order):
its titles, axis labels, limits and scales, the legend's texts; every
line's ``get_xydata()``, style and label; every collection's offsets,
path vertices and color array; every image's array. Plus the figure's
suptitle. Two figures are equal when all of it is: exactly (``rtol=0``),
or, for arrays, within ``rtol`` of the largest magnitude of each array.

Also the seeded artifacts and the tables of calls the plotting tests
share: every figure function of ``paper.py`` (``FIGURES``), its three
``*_paper`` functions (``PAPERS``) and every plotter's plots
(``PLOTS``, on ``plotter_arrays``). Nothing here imports JAX at import
time, so a process that blocks JAX can use the tables.
"""

import matplotlib
import numpy as np

matplotlib.use("Agg")

from matplotlib.colors import to_rgba  # noqa: E402


def _collection(c):
    arr = c.get_array()
    return {
        "type": type(c).__name__,
        "offsets": np.asarray(c.get_offsets()),
        "paths": [np.asarray(p.vertices) for p in c.get_paths()],
        "array": None if arr is None else np.ma.getdata(arr),
    }


def _axes(ax):
    legend = ax.get_legend()
    return {
        "titles": [ax.get_title(loc) for loc in ("left", "center", "right")],
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "xlim": np.asarray(ax.get_xlim()),
        "ylim": np.asarray(ax.get_ylim()),
        "scales": (ax.get_xscale(), ax.get_yscale()),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "lines": [
            {"xy": np.asarray(line.get_xydata(), dtype=np.float64),
             "style": (line.get_linestyle(), line.get_marker(), to_rgba(line.get_color()),
                       line.get_linewidth(), line.get_label())}
            for line in ax.get_lines()
        ],
        "collections": [_collection(c) for c in ax.collections],
        "images": [np.ma.getdata(im.get_array()) for im in ax.images],
    }


def _signature(fig):
    suptitle = fig._suptitle.get_text() if fig._suptitle is not None else None
    return {"suptitle": suptitle, "axes": [_axes(ax) for ax in fig.axes]}


def _assert_equal(a, b, rtol, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], rtol, f"{where}.{k}")
    elif isinstance(a, list) and not (a and isinstance(a[0], (str, float, int))):
        assert isinstance(b, list) and len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, rtol, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape, (where, np.shape(b), a.shape)
        if rtol == 0 or a.dtype.kind not in "fc":
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            scale = float(np.nanmax(np.abs(b))) if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=where)
    else:
        assert a == b, (where, a, b)


def assert_same_figure(fig, ref, rtol=0.0):
    """``fig`` and ``ref`` have the same artists (see the module's
    docstring)."""
    _assert_equal(_signature(fig), _signature(ref), rtol, "figure")


def assert_same_figures(figs, refs, rtol=0.0):
    """Two ``{name: figure}`` mappings with the same names and figures."""
    assert sorted(figs) == sorted(refs), (sorted(figs), sorted(refs))
    for name in refs:
        _assert_equal(_signature(figs[name]), _signature(refs[name]), rtol, name)


#: The Euler initial condition's spline knots (``EulerConfig.init_params``).
INIT = (22, 20, 24, 95, 105, 100)


def write_artifacts(root):
    """Every artifact that ``paper.py``'s figure functions and its
    ``*_paper`` functions read, from seeded NumPy by the writers of
    ``tests/test_paper_figures.py``, under the prefixes the ``*_paper``
    functions use by default, in ``root/euler``,
    ``root/seird`` and ``root/heat``; returns ``root``."""
    import h5py
    from test_paper_figures import (
        _write_ddt, _write_full, _write_multi, _write_reduced_with_truth, _write_seird,
    )

    rng = np.random.default_rng(20240807)
    for sub in ("euler", "seird", "heat"):
        (root / sub).mkdir()
    for name in ("ex1a", "ex2a", "ex1r8", "ex1d", "ex1e", "ex2d", "ex2e"):
        prefix = str(root / "euler" / name)
        _write_reduced_with_truth(f"{prefix}_data-reduced.h5", rng,
                                  r=8 if name == "ex1r8" else 6)
        with h5py.File(f"{prefix}_data-reduced.h5", "a") as hf:  # one rejected draw
            hf["draws_valid"][3] = False
        _write_full(f"{prefix}_data-full.h5", rng)
        _write_ddt(f"{prefix}-ddtdata.h5", rng, r=6)
        np.save(f"{prefix}-svdvals.npy", np.sort(rng.uniform(0.01, 10, 30))[::-1])
    for name in ("ex1a", "ex1c", "ex1d", "ex2a", "ex2c", "ex2d"):
        _write_seird(str(root / "seird" / f"{name}_data.h5"), rng)
    _write_multi(str(root / "heat" / "ex3_data.h5"), rng, L=5)
    return root


# name -> call(paper module, artifact root); 22 functions, some twice.
FIGURES = {
    "seird_figure": lambda p, d: p.seird_figure(f"{d}/seird/ex1a"),
    "euler_reduced_figure": lambda p, d: p.euler_reduced_figure(f"{d}/euler/ex1a"),
    "euler_ddt_figure": lambda p, d: p.euler_ddt_figure(f"{d}/euler/ex1a"),
    "euler_ddt_figure-maxmodes": lambda p, d: p.euler_ddt_figure(f"{d}/euler/ex1a", maxmodes=2),
    "svdval_decay_figure": lambda p, d: p.svdval_decay_figure(f"{d}/euler/ex1a"),
    "heat_multi_figure": lambda p, d: p.heat_multi_figure(f"{d}/heat/ex3"),
    "comparison_reduced_figure": lambda p, d: p.comparison_reduced_figure(
        [f"{d}/euler/{n}" for n in ("ex2d", "ex2a", "ex2e")], ["a", "b", "c"], mode=1),
    "comparison_full_figure": lambda p, d: p.comparison_full_figure(
        [f"{d}/euler/{n}" for n in ("ex1d", "ex1a", "ex1e")], ["a", "b", "c"],
        spatial_index=2, variable=1),
    "euler_fomdata_figure": lambda p, d: p.euler_fomdata_figure(
        f"{d}/euler/ex2a", init_params=INIT),
    "euler_fomdata_figure-noknots": lambda p, d: p.euler_fomdata_figure(
        f"{d}/euler/ex2a", nlocs=3),
    "euler_gpfit_figure": lambda p, d: p.euler_gpfit_figure(f"{d}/euler/ex1a"),
    "euler_dimension_figure": lambda p, d: p.euler_dimension_figure(f"{d}/euler/ex1r8"),
    "euler_gpfit_and_derivatives_figure": lambda p, d: p.euler_gpfit_and_derivatives_figure(
        f"{d}/euler/ex2a"),
    "euler_draws_and_iqr_figure": lambda p, d: p.euler_draws_and_iqr_figure(
        f"{d}/euler/ex1a", mode=2, ndraws=5),
    "euler_romsolution_figure": lambda p, d: p.euler_romsolution_figure(f"{d}/euler/ex1a"),
    "euler_romsolution_figure-draws": lambda p, d: p.euler_romsolution_figure(
        f"{d}/euler/ex1a", spread=False),
    "euler_fomsolution_figure": lambda p, d: p.euler_fomsolution_figure(f"{d}/euler/ex1a"),
    "euler_fomsolution_figure-draws": lambda p, d: p.euler_fomsolution_figure(
        f"{d}/euler/ex1a", nlocs=3, spread=False),
    "euler_fomsolution_closeup_figure": lambda p, d: p.euler_fomsolution_closeup_figure(
        f"{d}/euler/ex1a", spatial_index=5),
    "seird_solution_comparison_figure": lambda p, d: p.seird_solution_comparison_figure(
        [f"{d}/seird/{n}" for n in ("ex1c", "ex1a", "ex1d")], ["60", "90", "120"]),
    "seird_solution_comparison_figure-draws": lambda p, d: p.seird_solution_comparison_figure(
        [f"{d}/seird/{n}" for n in ("ex2c", "ex2d")], ["x", "y"], spread=False),
    "seird_icdiff_figure": lambda p, d: p.seird_icdiff_figure(
        f"{d}/seird/ex1a", f"{d}/seird/ex1c"),
    "seird_icdiff_figure-spread": lambda p, d: p.seird_icdiff_figure(
        f"{d}/seird/ex1a", f"{d}/seird/ex1c", spread=True),
    "heat_samples_figure": lambda p, d: p.heat_samples_figure(f"{d}/heat/ex3"),
    "heat_gpfit_figure": lambda p, d: p.heat_gpfit_figure(f"{d}/heat/ex3"),
    "heat_romsolution_figure": lambda p, d: p.heat_romsolution_figure(f"{d}/heat/ex3"),
    "heat_romsolution_figure-draws": lambda p, d: p.heat_romsolution_figure(
        f"{d}/heat/ex3", trajectories=(1, 3), spread=False),
    "heat_fomsolution_figure": lambda p, d: p.heat_fomsolution_figure(f"{d}/heat/ex3"),
    "heat_newtrajectory_figure": lambda p, d: p.heat_newtrajectory_figure(f"{d}/heat/ex3"),
    "heat_newtrajectory_figure-draws": lambda p, d: p.heat_newtrajectory_figure(
        f"{d}/heat/ex3", spread=False),
}

# name -> call(paper module, artifact root, output folder): the three whole figure sets.
PAPERS = {
    "euler_paper": lambda p, d, out: p.euler_paper(datadir=f"{d}/euler", savedir=out,
                                                   init_params=INIT),
    "seird_paper": lambda p, d, out: p.seird_paper(datadir=f"{d}/seird", savedir=out),
    "heat_paper": lambda p, d, out: p.heat_paper(datadir=f"{d}/heat", savedir=out),
}


def plotter_arrays(rng, L=2, n=5, r=4, m=10, mp=12, k=20, nd=6, nx=8):
    return {
        "ODEPlotter": ((np.stack([np.linspace(0, 1, m)] * n), np.linspace(0, 1, mp),
                        np.linspace(0, 2, k), rng.standard_normal((n, m)),
                        rng.standard_normal((n, k)), rng.standard_normal((n, mp)),
                        np.abs(rng.standard_normal((n, mp))),
                        rng.standard_normal((nd, n, k))), {}),
        "ReducedPlotter": ((np.linspace(0, 1, m), np.linspace(0, 1, mp), np.linspace(0, 2, k),
                            rng.standard_normal((r, m)), rng.standard_normal((r, k)),
                            rng.standard_normal((r, mp)), np.abs(rng.standard_normal((r, mp))),
                            rng.standard_normal((nd, r, k))), {}),
        "MultiTrajectoryPlotter": (
            (np.linspace(0, 1, m), np.linspace(0, 1, mp), np.linspace(0, 2, k),
             rng.uniform(-2, 2, (L, 2)), rng.standard_normal((L, r, m)),
             rng.standard_normal((L, r, k)), rng.standard_normal((L, r, mp)),
             np.abs(rng.standard_normal((L, r, mp))), rng.standard_normal((L, nd, r, k))),
            dict(test_parameters=np.array([1.5, 0.5]),
                 newparam_draws=rng.standard_normal((nd, r, k)),
                 newparam_true_compressed=rng.standard_normal((r, k)))),
        "StatePlotter": ((np.linspace(0, 1, m), np.linspace(0, 1, mp), np.linspace(0, 2, k),
                          np.linspace(0, 2, nx), 3, rng.standard_normal((3 * nx, m)),
                          rng.standard_normal((3 * nx, k)), rng.standard_normal((3 * nx, k)),
                          rng.standard_normal((nd, 3 * nx, k))), dict(numspatialpoints=3)),
    }


# plotter -> its plot calls, each returning one figure or a list of them.
PLOTS = {
    "ODEPlotter": [lambda p: p.plot_gp_training_fit(), lambda p: p.plot_posterior(),
                   lambda p: p.plot_posterior(individual=True),
                   lambda p: p.plot_posterior(newic_draws=p.draws[::-1])],
    "ReducedPlotter": [lambda p: p.plot_gp_training_fit(), lambda p: p.plot_gp_training_fit(2.0),
                       lambda p: p.plot_posterior(), lambda p: p.plot_posterior(individual=True)],
    "MultiTrajectoryPlotter": [lambda p: p.plot_gp_training_fit(),
                               lambda p: p.plot_gp_training_fit(trajectories=[1], width=2.0),
                               lambda p: p.plot_posterior(),
                               lambda p: p.plot_posterior(trajectories=[1, 0], spread=False),
                               lambda p: p.plot_posterior_newparams(),
                               lambda p: p.plot_posterior_newparams(spread=False)],
    "StatePlotter": [lambda p: p.plot_posterior(), lambda p: p.plot_posterior(individual=True)],
}


def figures_of(out):
    """A plot call's figures as a list."""
    return out if isinstance(out, list) else [out]
