"""The PyTorch port's plotting layer (``gp_bayesopinf_torch.viz``) against
the JAX package's (``gp_bayesopinf_tpu.viz``), on the CPU under Agg.

The same HDF5 files, written from seeded NumPy by the writers of
``tests/test_paper_figures.py``, go through both packages: each of
``paper.py``'s 22 figure functions (with their options), and every
plotter's ``plot_*``, ``save`` and ``load``. The figures are compared
artist by artist and exactly (``tests/_torch_viz_common.py``): titles,
labels, limits, every line's data, every collection's offsets and
vertices, every image's array; the saved file names; the plotters' files
dataset by dataset. One more run draws the SEIRD figures from a file the
port exported itself. The three paper functions (``euler_paper``,
``seird_paper``, ``heat_paper``) are in ``tests/test_torch_viz_papers.py``.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
from _torch_io_common import assert_same_h5, host  # noqa: E402
from _torch_viz_common import (  # noqa: E402
    FIGURES, PLOTS, assert_same_figure, assert_same_figures, figures_of, plotter_arrays,
    write_artifacts,
)

from gp_bayesopinf_tpu import viz as jviz  # noqa: E402
from gp_bayesopinf_tpu.viz import paper as jpaper  # noqa: E402
from gp_bayesopinf_torch import io, viz  # noqa: E402
from gp_bayesopinf_torch.pipeline import GPBounds, SEIRDConfig, run_seird  # noqa: E402
from gp_bayesopinf_torch.viz import paper  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_artifacts(tmp_path_factory.mktemp("artifacts"))


def test_every_figure_function_is_exercised():
    public = {n for n in dir(jpaper) if n.endswith("_figure") and not n.startswith("_")}
    assert public == {k.split("-")[0] for k in FIGURES} and len(public) == 22


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_matches_jax(name, data):
    figs, ref = FIGURES[name](paper, data), FIGURES[name](jpaper, data)
    assert figs and all(isinstance(f, plt.Figure) for f in figs.values())
    assert_same_figures(figs, ref)


def test_figure_saved_names_match_jax(data, tmp_path):
    """With ``savedir``, the same file names: the figures' names as PDFs."""
    call = FIGURES["heat_romsolution_figure"]
    paths = {}
    for mod, sub in ((paper, "port"), (jpaper, "jax")):
        out = mod.heat_romsolution_figure(f"{data}/heat/ex3", savedir=str(tmp_path / sub))
        paths[sub] = {k: os.path.relpath(v, tmp_path / sub) for k, v in out.items()}
        assert sorted(os.listdir(tmp_path / sub)) == sorted(paths[sub].values())
    assert paths["port"] == paths["jax"] == {k: f"{k}.pdf" for k in call(paper, data)}


@pytest.mark.parametrize("cls", sorted(PLOTS))
def test_plotter_matches_jax(cls, tmp_path):
    """Each plot of a plotter built from the same arrays, of it saved by
    the port and loaded by the JAX package and the other way round; both
    files equal dataset by dataset and attribute by attribute."""
    args, kw = plotter_arrays(np.random.default_rng(7))[cls]
    port, ref = getattr(viz, cls)(*args, **kw), getattr(jviz, cls)(*args, **kw)
    port_path, jax_path = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    port.save(port_path)
    ref.save(jax_path)
    assert_same_h5(port_path, jax_path)
    with pytest.raises(FileExistsError):
        port.save(port_path, overwrite=False)
    cross = [getattr(viz, cls).load(jax_path), getattr(jviz, cls).load(port_path)]
    for plot in PLOTS[cls]:
        want = figures_of(plot(ref))
        for got in [plot(port)] + [plot(p) for p in cross]:
            got = figures_of(got)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert_same_figure(g, w)
        plt.close("all")


def test_base_plotter_matches_jax():
    rng = np.random.default_rng(3)
    times = (np.linspace(0, 1, 9), np.linspace(0, 1, 11), np.linspace(0, 2, 21))
    draws, mean, std = rng.standard_normal((5, 21)), rng.standard_normal(11), rng.random(11)
    obs = rng.standard_normal(9)
    figs = []
    for mod in (viz, jviz):
        p = mod.BasePlotter(*times)
        assert p.end_train_index == 11
        fig, ax = plt.subplots()
        p.plot_truth(ax, draws[0])
        p.plot_truth_projected(ax, draws[1], lw=2.0)
        p.plot_data(ax, obs)
        p.plot_gp(ax, mean, std, width=2.0)
        p.plot_samplemean(ax, draws.mean(0))
        p.plot_draws(ax, draws)
        p.plot_percentiles(ax, draws, lo=10, hi=90)
        figs.append(fig)
    assert viz.COLORS == jviz.COLORS
    assert_same_figure(*figs)


@pytest.fixture(scope="module")
def seird_export(tmp_path_factory):
    """A SEIRD run of the port (the small run of ``tests/test_torch_io.py``),
    exported by the port."""
    cfg = SEIRDConfig(time_domain=np.linspace(0, 90, 61),
                      gp_bounds=GPBounds((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5), 8),
                      reg_grid=np.logspace(-10, 2, 6))
    torch.set_num_threads(1)
    res = run_seird((0.0, 60.0), 24, 0.05, 48, ndraws=12, config=cfg, device="cpu",
                    verbose=False)
    prefix = str(tmp_path_factory.mktemp("seird") / "run")
    io.export_result(res, prefix)
    return res, prefix


def test_figures_of_a_port_export_match_jax(seird_export):
    """The port's own export drawn by both packages: equal artist by
    artist, and the posterior figure's draws are the run's."""
    res, prefix = seird_export
    figs, ref = paper.seird_figure(prefix), jpaper.seird_figure(prefix)
    assert_same_figures(figs, ref)
    assert_same_figures(paper.seird_icdiff_figure(prefix, prefix),
                        jpaper.seird_icdiff_figure(prefix, prefix))
    lines = figs["seird_draws"].axes[0].get_lines()  # truth, then the draws
    for line, draw in zip(lines[1:], host(res.draws)):
        np.testing.assert_array_equal(line.get_ydata(), draw[0])


@pytest.mark.parametrize("missing", ["matplotlib", "h5py"])
def test_viz_import_names_a_missing_package(monkeypatch, missing):
    """Without matplotlib or h5py, importing the plotting layer raises an
    ImportError that names the package; nothing falls back."""
    import builtins
    import importlib
    import sys

    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name.split(".")[0] == missing:
            raise ModuleNotFoundError(f"No module named '{missing}'", name=missing)
        return real_import(name, *args, **kwargs)

    def viz_modules():
        return {m: sys.modules[m] for m in list(sys.modules)
                if m.startswith("gp_bayesopinf_torch.viz")}

    loaded = viz_modules()
    for name in loaded:
        del sys.modules[name]
    try:
        monkeypatch.setattr(builtins, "__import__", fake_import)
        with pytest.raises(ImportError, match=missing):
            importlib.import_module("gp_bayesopinf_torch.viz")
    finally:
        monkeypatch.undo()
        for name in viz_modules():  # what the failed import left behind
            del sys.modules[name]
        sys.modules.update(loaded)
