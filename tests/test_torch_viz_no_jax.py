"""The port's plotting layer without JAX: in a fresh interpreter where
``jax``, ``jaxlib`` and ``gp_bayesopinf_tpu`` refuse to import,
``gp_bayesopinf_torch.viz`` imports and, under Agg, draws every one of
``paper.py``'s 22 figure functions (``tests/_torch_viz_common.py``'s
``FIGURES``) and its three ``*_paper`` functions (``PAPERS``, the files
saved), and every plotter's plots, ``save`` and ``load`` (``PLOTS``), on
the seeded artifacts the parent process writes. That the figures equal
the JAX package's is ``tests/test_torch_viz.py``'s and
``tests/test_torch_viz_papers.py``'s."""

import os
import subprocess
import sys
from pathlib import Path

from _torch_viz_common import write_artifacts

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib.abc, os, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu"):
            raise ImportError(f"{name} is blocked in this test")
sys.meta_path.insert(0, Block())

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from _torch_viz_common import FIGURES, PAPERS, PLOTS, figures_of, plotter_arrays
from gp_bayesopinf_torch import viz
from gp_bayesopinf_torch.viz import paper

root = sys.argv[1]
drawn = 0
for name, call in FIGURES.items():
    figs = call(paper, root)
    assert figs and all(isinstance(f, plt.Figure) and f.axes for f in figs.values()), name
    drawn += len(figs)
    plt.close("all")
for name, call in PAPERS.items():
    out = os.path.join(root, "figures", name)
    jobs = call(paper, root, out)
    saved = {p for figs in jobs.values() for p in figs.values()}
    assert len(jobs) >= 3 and saved and all(os.path.getsize(p) > 0 for p in saved), name
for cls, (args, kw) in plotter_arrays(np.random.default_rng(7)).items():
    plotter = getattr(viz, cls)(*args, **kw)
    path = os.path.join(root, f"{cls}.h5")
    plotter.save(path)
    for p in (plotter, getattr(viz, cls).load(path)):
        for plot in PLOTS[cls]:
            assert all(f.axes for f in figures_of(plot(p))), cls
        plt.close("all")
blocked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu")]
assert not blocked, blocked
print("ok", drawn)
"""


def test_plotting_layer_draws_without_jax(tmp_path):
    write_artifacts(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().startswith("ok")
