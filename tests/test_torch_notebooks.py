"""The port's notebooks, ``examples/torch_seird.ipynb`` and
``examples/torch_heat.ipynb``: every code cell runs on the CPU
(``GPBOI_NB_DEVICE=cpu``, Agg) in a fresh interpreter where ``jax``,
``jaxlib`` and ``gp_bayesopinf_tpu`` refuse to import; the deterministic
solutions equal the same cells of the JAX package's ``seird.ipynb`` and
``heat.ipynb`` run on the CPU (rtol 1e-10; the JAX heat notebook's
animation cell is left out); the noisy SEIRD cell is checked by its
support and shape; and the committed notebooks equal what
``scripts/build_torch_notebooks.py`` writes; and the script that times the
heat notebook's device solve runs without JAX at a tiny grid."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_no_jax import run

REPO = Path(__file__).resolve().parents[1]

#: Runs the code cells of each notebook named on the command line in one
#: namespace a notebook, from the working directory, and saves the
#: variables the tests compare to <name>.npz.
RUNNER = r"""
import importlib.abc, json, sys
if sys.argv[1] == "block":
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu"):
                raise ImportError(f"{name} is blocked in this test")
    sys.meta_path.insert(0, Block())
import numpy as np
for path in sys.argv[2:]:
    ns = {}
    for cell in json.load(open(path))["cells"]:
        src = "".join(cell["source"])
        if cell["cell_type"] == "code" and (sys.argv[1] == "block" or "animate(" not in src):
            exec(compile(src, path, "exec"), ns)
    keep = {k: np.array(ns[k].cpu() if hasattr(ns[k], "cpu") else ns[k])
            for k in ("solution", "noisy", "solution2", "on_device") if k in ns}
    np.savez(path.rsplit("/", 1)[-1].replace(".ipynb", ".npz"), **keep)
if sys.argv[1] == "block":
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu")]
print("ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' notebooks, run side by side in two processes."""
    dirs = {side: tmp_path_factory.mktemp(side) for side in ("port", "jax")}
    env = dict(os.environ, PYTHONPATH=str(REPO), MPLBACKEND="Agg", GPBOI_NB_DEVICE="cpu",
               JAX_PLATFORMS="cpu", GPBOI_NB_PLATFORM="cpu", OMP_NUM_THREADS="1")
    books = {"port": ("block", "torch_seird.ipynb", "torch_heat.ipynb"),
             "jax": ("jax", "seird.ipynb", "heat.ipynb")}
    procs = {
        side: subprocess.Popen(
            [sys.executable, "-c", RUNNER, mode, *(str(REPO / "examples" / b) for b in nbs)],
            cwd=dirs[side], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for side, (mode, *nbs) in books.items()
    }
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{side}: {stderr[-4000:]}"
        assert stdout.strip().endswith("ok")
        out[side] = dirs[side]
    return out


def _arrays(runs, side, name):
    return np.load(runs[side] / f"{name}.npz")


def test_port_notebooks_run_without_jax(runs):
    heat = _arrays(runs, "port", "torch_heat")
    assert (runs["port"] / "torch_heat_cubic.gif").stat().st_size > 0
    # The notebook's own check held: the device solve equals the host twin.
    assert heat["on_device"].shape == (41, 41) and np.isfinite(heat["on_device"]).all()


def test_seird_solution_matches_the_jax_notebook(runs):
    port, ref = _arrays(runs, "port", "torch_seird"), _arrays(runs, "jax", "seird")
    assert port["solution"].dtype == ref["solution"].dtype == np.float64
    np.testing.assert_allclose(port["solution"], ref["solution"], rtol=1e-10, atol=0)


def test_seird_noise_cell_support_and_shape(runs):
    port = _arrays(runs, "port", "torch_seird")
    noisy, clean = port["noisy"], port["solution"]
    assert noisy.shape == clean.shape == (5, 500) and np.isfinite(noisy).all()
    assert noisy.min() >= 0.0 and noisy.max() <= 1.0  # the truncated normal's support
    assert np.all(noisy[clean == 0.0] == 0.0)  # exact zeros stay zero
    assert np.abs(noisy - clean).max() > 1e-3  # the noise is there


@pytest.mark.parametrize("name", ["solution", "solution2"])
def test_heat_solutions_match_the_jax_notebook(runs, name):
    port, ref = _arrays(runs, "port", "torch_heat"), _arrays(runs, "jax", "heat")
    assert port[name].shape == ref[name].shape == (500, 500)
    np.testing.assert_allclose(port[name], ref[name], rtol=1e-10, atol=0)


def test_committed_notebooks_are_the_builders_output(tmp_path):
    spec = importlib.util.spec_from_file_location("build_torch_notebooks",
                                                  REPO / "scripts" / "build_torch_notebooks.py")
    builder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(builder)
    builder.main(out=str(tmp_path))
    for name in builder.NOTEBOOKS:
        assert (tmp_path / name).read_text() == (REPO / "examples" / name).read_text(), name


HEAT_WALL = r"""
import json
wall = load("scripts/torch_heat_solve_wall.py")
row = wall.compute(device="cpu", nx=21, nt=6)
assert_no_jax()
print(json.dumps(row))
"""


def test_heat_solve_wall_runs_without_jax():
    """``scripts/torch_heat_solve_wall.py``, which times the heat
    notebook's solve on a device against the host, at a tiny grid."""
    row = json.loads(run(HEAT_WALL).strip().splitlines()[-1])
    assert row["device"] == "cpu" and (row["nx"], row["nt"]) == (21, 6)
    assert row["device_s"] > 0 and row["host_s"] > 0
    assert row["max_rel_diff"] <= 1e-10  # the notebook's check of the device solve
