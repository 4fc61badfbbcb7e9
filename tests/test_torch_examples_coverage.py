"""Every file under ``examples/`` and ``scripts/`` that imports or runs
the JAX package has a counterpart on the port at a named path, or an
entry with its reason on the exclusion list below.

A Python file uses the JAX package where it imports ``gp_bayesopinf_tpu``
or names it in a string other than a docstring (``python -m
gp_bayesopinf_tpu...``, a notebook cell it writes), read with ``ast``; a
notebook where a code cell names it; a shell script where a line other
than a comment names it or runs the ``gpboi`` CLI. A counterpart must exist and must
itself use neither ``gp_bayesopinf_tpu`` nor ``jax``. A stale entry (a
file that is gone, or no longer uses the JAX package) fails the test too.
"""

import ast
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

#: A JAX-era file -> its counterpart on the port.
COUNTERPARTS = {
    "examples/seird_demo.py": "examples/torch_seird_demo.py",
    "examples/euler_demo.py": "examples/torch_euler_demo.py",
    "examples/extrapolation_study.py": "examples/torch_extrapolation_study.py",
    "examples/seird.ipynb": "examples/torch_seird.ipynb",
    "examples/heat.ipynb": "examples/torch_heat.ipynb",
    "scripts/build_notebooks.py": "scripts/build_torch_notebooks.py",
    "scripts/ex1a_stability_study.py": "scripts/torch_ex1a_stability_study.py",
    "scripts/lowrank_fidelity_sweep.py": "scripts/torch_lowrank_fidelity_sweep.py",
    "scripts/blocked_reg_study.py": "scripts/torch_blocked_reg_study.py",
}

#: Files that use the JAX package and have no counterpart, and why.
EXCLUDED = {
    "examples/gp_backends.ipynb": "its second backend is native.py, which the package audit "
                                  "excludes (tests/test_torch_api_coverage.py, "
                                  "EXCLUDED_MODULES['native.py'])",
    "scripts/aot_warm_process.py": "TPU workaround: warms the XLA ahead-of-time compile cache",
    "scripts/mfu_table.py": "TPU v5e peaks and the MXU; the port's kernels are held against "
                            "their H100 bounds in chip_smoke.py",
    "scripts/mesh_scaling_study.py": "a virtual XLA CPU mesh; the port's mesh is measured by "
                                     "chip_smoke.py phase mesh",
    "scripts/profile_fit.py": "profiles XLA programs; scripts/torch_stage_profile.py takes "
                              "its place",
    "scripts/seird_wall_series.py": "a wall series is the benchmark's work",
    "scripts/experiments.sh": "scripts/torch_experiments.sh takes its place",
    # Not JAX-era: a bridge that needs JAX by design.
    "scripts/jax_ex1a_instance.py": "exports the JAX package's ex1a random inputs "
                                    "(docs/torch/ex1a_jax_instance.npz) for the port's "
                                    "stability study to run on the JAX data instance",
}


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def uses(path: Path, package: str = "gp_bayesopinf_tpu") -> bool:
    """Whether the file imports or runs ``package``."""
    text = path.read_text()
    if path.suffix == ".py":
        tree = ast.parse(text)
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == package for a in node.names):
                return True
            if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == package:
                return True
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs and re.search(rf"\b{package}\b", node.value)):
                return True
        return False
    if path.suffix == ".ipynb":
        return any(package in "".join(cell["source"])
                   for cell in json.loads(text)["cells"] if cell["cell_type"] == "code")
    if path.suffix == ".sh":  # comments left out
        code = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("#"))
        runs_cli = package == "gp_bayesopinf_tpu" and re.search(r"^\s*gpboi\s", code, re.M)
        return bool(re.search(rf"\b{package}\b", code) or runs_cli)
    return False


FILES = sorted(str(p.relative_to(REPO)) for d in ("examples", "scripts")
               for p in (REPO / d).iterdir() if p.suffix in (".py", ".ipynb", ".sh"))
USERS = [f for f in FILES if uses(REPO / f)]


@pytest.mark.parametrize("path", USERS)
def test_every_jax_era_file_has_a_counterpart_or_a_reason(path):
    assert path in COUNTERPARTS or path in EXCLUDED, (
        f"{path} uses gp_bayesopinf_tpu: add its port counterpart to COUNTERPARTS or a reason "
        "to EXCLUDED")
    assert not (path in COUNTERPARTS and path in EXCLUDED)


@pytest.mark.parametrize("path, port", sorted(COUNTERPARTS.items()))
def test_counterparts_exist_and_use_no_jax(path, port):
    assert (REPO / port).is_file(), f"{port} is missing"
    assert not uses(REPO / port) and not uses(REPO / port, "jax"), f"{port} uses JAX"


def test_no_stale_entry():
    stale = [f for f in {**COUNTERPARTS, **EXCLUDED} if f not in USERS]
    assert not stale, f"entries for files that are gone or no longer use the JAX package: {stale}"
    assert all(reason for reason in EXCLUDED.values())


def test_every_port_script_uses_no_jax():
    port = [f for f in FILES if Path(f).name.startswith("torch_")
            or Path(f).name == "build_torch_notebooks.py"]
    assert set(COUNTERPARTS.values()) <= set(port)
    assert not [f for f in port if uses(REPO / f) or uses(REPO / f, "jax")]
