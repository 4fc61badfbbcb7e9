"""Import audit: nothing the card runs loads JAX or the JAX package, and the
reference loads nothing of the measured package. Modules are compared by
their whole top-level name: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gp_bayesopinf_tpu"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names


def _sources(sub=""):
    return sorted(p for p in (HOME / sub).rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(HOME)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "gp_bayesopinf_torch" not in names
    assert names <= {"math", "numpy", "scipy", "torch"}


def test_names_are_compared_whole():
    assert "gp_bayesopinf_torch".split(".")[0] not in FORBIDDEN
    assert "gp_bayesopinf_tpu.ops".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax():
    """What a run imports, with its program entry and reference, in a fresh
    process: the loaded modules' top-level names hold none of JAX's."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run as r, benchmark.calibrate\n"
        "from benchmark.harness import drive, measure, spec\n"
        "s = spec.load(%r)\n"
        "for w in s['workloads']:\n"
        "    c = spec.Cell(s, w['name'], %r, %r)\n"
        "    run = drive.Run(c, 'cpu')\n"
        "    drive.program_config(c.config, 1)\n"
        "print(r.forbidden_modules())\n"
    ) % (str(HOME.parent), str(HOME.parent), str(HOME.parent), str(HOME))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=HOME.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
