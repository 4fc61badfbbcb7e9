"""Every public name of the JAX package has a counterpart in the PyTorch
port, or an entry with its reason on the exclusion list below.

Both packages are read with ``ast``, not imported. For each module of
``gp_bayesopinf_tpu/``, every public top-level function and class, and
every public method or property of a public class, must have a
counterpart of the same name in the port's mirror module: the module at
the same path, or the modules ``MIRRORS`` maps it to. A name counts as
present where the mirror module defines it or imports it; a method where
the class, or one of its bases in the port, defines it as a method or a
field. The exclusion lists are the audit of what the port leaves out; a
stale entry (a name the port now has, or one the JAX package lost) fails
the test too.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "gp_bayesopinf_tpu", REPO / "gp_bayesopinf_torch"

#: JAX module -> the port's modules that hold its counterparts.
MIRRORS = {
    "ops/ensemble_pallas.py": ["ops/ensemble_screen.py", "ops/cahbn_screen.py"],
    # The scaled pipeline is a package in the port, one module a stage.
    "pipeline/scaled.py": [f"pipeline/scaled/{m}.py" for m in
                           ("__init__", "data", "estimate", "gamma", "rollout", "search", "run")],
}

#: Whole JAX modules without a counterpart, and why.
EXCLUDED_MODULES = {
    "utils/aotcache.py": "TPU workaround: XLA ahead-of-time compile cache; the port builds "
                         "its kernels once and caches the libraries under build/",
    "utils/hostmath.py": "TPU workaround: float64 on a host CPU device beside the TPU; the "
                         "H100 runs float64 natively on the one device",
    "ops/chol.py": "jittable SPD helpers with validity flags and the TPU's unrolled "
                   "Cholesky; the port calls torch.linalg's cholesky_ex and cholesky_solve "
                   "(its spd_cholesky and spd_inverse_sqrt are in gp/estimates.py)",
    "native.py": "bindings of a C++ CPU library, a third backend used as a parity oracle "
                 "and host-side fallback; the port is held to the JAX package itself and "
                 "has no fallback",
}

#: Single JAX names without a counterpart, and why.
EXCLUDED = {
    "gp/estimates.py::default_weight_method": "TPU workaround: picks the Cholesky root where "
                                              "the TPU's emulated float64 eigh is slow",
    "gp/estimates.py::numpy_batched_gp_estimates": "TPU workaround: host NumPy twin of the "
                                                   "estimates for the TPU's float64",
    "gp/fit.py::default_fit_dtype": "TPU workaround: float32 fits on the TPU; the port fits "
                                    "in float64",
    "bayes/posterior.py::ensemble_dtype": "TPU workaround: float32 ensembles on the TPU; the "
                                          "port integrates in float64",
    "parallel/mesh.py::named_sharding": "JAX sharding object; the port's mesh is a process "
                                        "group with explicit collectives",
    "utils/logging.py::enable_nan_debugging": "flips jax_debug_nans; PyTorch has no global "
                                              "switch on kernel outputs",
    "utils/keys.py::key_from_seed": "threefry key; the port's named torch.Generator streams "
                                    "(stage_generators, host_rng) take its place",
    "utils/keys.py::split_tree": "threefry key split; replaced by the port's generator streams",
    "ops/ensemble_pallas.py::quadratic_ensemble_screen_xla": "XLA twin of the Pallas kernel; "
                                                             "the port's plain PyTorch version "
                                                             "takes its place",
    "ops/ensemble_pallas.py::cahbn_ensemble_screen_xla": "XLA twin of the Pallas kernel; the "
                                                         "port's plain PyTorch version takes "
                                                         "its place",
}


def _public(name):
    return not name.startswith("_")


def _module_names(tree):
    """{top-level name: node} of functions, classes and imported names."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = alias
    return out


def _members(cls):
    """Names a class body defines: methods, properties and fields."""
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _parse(root):
    return {str(p.relative_to(root)): ast.parse(p.read_text()) for p in sorted(root.rglob("*.py"))}


JAX_MODULES, PORT_MODULES = _parse(JAX), _parse(PORT)
PORT_CLASSES = {}
for _tree in PORT_MODULES.values():
    for _node in _tree.body:
        if isinstance(_node, ast.ClassDef):
            PORT_CLASSES.setdefault(_node.name, []).append(_node)


def _class_members(name, seen=()):
    """Members of every port class of this name and of its bases."""
    out = set()
    for cls in PORT_CLASSES.get(name, []):
        out |= _members(cls)
        for base in cls.bases:
            base_name = base.id if isinstance(base, ast.Name) else None
            if base_name and base_name not in seen:
                out |= _class_members(base_name, seen + (name,))
    return out


def _jax_public(tree):
    """Public functions, classes and ``Class.method`` names of a module."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and _public(node.name):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and _public(sub.name)]
    return out


def _missing(module):
    mirrors = MIRRORS.get(module, [module])
    absent = [m for m in mirrors if m not in PORT_MODULES]
    assert not absent, f"{module}: no mirror module {absent} in the port"
    present = {}
    for m in mirrors:
        present.update(_module_names(PORT_MODULES[m]))
    missing = []
    for name in _jax_public(JAX_MODULES[module]):
        cls, _, method = name.partition(".")
        if cls not in present:
            missing.append(name)
        elif method and method not in _class_members(cls):
            missing.append(name)
    return missing


COVERED = sorted(m for m in JAX_MODULES if m not in EXCLUDED_MODULES)


@pytest.mark.parametrize("module", COVERED)
def test_every_public_name_has_a_counterpart(module):
    missing = [n for n in _missing(module) if f"{module}::{n}" not in EXCLUDED]
    assert not missing, f"gp_bayesopinf_tpu/{module}: no counterpart in the port for {missing}"


def test_exclusions_are_current():
    """Each excluded module exists in the JAX package and has no mirror;
    each excluded name is public in its JAX module and still missing from
    the port; each mirror module exists."""
    for module, reason in EXCLUDED_MODULES.items():
        assert module in JAX_MODULES and module not in PORT_MODULES and reason
    for entry, reason in EXCLUDED.items():
        module, name = entry.split("::")
        assert name in _jax_public(JAX_MODULES[module]), entry
        assert name in _missing(module), f"{entry} is in the port now: drop its exclusion"
        assert reason
    for module, mirrors in MIRRORS.items():
        assert module in JAX_MODULES and all(m in PORT_MODULES for m in mirrors), module
