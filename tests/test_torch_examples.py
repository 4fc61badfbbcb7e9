"""The port's demos, ``examples/torch_seird_demo.py`` and
``examples/torch_euler_demo.py``, at a tiny size on the CPU, each in a
fresh interpreter where ``jax``, ``jaxlib`` and ``gp_bayesopinf_tpu``
refuse to import: the run and its report go through, the figure files
are the ones the JAX demos save (their ``savefig`` calls read with
``ast``), and the error each prints equals the formula computed
independently on the result (rtol 1e-12); the extrapolation study's row
and report on the Euler demo's run. Without matplotlib every
figure-drawing script stops with an ImportError naming it before it runs
anything."""

import ast
import json
import re
from pathlib import Path

import pytest
from _torch_no_jax import REPO, run

SEIRD = r"""
import json, os
import numpy as np
from gp_bayesopinf_torch.pipeline.configs import GPBounds, SEIRDConfig
from gp_bayesopinf_torch.pipeline.odes import ensemble_error
demo = load("examples/torch_seird_demo.py")
out = sys.argv[1]
config = SEIRDConfig(time_domain=np.linspace(0, 90, 61),
                     gp_bounds=GPBounds((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5), 8),
                     reg_grid=np.logspace(-10, 2, 6))
res = demo.compute(device="cpu", config=config, verbose=False, training_span=(0.0, 60.0),
                   num_samples=24, noiselevel=0.05, num_regression_points=48, ndraws=40)
assert res.crosscheck is not None
demo.report(res, out)
assert_no_jax()
print(json.dumps({"files": sorted(os.listdir(out)), "independent": ensemble_error(res)}))
"""

EULER = r"""
import json, os
import numpy as np, torch
from gp_bayesopinf_torch.pipeline.configs import EulerConfig, GPBounds
demo = load("examples/torch_euler_demo.py")
out = sys.argv[1]
config = EulerConfig(spatial_domain=np.linspace(0, 2, 41)[:-1], time_domain=np.linspace(0, 0.09, 61),
                     gp_bounds=GPBounds((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2), 16),
                     reg_grid=np.logspace(-10, 4, 9))
res = demo.compute(device="cpu", config=config, verbose=False, num_samples=40,
                   num_regression_points=60, num_pod_modes=3, ndraws=50)
demo.report(res, out)
# The training-domain error, independently: the compressed truth and the
# valid draws' mean as tensors, restricted to the times inside the span.
inside = torch.as_tensor(res.time_domain <= res.t_estimation[-1])
truth = res.basis.compress(res.true_states)[:, inside]
mean = res.draws_compressed[res.valid].mean(dim=0)[:, inside]
# The extrapolation study's row and report, on this run.
study = load("examples/torch_extrapolation_study.py")
row = study.summarize("ex1a", res, 1.0)
study.write_report({"card": "cpu (no card)", "device": "cpu", "ndraws": 50,
                    "t_train": study.T_TRAIN, "rows": [row]}, out + "/study", figures=False)
assert_no_jax()
print(json.dumps({"files": sorted(os.listdir(out)),
                  "independent": float(torch.linalg.norm(mean - truth) / torch.linalg.norm(truth))}))
"""

REFUSE = r"""
def ran(*args, **kwargs):
    raise AssertionError("the run started before the figures were checked")
for script in ("examples/torch_seird_demo.py", "examples/torch_euler_demo.py",
               "examples/torch_extrapolation_study.py"):
    mod = load(script)
    mod.compute = ran
    try:
        mod.main(["--device", "cpu"])
    except ImportError as exc:
        assert "matplotlib" in str(exc), exc
        print("refused", script)
"""


def saved_names(path):
    """The file names a script's ``savefig`` calls write: the last argument
    of an ``os.path.join``, an f-string's fields as ``{}``."""
    names = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "savefig":
            arg = node.args[0]
            if isinstance(arg, ast.Call):  # os.path.join(outdir, name)
                arg = arg.args[-1]
            if isinstance(arg, ast.JoinedStr):
                names.append("".join(v.value if isinstance(v, ast.Constant) else "{}"
                                     for v in arg.values))
            else:
                names.append(arg.value)
    return names


def _printed_error(stdout, label):
    line = next(x for x in stdout.splitlines() if x.startswith(label))
    return float(re.search(r"\(([^()]+)\)$", line).group(1))


@pytest.mark.parametrize("demo, script, label", [
    ("seird", SEIRD, "ensemble-mean relative error vs truth:"),
    ("euler", EULER, "reduced-space training-domain error of ensemble mean:"),
], ids=["seird", "euler"])
def test_demo_runs_without_jax(tmp_path, demo, script, label):
    stdout = run(script, tmp_path)
    result = json.loads(stdout.strip().splitlines()[-1])
    names = saved_names(REPO / "examples" / f"{demo}_demo.py")
    # Each JAX file name, a template's field filled by the variable index.
    expected = {n.format(v) for n in names for v in range(3)}
    figures = {f for f in result["files"] if f.endswith(".pdf")}
    assert figures == expected and len(names) == 3
    if demo == "euler":  # the extrapolation study's report on the same run
        text = (tmp_path / "study" / "extrapolation_study.md").read_text()
        assert "| ex1a |" in text and "## Findings" in text
    if demo == "seird":
        assert "report.txt" in result["files"]
        assert "POSTERIOR DISTRIBUTION" in (tmp_path / "report.txt").read_text()
    printed = _printed_error(stdout, label)
    assert printed == pytest.approx(result["independent"], rel=1e-12, abs=0.0)


def test_figures_without_matplotlib_refuse_before_running():
    # The first argument stands where the demos take their output folder.
    lines = run(REFUSE, "-", "matplotlib", timeout=120).split()
    assert lines.count("refused") == 3
