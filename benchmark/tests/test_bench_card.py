"""A run of each cell on the card, as the benchmark's command makes it: the result
line's keys and the check's verdict. Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests import _tiny

CELLS = [w["name"] for w in json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=_tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["correct"], result["checks"]
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
