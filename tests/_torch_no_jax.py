"""Runs a script of the port in a fresh interpreter where ``jax``,
``jaxlib`` and ``gp_bayesopinf_tpu`` refuse to import (and so does every
top-level package named after the script's first argument), with
``load(path)`` to import a file of the repo by its path."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCK = r"""
import importlib.abc, sys
import torch
torch.set_num_threads(1)
BLOCKED = ("jax", "jaxlib", "gp_bayesopinf_tpu") + tuple(sys.argv[2:])
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
sys.meta_path.insert(0, Block())
import importlib.util
def load(rel):
    spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
def assert_no_jax():
    blocked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gp_bayesopinf_tpu")]
    assert not blocked, blocked
"""


def start(script, *args):
    """``BLOCK + script`` with ``args`` (``sys.argv[1:]``), started from
    the repo's root."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-c", BLOCK + script, *map(str, args)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, timeout=300):
    """The standard output of a process ``start`` began, once it exits 0."""
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-4000:]
    return stdout


def run(script, *args, timeout=300):
    return finish(start(script, *args), timeout)
