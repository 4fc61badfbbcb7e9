"""BENCHMARK.json and its files: names and units, every cell's files found
by name, a cell added from new files alone, and the harness's refusal to
measure without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import drive, spec
from benchmark.tests import _tiny

ROOT = _tiny.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_benchmark_json_is_valid():
    s = spec.load(ROOT)
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]


def test_names_and_units_use_the_allowed_characters():
    s = spec.load(ROOT)
    names = [c["name"] for c in s["configs"]] + [w["name"] for w in s["workloads"]]
    names += [w[k] for w in s["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert all(spec.NAME.match(n) for n in names)
    assert all(spec.UNIT.match(m["unit"]) for m in s["end_to_end"] + s["per_layer"])
    assert all(n.isascii() for n in names)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cells_files_are_found_by_name(cell):
    c = spec.Cell(spec.load(ROOT), cell, ROOT, ROOT / "benchmark")
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["args"] and c.check["limits"]
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    for name, reader in c.readers.items():
        assert reader.NAME == name


@pytest.mark.parametrize("cell", CELLS)
def test_every_run_draws_its_data_seeds_from_the_pool(cell):
    pool = spec.Cell(spec.load(ROOT), cell, ROOT, ROOT / "benchmark").traffic["data_seeds"]
    assert len(pool) >= 10 and len(set(pool)) == len(pool)
    orders = set()
    for seed in (1, 2, 2**31 + 5, 2**40 + 7):
        seeds = [drive.experiment_seed(seed, i, pool) for i in range(len(pool))]
        assert sorted(seeds) == sorted(pool)
        assert seeds == [drive.experiment_seed(seed, i, pool) for i in range(len(pool))]
        orders.add(tuple(seeds))
    assert len(orders) > 1


def test_a_cell_added_from_new_files_is_found_and_validated(tmp_path):
    folder = _tiny.build(tmp_path)
    s = spec.load(folder)
    for cell in s["workloads"]:
        c = spec.Cell(s, cell["name"], folder, folder)
        assert c.config["config"]["reg_grid"] == {"logspace": [-16, 4, 17]}
        assert c.readers


@pytest.mark.parametrize("breakage", ["space in a name", "unknown source", "bound too loose",
                                      "no setup_s", "missing reader", "unknown cell"])
def test_a_broken_spec_is_refused(tmp_path, breakage):
    folder = _tiny.build(tmp_path)
    s = json.loads((folder / "BENCHMARK.json").read_text())
    if breakage == "space in a name":
        s["per_layer"][0]["name"] = "data s"
    elif breakage == "unknown source":
        s["end_to_end"][0]["source"] = "program_span"
    elif breakage == "bound too loose":
        s["end_to_end"][0]["bound"] = 0.3
    elif breakage == "no setup_s":
        s["end_to_end"] = s["end_to_end"][:1]
    elif breakage == "unknown cell":
        s["per_layer"][0]["workloads"] = ["nowhere.cell"]
    (folder / "BENCHMARK.json").write_text(json.dumps(s))
    if breakage == "missing reader":
        os.remove(folder / "metrics" / "data_s.py")
        with pytest.raises(spec.SpecError):
            spec.Cell(spec.load(folder), s["workloads"][0]["name"], folder, folder)
        return
    with pytest.raises(spec.SpecError):
        spec.load(folder)


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "euler.ex1a", "--seed",
         "2147483653", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_harness_refuses_to_measure_without_a_card():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_harness_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
