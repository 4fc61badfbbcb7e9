"""Small copies of the benchmark's cells for the CPU tests: the real
configuration, traffic and check files with the sizes cut so that a run
takes seconds on the CPU, written as new files into a folder of their own
with a ``BENCHMARK.json`` that names them, as a later cell would be
added.

Each cell's cut is a file of its own, ``tests/tiny/<cell>.json``, found by
the cell's name: the tiny cell's ``name`` (its configuration's and its
traffic mix's names joined by a dot), the changes to the configuration's
``config`` (cells of one configuration give the same), to the traffic's
``args`` and ``kwargs``, and the (r, d, trajectories, inputs) of its
``screens``.
"""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: The tiny pool's one data seed, at which every tiny experiment runs
#: through (some tiny data instances leave no stable regularizer on the
#: small grid).
DATA_SEED = 618000647
#: A run's seed: with a pool of one, any.
SEED = 3000000001


def tiny_file(cell: str, root: Path = ROOT) -> dict:
    """The tiny cut of ``cell``, from ``benchmark/tests/tiny/<cell>.json``
    under ``root``."""
    path = root / "benchmark" / "tests" / "tiny" / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"cell {cell} has no tiny copy: {path} is missing")
    return json.loads(path.read_text())


def cells(root: Path = ROOT) -> list:
    """The tiny cells' names, one for each cell of ``BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    return [tiny_file(w["name"], root)["name"] for w in spec["workloads"]]


def build(folder: Path, root: Path = ROOT) -> Path:
    """Write the tiny cells' files and their ``BENCHMARK.json`` into
    ``folder``, laid out as the benchmark's own directory, from the
    repository at ``root``; returns ``folder``."""
    home = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "checks"):
        (folder / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(home / "metrics", folder / "metrics", dirs_exist_ok=True)
    configs, cells_, renamed, changes = [], [], {}, {}
    for cell in spec["workloads"]:
        tiny = tiny_file(cell["name"], root)
        name, args_change, screen = tiny["name"], tiny["args"], tiny["screens"]
        cfg_name, traffic = name.split(".")
        entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
        config = json.loads((root / entry["file"]).read_text())
        config["config"].update(tiny["config"])
        config["config"]["gp_bounds"]["n_restarts"] = 8
        if changes.setdefault(cfg_name, tiny["config"]) != tiny["config"]:
            raise ValueError(f"tiny cells of {cfg_name} change its config differently")
        if not any(c["name"] == cfg_name for c in configs):
            (folder / "configs" / f"{cfg_name}.json").write_text(json.dumps(config, indent=1))
            configs.append(dict(entry, name=cfg_name, file=f"configs/{cfg_name}.json"))
        mix = json.loads((home / "traffic" / f"{cell['traffic']}.json").read_text())
        mix["args"].update(args_change)
        mix["kwargs"].update(tiny["kwargs"])
        mix["data_seeds"] = [DATA_SEED]
        span = mix["args"]["training_span"]
        gp = mix["warmup"]["gp"]
        gp.update(rows=screen["r"] * screen["trajectories"], samples=args_change["num_samples"],
                  points=args_change["num_regression_points"])
        grids = [config["config"]["time_domain"],
                 {"linspace": [span[0], span[1], args_change["num_regression_points"]]}]
        for sc, grid in zip(mix["warmup"]["screens"], grids):
            sc.update(r=screen["r"], d=screen["d"], trajectories=screen["trajectories"], grid=grid)
            if screen["inputs"]:
                sc["inputs"] = screen["inputs"]
        (folder / "traffic" / f"{traffic}.json").write_text(json.dumps(mix, indent=1))
        check = json.loads((home / "checks" / f"{cell['name']}.json").read_text())
        check.update(draws=8, decompressed=3)
        (folder / "checks" / f"{name}.json").write_text(json.dumps(check, indent=1))
        cells_.append(dict(cell, name=name, config=cfg_name, traffic=traffic))
        renamed[cell["name"]] = name
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"]]
    spec.update(configs=configs, workloads=cells_, paths=["configs"])
    (folder / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return folder
