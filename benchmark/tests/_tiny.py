"""Small copies of the benchmark's cells for the CPU tests: the real
configuration, traffic and check files with the sizes cut so that a run
takes seconds on the CPU, written as new files into a folder of their own
with a ``BENCHMARK.json`` that names them, as a later cell would be
added."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HOME = ROOT / "benchmark"

#: Per cell: the tiny cell's name, its config and traffic changes, and the
#: (r, d, trajectories, inputs) of its screens.
TINY = {
    "euler.ex1a": ("tiny_euler.tiny1a", {
        "spatial_domain": {"linspace": [0.0, 2.0, 41], "drop_last": True},
        "time_domain": {"linspace": [0.0, 0.15, 41]},
        "reg_grid": {"logspace": [-16, 4, 17]},
    }, {"num_samples": 40, "num_regression_points": 60, "num_pod_modes": 3}, {"ndraws": 50},
        (3, 10, 1, 0)),
    "heat.ex3": ("tiny_heat.tiny3", {
        "spatial_domain": {"linspace": [0.0, 1.0, 41]},
        "time_domain": {"linspace": [0.0, 2.0, 21]},
        "input_parameters": [[-2, 0], [1, -1]],
        "reg_grid": {"logspace": [-16, 4, 17]},
    }, {"num_samples": 12, "num_regression_points": 20, "num_pod_modes": 3}, {"ndraws": 20},
        (3, 18, 2, 2)),
}
#: The tiny pool's one data seed, at which every tiny experiment runs
#: through (some tiny data instances leave no stable regularizer on the
#: small grid).
DATA_SEED = 618000647
#: A run's seed: with a pool of one, any.
SEED = 3000000001


def build(folder: Path) -> Path:
    """Write the tiny cells' files and their ``BENCHMARK.json`` into
    ``folder``, laid out as the benchmark's own directory; returns it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "checks"):
        (folder / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HOME / "metrics", folder / "metrics", dirs_exist_ok=True)
    configs, cells, renamed = [], [], {}
    for cell in spec["workloads"]:
        name, cfg_change, args_change, kwargs_change, shape = TINY[cell["name"]]
        cfg_name, traffic = name.split(".")
        config = json.loads((ROOT / next(c["file"] for c in spec["configs"]
                                         if c["name"] == cell["config"])).read_text())
        config["config"].update(cfg_change)
        config["config"]["gp_bounds"]["n_restarts"] = 8
        (folder / "configs" / f"{cfg_name}.json").write_text(json.dumps(config, indent=1))
        mix = json.loads((HOME / "traffic" / f"{cell['traffic']}.json").read_text())
        mix["args"].update(args_change)
        mix["kwargs"].update(kwargs_change)
        mix["data_seeds"] = [DATA_SEED]
        r, d, L, nu = shape
        span = args_change.get("training_span", mix["args"]["training_span"])
        gp = mix["warmup"]["gp"]
        gp.update(rows=r * L, samples=args_change["num_samples"],
                  points=args_change["num_regression_points"])
        grids = [cfg_change["time_domain"],
                 {"linspace": [span[0], span[1], args_change["num_regression_points"]]}]
        for screen, grid in zip(mix["warmup"]["screens"], grids):
            screen.update(r=r, d=d, trajectories=L, grid=grid)
            if nu:
                screen["inputs"] = nu
        (folder / "traffic" / f"{traffic}.json").write_text(json.dumps(mix, indent=1))
        check = json.loads((HOME / "checks" / f"{cell['name']}.json").read_text())
        check.update(draws=8, decompressed=3)
        (folder / "checks" / f"{name}.json").write_text(json.dumps(check, indent=1))
        entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
        configs.append(dict(entry, name=cfg_name, file=f"configs/{cfg_name}.json"))
        cells.append(dict(cell, name=name, config=cfg_name, traffic=traffic))
        renamed[cell["name"]] = name
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"]]
    spec.update(configs=configs, workloads=cells, paths=["configs"])
    (folder / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return folder
