"""``BENCHMARK.json`` and the files it names: loading, validation, and
finding a cell's configuration, traffic mix, check and per-layer metric
readers by name.

Everything that belongs to one configuration, traffic mix, cell or
metric lives in a file of its own, found by the name in
``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the experiment's arguments and loop;
* ``checks/<workload>.json``: the sample the reference checks, and the
  limit of each number the check compares;
* ``metrics/<metric>.py``: a reader with ``NAME``, ``UNIT``, ``LAYER``,
  ``MOVES`` and ``read(run)``.

A cell added from new files alone is found and validated without an edit
here.
"""

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the benchmark's rules."""


def _text(value, what):
    if not isinstance(value, str) or not 1 <= len(value) <= 200 or "\n" in value or "\t" in value:
        raise SpecError(f"{what} must be 1 to 200 characters on one line, got {value!r}")


def _name(value, what):
    if not isinstance(value, str) or not NAME.match(value):
        raise SpecError(f"{what} {value!r} is not a valid name")


def _exact_keys(entry, required, optional=(), what="entry"):
    keys = set(entry)
    if not set(required) <= keys or not keys <= set(required) | set(optional):
        raise SpecError(f"{what} has keys {sorted(keys)}, wants {sorted(required)}"
                        + (f" and optionally {sorted(optional)}" if optional else ""))


def validate(spec: dict, root: Path) -> None:
    """Raise ``SpecError`` where ``spec`` (the parsed ``BENCHMARK.json``)
    breaks a rule of the benchmark's contract that a file can show."""
    _exact_keys(spec, TOP_KEYS, what="BENCHMARK.json")
    command, paths = spec["command"], spec["paths"]
    if not isinstance(command, list) or not 1 <= len(command) <= 32:
        raise SpecError("command must be a list of 1 to 32 strings")
    for word in command:
        _text(word, "a word of command")
        if word.startswith("/") or ".." in Path(word).parts:
            raise SpecError(f"command word {word!r} leaves the repository")
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise SpecError("paths must list 1 to 16 directories")
    for p in paths:
        if not re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) or p.startswith("/") or ".." in p.split("/"):
            raise SpecError(f"path {p!r} is not a relative path of the allowed characters")
    rs = spec["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        raise SpecError("run_seconds must be a whole number from 1 to 51")

    configs = {}
    if not 1 <= len(spec["configs"]) <= 24:
        raise SpecError("configs must hold 1 to 24 entries")
    for c in spec["configs"]:
        _exact_keys(c, ("name", "source", "file", "reduced", "why"), what=f"config {c.get('name')}")
        _name(c["name"], "config name")
        _text(c["source"], "source")
        _text(c["why"], "why")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError("reduced must list at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise SpecError(f"config file {c['file']} is not under paths")
        if not (root / c["file"]).is_file():
            raise SpecError(f"config file {c['file']} is missing")
        if c["name"] in configs:
            raise SpecError(f"config {c['name']} appears twice")
        configs[c["name"]] = c
    if len({c["file"] for c in spec["configs"]}) != len(configs):
        raise SpecError("two configurations share a file")

    cells, pairs, used = {}, set(), set()
    if not 1 <= len(spec["workloads"]) <= 24:
        raise SpecError("workloads must hold 1 to 24 cells")
    for w in spec["workloads"]:
        _exact_keys(w, ("name", "config", "traffic", "chips", "why"), what=f"cell {w.get('name')}")
        for key in ("name", "config", "traffic"):
            _name(w[key], f"cell {key}")
        _text(w["why"], "why")
        if w["config"] not in configs:
            raise SpecError(f"cell {w['name']} names an unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"cell {w['name']} asks for {w['chips']} chips (1 or 4)")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"cell {w['name']} or its pair of config and traffic appears twice")
        cells[w["name"]] = w
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    if used != set(configs):
        raise SpecError(f"configs used by no cell: {sorted(set(configs) - used)}")
    if sum(w["chips"] == 4 for w in cells.values()) > max(1, len(cells) // 4):
        raise SpecError("too many cells on four chips")

    metrics = set()
    e2e = spec["end_to_end"]
    if not 1 <= len(e2e) <= 16 or "setup_s" not in {m.get("name") for m in e2e}:
        raise SpecError("end_to_end must hold 1 to 16 metrics, setup_s among them")
    if not 1 <= len(spec["per_layer"]) <= 128:
        raise SpecError("per_layer must hold 1 to 128 metrics")
    for m in e2e + spec["per_layer"]:
        per_layer = m in spec["per_layer"]
        required = ("name", "unit", "better", "source") + (
            ("layer", "moves") if per_layer else ("bound",))
        _exact_keys(m, required, ("workloads",), what=f"metric {m.get('name')}")
        _name(m["name"], "metric name")
        if not UNIT.match(m["unit"]):
            raise SpecError(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"better of {m['name']} must be lower or higher")
        if m["source"] not in SOURCES or (not per_layer and m["source"] not in SOURCES[::3]):
            raise SpecError(f"source {m['source']!r} of {m['name']}")
        if m["name"] in metrics:
            raise SpecError(f"metric {m['name']} appears twice")
        metrics.add(m["name"])
        for cell in m.get("workloads", []):
            if cell not in cells:
                raise SpecError(f"metric {m['name']} lists an unknown cell {cell}")
        if per_layer:
            _text(m["layer"], "layer")
            if m["moves"] not in {e["name"] for e in e2e}:
                raise SpecError(f"{m['name']} moves {m['moves']}, not an end-to-end metric")
        else:
            limit = 0.25
            if not isinstance(m["bound"], (int, float)) or not 0.01 <= m["bound"] <= limit:
                raise SpecError(f"bound of {m['name']} must lie in [0.01, {limit}]")
    for cell in cells:
        e2e_here = [m for m in e2e if cell in m.get("workloads", [cell])]
        if len(e2e_here) < 2:
            raise SpecError(f"cell {cell} reports no end-to-end metric beside setup_s")
        names = {m["name"] for m in e2e_here}
        if not any(cell in m.get("workloads", [cell]) and m["moves"] in names
                   for m in spec["per_layer"]):
            raise SpecError(f"cell {cell} reports no per-layer metric")


def load(root) -> dict:
    """The validated ``BENCHMARK.json`` at ``root``."""
    root = Path(root)
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    if path.stat().st_size > 64 * 1024:
        raise SpecError("BENCHMARK.json is larger than 64 KiB")
    spec = json.loads(path.read_text())
    validate(spec, root)
    return spec


class Cell:
    """One workload of ``BENCHMARK.json`` with its files, found by name
    under ``home`` (the benchmark's directory)."""

    def __init__(self, spec: dict, name: str, root, home):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SpecError(f"no cell {name!r}; cells: {sorted(cells)}")
        root, home = Path(root), Path(home)
        self.spec, self.name, self.entry = spec, name, cells[name]
        self.chips = self.entry["chips"]
        cfg_entry = next(c for c in spec["configs"] if c["name"] == self.entry["config"])
        self.config = _read_json(root / cfg_entry["file"])
        self.traffic = _read_json(home / "traffic" / f"{self.entry['traffic']}.json")
        self.check = _read_json(home / "checks" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
        self.readers = {m["name"]: load_reader(home / "metrics" / f"{m['name']}.py", m)
                        for m in self.per_layer}


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    return json.loads(path.read_text())


def load_reader(path: Path, entry: dict):
    """The reader module of one per-layer metric, checked against its
    entry in ``BENCHMARK.json``."""
    if not path.is_file():
        raise SpecError(f"no reader {path} for metric {entry['name']}")
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", entry["name"])
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    for key in ("name", "unit", "layer", "moves"):
        if getattr(mod, key.upper(), None) != entry[key]:
            raise SpecError(f"reader {path.name}: {key.upper()} is not {entry[key]!r}")
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"reader {path.name} has no read(run)")
    return mod
