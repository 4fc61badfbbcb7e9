"""Benchmark of gp_bayesopinf_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository root. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; set-up loads the
program and its kernel library and warms up the cell's shapes, then the
paper's experiment runs back to back for ``--seconds``, after which
every experiment is held against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``checks`` and with ``--trace 1``
``breakdown``): with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiler kept in memory. The
compared numbers and their limits are also the last lines of standard
error. Exits non-zero, printing no result, without a CUDA device, with
fewer devices than the cell asks for, where the program is missing, or
where JAX or the JAX package was loaded, in this process or in one of
the check's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent


def _cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds."""
    cache = ROOT / "build" / "benchmark_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import measure, spec

    spec_ = spec.load(ROOT)
    cell = spec.Cell(spec_, args.workload, ROOT, HOME)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result, checks = measure.measure(cell, args.seed, args.seconds, bool(args.trace),
                                         device="cuda", t_start=T_START)
    except measure.ForbiddenModules as exc:
        print(exc, file=sys.stderr)
        return 3
    found = measure.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
