"""Wall of the heat notebook's solve (``examples/torch_heat.ipynb``) on a
device: ``CubicHeatBimodal.solve``, the SDIRK2 whose Newton steps are
batched Thomas solves on the device, against ``solve_host``, the same
scheme with LAPACK ``dgtsv`` on the host, at the notebook's 500 x 500
grid. Prints one JSON line: the card, both walls and the largest
difference of the two solutions relative to the largest state::

    python scripts/torch_heat_solve_wall.py [--device cuda]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gp_bayesopinf_torch.models.heat import CubicHeatBimodal  # noqa: E402
from gp_bayesopinf_torch.utils import resolve_device  # noqa: E402
from gp_bayesopinf_torch.utils.device import to_host  # noqa: E402
from gp_bayesopinf_torch.utils.reporting import card_line  # noqa: E402


def compute(*, device, nx=500, nt=500):
    """Both solves of the notebook's first model on an (nx, nt) grid (the
    tests' smaller ones)."""
    dev = resolve_device(device)
    x, t = np.linspace(0, 1, nx), np.linspace(0, 2, nt)
    model = CubicHeatBimodal(x, 0.0, 1.0, diffusion=5e-3, a=1.0, b=1.0)
    q0 = x * (1 - x) + x
    t0 = time.perf_counter()
    host = model.solve_host(q0, t)
    host_s = time.perf_counter() - t0
    q0_dev = torch.as_tensor(q0, dtype=torch.float64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    on_device = model.solve(q0_dev, t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    device_s = time.perf_counter() - t0
    diff = np.abs(to_host(on_device) - host).max() / np.abs(host).max()
    return {"card": card_line(dev), "device": str(dev), "nx": nx, "nt": nt,
            "device_s": device_s, "host_s": host_s, "max_rel_diff": float(diff)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    print(json.dumps(compute(device=args.device)), flush=True)


if __name__ == "__main__":
    main()
