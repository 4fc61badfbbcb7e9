"""What the check reads of fitted GPs' weight roots, dense or factored."""

import numpy as np


def weights(gps) -> dict:
    """``gps`` nested lists over trajectories and GPs. Dense roots:
    {"covariance", "roots"}, each (L, r, m', m'). Factored roots
    (``weight_method`` "lowrank", which forms no C): {"lowrank"}, nested
    lists of each root's {"Q" (m', p), "gain" (p,), "lam" (p,)}, so that
    no (m', m') matrix is kept."""
    host = lambda x: x.detach().cpu().numpy()
    if gps[0][0].weight_method == "lowrank":
        return {"lowrank": [[{k: host(getattr(gp.lowrank_root, k)) for k in ("Q", "gain", "lam")}
                             for gp in row] for row in gps]}
    return {"covariance": np.stack([np.stack([host(gp.ddt_covariance) for gp in row])
                                    for row in gps]),
            "roots": np.stack([np.stack([host(gp.sqrtW) for gp in row]) for row in gps])}
