"""What the check reads of one multi-trajectory heat experiment
(``run_heat_multi``'s result and the harness's captures), as NumPy arrays
on the host."""

import numpy as np


def observe(result, capture, pick):
    """The observations of one experiment; ``pick`` as in
    ``observe.euler``."""
    host = lambda x: x.detach().cpu().numpy()
    gps = result.gps  # gps[ell][i]
    post = result.bayesian_model.posterior
    search = capture["search"]
    valid = host(result.valid)  # (L, ndraws)
    J, cands, _ = pick(valid.shape[1], np.asarray(search.grid_errors))
    L, r = len(gps), len(gps[0])
    out = {
        "t_sampled": np.asarray(result.time_domain_sampled),
        "truth": host(result.true_states),
        "snapshots": host(result.snapshots),
        "compressed": host(result.snapshots_compressed),
        "theta": np.array([[[gp.constant, gp.length_scale, gp.noise_level] for gp in g]
                           for g in gps]),
        "nlml": np.asarray(capture["nlml"]).reshape(L, r),
        "state_est": np.stack([np.stack([host(gp.state_estimate) for gp in g]) for g in gps]),
        "ddt_est": np.stack([np.stack([host(gp.ddt_estimate) for gp in g]) for g in gps]),
        "covariance": np.stack([np.stack([host(gp.ddt_covariance) for gp in g]) for g in gps]),
        "roots": np.stack([np.stack([host(gp.sqrtW) for gp in g]) for g in gps]),
        "post_mean": host(post.means),
        "post_cov": host(post.covariances()),
        "factor": host(post.cov_factors),
        "grid_errors": np.asarray(search.grid_errors),
        "lam": float(result.regularizer),
        "refined": bool(search.refined),
        "candidates": cands,
        "draws_index": J,
        "valid": valid,
        "draws": host(result.draws_compressed[:, J]),
    }
    if result.newparam_draws is not None:
        out.update(newparam_draws=host(result.newparam_draws[J]),
                   newparam_valid=host(result.newparam_valid),
                   newparam_truth=host(result.newparam_true))
    return out
