"""What the check reads of one Euler experiment (``run_euler``'s result
and the harness's captures), as NumPy arrays on the host."""

import numpy as np


def observe(result, capture, pick):
    """The observations of one experiment; ``pick(ndraws, grid_errors)``
    gives the sampled (draw indices, candidate indices, how many of the
    sampled valid draws to check decompressed)."""
    host = lambda x: x.detach().cpu().numpy()
    gps = result.gps
    post = result.bayesian_model.posterior
    search = capture["search"]
    valid = host(result.valid)
    J, cands, n_dec = pick(len(valid), np.asarray(search.grid_errors))
    # The decompressed draws are the valid draws in order.
    position = np.cumsum(valid) - 1
    dec = [j for j in J if valid[j]][:n_dec]
    return {
        "t_sampled": np.asarray(result.time_domain_sampled),
        "truth": host(result.true_states)[None],
        "snapshots": host(result.snapshots_sampled)[None],
        "compressed": host(result.snapshots_compressed)[None],
        "theta": np.array([[[gp.constant, gp.length_scale, gp.noise_level] for gp in gps]]),
        "nlml": np.asarray(capture["nlml"])[None],
        "state_est": np.stack([host(gp.state_estimate) for gp in gps])[None],
        "ddt_est": np.stack([host(gp.ddt_estimate) for gp in gps])[None],
        "covariance": np.stack([host(gp.ddt_covariance) for gp in gps])[None],
        "roots": np.stack([host(gp.sqrtW) for gp in gps])[None],
        "post_mean": host(post.means),
        "post_cov": host(post.covariances()),
        "factor": host(post.cov_factors),
        "grid_errors": np.asarray(search.grid_errors),
        "lam": float(result.regularizer),
        "refined": bool(search.refined),
        "candidates": cands,
        "draws_index": J,
        "valid": valid[None],
        "draws": host(result.draws_compressed[J])[None],
        "decompressed_index": [list(J).index(j) for j in dec],
        "decompressed": np.stack([host(result.draws[position[j]]) for j in dec]) if dec else None,
    }
