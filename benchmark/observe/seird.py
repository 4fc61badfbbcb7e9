"""What the check reads of one SEIRD experiment (``run_seird``'s result
and the harness's captures), as NumPy arrays on the host. The method has
no POD: the snapshots the GPs are fit to stand as ``compressed``, and the
ensemble from the unseen initial state in the ``newparam`` slots."""

import numpy as np

from .weights import weights

#: Where the check's tests plant faults: the class that draws the
#: posterior ensembles, the integrator of their draws, and the plain
#: version of the screen (in the module of the config's screen function).
POSTERIOR = "gp_bayesopinf_torch.bayes.posterior:BayesianODE"
INTEGRATOR = "gp_bayesopinf_torch.models.seird:rk4_solve"
PLAIN_SCREEN = "quadratic_ensemble_screen_torch"


def observe(result, capture, pick):
    """The observations of one experiment; ``pick`` as in
    ``observe.euler``."""
    host = lambda x: x.detach().cpu().numpy()
    gps = result.gps
    post = result.bayesian_model.posterior
    search = capture["search"]
    valid = host(result.valid)
    J, cands, _ = pick(len(valid), np.asarray(search.grid_errors))
    snapshots = np.asarray(result.snapshots)[None]
    return {
        **weights([gps]),
        "t_sampled": np.asarray(result.sample_times),
        "truth": np.asarray(result.true_states)[None],
        "snapshots": snapshots,
        "compressed": snapshots,
        "theta": np.array([[[gp.constant, gp.length_scale, gp.noise_level] for gp in gps]]),
        "nlml": np.asarray(capture["nlml"])[None],
        "state_est": np.stack([host(gp.state_estimate) for gp in gps])[None],
        "ddt_est": np.stack([host(gp.ddt_estimate) for gp in gps])[None],
        "post_mean": host(post.means),
        "post_cov": host(post.covariances()),
        "factor": host(post.cov_factors),
        "grid_errors": np.asarray(search.grid_errors),
        "lam": float(result.regularizer),
        "refined": bool(search.refined),
        "candidates": cands,
        "draws_index": J,
        "valid": valid[None],
        "draws": host(result.draws[J])[None],
        "newparam_draws": host(result.newic_draws[J]),
        "newparam_valid": host(result.newic_valid),
        "newparam_truth": np.asarray(result.newic_true_states),
    }
