"""Final ensembles of the production-scale pipeline (counterpart of
``gp_bayesopinf_tpu/pipeline/scaled.py``: ``final_ensemble``,
``chain_mean``, ``chain_draws`` and the error bookkeeping).

With W > 1 windows three schemes carry the state across a window
boundary; all three errors are recorded, and the caller's choice sets
``train_error`` and ``ensemble_mean``:

* anchor: window w restarts from the GP state estimate at its left
  boundary (``final_ensemble``); within the training span those states
  are observable from the data;
* mean: window w starts from window w-1's ensemble-mean end state;
* draws: every posterior draw goes on from its own end state, and a draw
  that left the envelope inside a window restarts the next one from the
  stable draws' mean end state.

With local window bases each window has its own envelope, and a state
crossing a boundary goes into the next window's coordinates by the exact
transfer q' = T_w q + b_w (``search.transfer_maps``); with one basis the
transfer is the identity.

With a mesh each rank integrates its block of the draws over "draw"; the
stable means and shares come from sums and counts over all ranks.
"""

from typing import Tuple

import torch

from ...parallel.mesh import all_reduce_sum, shard_leading_axis
from ...solve.ivp import stability_mask
from .search import WindowProblem, rollout


def _stable_mean(sols: torch.Tensor, ok: torch.Tensor, mesh=None):
    """Mean over the leading draw axis of the draws flagged ``ok``, and
    their share; with a mesh, over every rank's draws."""
    lift = (...,) + (None,) * (sols.ndim - ok.ndim)
    total = torch.where(ok[lift], sols, 0.0).sum(dim=0)
    counts = torch.stack([ok.sum(dim=0), torch.full_like(ok[0], ok.shape[0], dtype=torch.long)])
    if mesh is not None:
        total, counts = all_reduce_sum(total, mesh, "draw"), all_reduce_sum(counts, mesh, "draw")
    share = counts[0].sum().to(sols.dtype) / counts[1].sum()
    return total / torch.clamp(counts[0], min=1)[lift], share


def final_ensemble(problem: WindowProblem, params, xi, mesh=None) -> Tuple[torch.Tensor, float]:
    """The anchored ensemble: every window from its GP-estimate initial
    state. ``xi`` (ndraws, W r, d), all the draws (with a mesh each rank
    integrates its block). Returns the (W, r, mw) means of each window's
    stable draws and the share of stable (draw, window) pairs."""
    if mesh is not None:
        xi = shard_leading_axis(xi, mesh, "draw")
    sols = problem.integrate(problem.sample(params, xi))  # (n, W, r, mw)
    ok = stability_mask(sols, problem.shift, problem.limits)  # (n, W)
    mean, share = _stable_mean(sols, ok, mesh)
    return mean, float(share)


def chain_mean(problem: WindowProblem, ohat: torch.Tensor, mesh=None) -> torch.Tensor:
    """Ensemble-mean handoff over (n, W, r, d) draws (with a mesh, this
    rank's block): (W, r, mw) means."""
    q = problem.states_w[0, :, 0]
    means = []
    for w in range(problem.tw.shape[0]):
        sols = rollout(problem.rom, ohat[:, w : w + 1], q[None], problem.tw[w : w + 1])[:, 0]
        ok = stability_mask(sols, *problem.envelope(w))  # (n,)
        means.append(_stable_mean(sols, ok, mesh)[0])
        q = problem.hand_over(w, means[-1][:, -1])
    return torch.stack(means)


def chain_draws(problem: WindowProblem, ohat: torch.Tensor,
                mesh=None) -> Tuple[torch.Tensor, float]:
    """Draw-wise propagation with boundary rescue over (n, W, r, d) draws
    (with a mesh, this rank's block): ((W, r, mw) means of each window's
    stable draws, mean stable share).

    Requiring stability over the whole span would keep no draw over many
    windows (each draw's own operators compound the drift of its initial
    state), so the means are gated window by window."""
    n = ohat.shape[0]
    qs = problem.states_w[0, :, 0].expand(n, -1)
    means, fracs = [], []
    for w in range(problem.tw.shape[0]):
        sols = rollout(problem.rom, ohat[:, w : w + 1], qs[:, None], problem.tw[w : w + 1])[:, 0]
        ok = stability_mask(sols, *problem.envelope(w))  # (n,)
        mean, share = _stable_mean(sols, ok, mesh)
        qs = problem.hand_over(w, torch.where(ok[:, None], sols[:, :, -1], mean[None, :, -1]))
        means.append(mean)
        fracs.append(share)
    return torch.stack(means), float(torch.stack(fracs).mean())


def full_span(means: torch.Tensor) -> torch.Tensor:
    """(W, r, mw) window means as one (r, W mw) trajectory."""
    W, r, mw = means.shape
    return means.transpose(0, 1).reshape(r, W * mw)


def span_error(means: torch.Tensor, problem: WindowProblem) -> float:
    """Relative error of the window means against the GP state estimates
    over the whole span."""
    target = full_span(problem.states_w)
    return float(torch.linalg.norm(full_span(means) - target) / torch.linalg.norm(target))
