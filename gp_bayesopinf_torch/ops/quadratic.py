"""Compressed quadratic features
(counterpart of ``gp_bayesopinf_tpu/ops/quadratic.py``).

A quadratic ROM term H[q ⊗ q] needs only the r(r+1)/2 unique products
q_i q_j (i >= j), ordered as opinf's compressed Kronecker product: for
each i, the products q_i q_j for j = 0..i. The same map builds the
regression data matrix and evaluates the ROM right-hand side.
"""

import numpy as np
import torch


def ckron_indices(r: int):
    """(rows, cols) int ndarrays of length r(r+1)/2 with rows >= cols,
    ordered (0,0), (1,0), (1,1), (2,0), ..."""
    rows, cols = np.tril_indices(r)
    return rows, cols


def ckron(Q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Unique quadratic monomials of the state along ``dim``.

    ``Q`` is (r,) or (r, k) with the default ``dim=0`` (columns are
    states, as in the JAX package); ``dim=-1`` takes batched (..., r)
    states. The result has r(r+1)/2 entries along ``dim``.
    """
    r = Q.shape[dim]
    rows, cols = ckron_indices(r)
    rows = torch.as_tensor(rows, device=Q.device)
    cols = torch.as_tensor(cols, device=Q.device)
    return Q.index_select(dim, rows) * Q.index_select(dim, cols)
