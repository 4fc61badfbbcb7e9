"""Compressed quadratic features
(counterpart of ``gp_bayesopinf_tpu/ops/quadratic.py``).

A quadratic ROM term H[q ⊗ q] needs only the r(r+1)/2 unique products
q_i q_j (i >= j), ordered as opinf's compressed Kronecker product: for
each i, the products q_i q_j for j = 0..i. The same map builds the
regression data matrix and evaluates the ROM right-hand side; so does
the bilinear state-input map ``state_input_kron`` of the N operator.
"""

import functools

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
    rows, cols = _ckron_index_tensors(Q.shape[dim], Q.device)
    return Q.index_select(dim, rows) * Q.index_select(dim, cols)


@functools.lru_cache(maxsize=None)
def _ckron_index_tensors(r: int, device: torch.device):
    """``ckron_indices(r)`` as tensors on ``device``, made once: a fresh
    host-to-device copy in every right-hand side would synchronize the
    stream each time."""
    return tuple(torch.as_tensor(i, device=device) for i in ckron_indices(r))


def state_input_kron(U: torch.Tensor, Q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Bilinear state-input features u ⊗ q, input-major: entry a*r + b is
    u_a * q_b.

    With the default ``dim=0``, ``U`` is (m,) or (m, k) and ``Q`` is (r,)
    or (r, k), as in the JAX package; the result is (m r,) or (m r, k).
    ``dim=-1`` takes batched (..., m) inputs and (..., r) states whose
    leading axes broadcast; the result is (..., m r).
    """
    if dim == 0:
        m, r = U.shape[0], Q.shape[0]
        return (U[:, None] * Q[None, :]).reshape((m * r,) + Q.shape[1:])
    if dim != -1:
        raise ValueError(f"dim must be 0 or -1, got {dim}")
    prod = U[..., :, None] * Q[..., None, :]
    return prod.reshape(prod.shape[:-2] + (U.shape[-1] * Q.shape[-1],))


@functools.lru_cache(maxsize=None)
def ckron_jacobian_pattern(r: int, dtype: torch.dtype, device: torch.device):
    """(P, r, r) tensor T with d ckron(q)_z / dq_j = sum_c T[z, j, c] q_c:
    the feature q_a q_b differentiates to q_b at j = a and to q_a at j = b.
    Made once per device, as ``ckron``'s indices are."""
    rows, cols = ckron_indices(r)
    T = torch.zeros((rows.size, r, r), dtype=dtype)
    for z, (a, b) in enumerate(zip(rows, cols)):
        T[z, a, b] += 1.0
        T[z, b, a] += 1.0
    return T.to(device)
