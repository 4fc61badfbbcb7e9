"""Tall-matrix factorizations: TSQR thin SVD and POD by a randomized
range finder or by the Gram route (counterpart of
``gp_bayesopinf_tpu/parallel/sharded.py``).

The JAX package shards the long axis of these products over a device
mesh. These are the same functions on one device: the same signatures
without ``mesh``, ``spec`` and ``row_axis``, which are not accepted. The
forms for several cards (the long axis split over ranks, the small Gram
and R factors all-reduced by NCCL) are still to be written.

Precision: the large products run in the dtype of the input (the scaled
pipeline's snapshot matrix and sketch are float32); every small
factorization ((d, d) triangles, (l, l) Gram matrices) runs in float64
on the same device.
"""

from typing import Optional

import torch


def tall_skinny_svd(X: torch.Tensor, row_blocks: Optional[int] = None):
    """Thin SVD of tall (..., M, d) stacks by TSQR.

    The M axis is split into row blocks, each block QR-factorized (no
    Gram matrix, so the condition number is not squared), the stacked R
    factors reduced by one more QR to a (d, d) triangle per problem, whose
    SVD runs in float64. Singular values and V are accurate to ~eps of
    the input's dtype; U = X V / S, so the U columns of near-null
    directions are meaningful only as directions, and every later use
    goes through S / (S^2 + lambda^2), which suppresses them.

    ``row_blocks`` is the block count along M (default 8, capped so that
    every block keeps at least d rows, and lowered to a divisor of M).

    Returns (U (..., M, d), S (..., d) descending, V (..., d, d) columns)
    with X = U diag(S) V^T.
    """
    *batch, M, d = X.shape
    P = max(1, min(8 if row_blocks is None else row_blocks, M // max(d, 1)))
    while M % P:
        P -= 1
    Rb = torch.linalg.qr(X.reshape(*batch, P, M // P, d), mode="r").R  # (..., P, d, d)
    R2 = torch.linalg.qr(Rb.reshape(*batch, P * d, d), mode="r").R  # (..., d, d)
    _, S, Vh = torch.linalg.svd(R2.to(torch.float64), full_matrices=False)
    S, V = S.to(X.dtype), Vh.transpose(-1, -2).to(X.dtype)
    safe = torch.where(S > 0, S, torch.ones_like(S))
    U = (X @ V) / safe[..., None, :]
    return U, S, V


def randomized_pod(
    states: torch.Tensor,
    num_vectors: int,
    oversample: int = 32,
    power_iters: int = 2,
    generator: Optional[torch.Generator] = None,
    Omega: Optional[torch.Tensor] = None,
):
    """POD of (n, k) snapshots by a randomized range finder, for large k.

    Finds an l = num_vectors + oversample dimensional subspace by a
    sketched subspace iteration (Halko, Martinsson, Tropp),

        Y = orth(X Omega),  Y <- orth(X (X^T Y)) x power_iters,
        B = Y^T X,  eigh(B B^T) -> leading singular pairs of X,

    so that every large operation is a tall product and the only
    factorizations are (l, l), in float64. The (k, l) Gaussian sketch
    ``Omega`` comes from ``generator`` unless given.

    Returns (U (n, num_vectors) left singular vectors, svdvals (l,)
    leading singular values, descending, float64).
    """
    n, k = states.shape
    l = min(num_vectors + oversample, n, k)
    if l < num_vectors:
        raise ValueError("num_vectors exceeds matrix rank bound")
    dt = states.dtype
    if Omega is None:
        Omega = torch.randn((k, l), generator=generator, dtype=dt, device=states.device)

    # Eigenvalues of the Gram matrix below its own roundoff (eps of the
    # products' dtype, relative to the largest) are noise, of either sign:
    # floored there, their directions stay small in the first pass and are
    # normalized by the second. (The JAX package floors at 1e-12 whatever
    # the dtype, which in float32 lets a noise eigenvalue scale its
    # direction up by orders of magnitude and inflates the singular values.)
    floor = max(1e-12, torch.finfo(dt).eps)

    def half_orth(Y):
        w, V = torch.linalg.eigh((Y.T @ Y).to(torch.float64))
        w = torch.maximum(w, torch.clamp(w[-1], min=0.0) * floor + 1e-300)
        return Y @ ((V / torch.sqrt(w)) @ V.T).to(dt)  # right-multiply by G^{-1/2}

    def orthonormalize(Y):
        # Two passes (CholeskyQR2): after a power iteration the sketch's
        # condition number, squared in the Gram matrix, passes float32;
        # one pass leaves the small directions short of orthonormal, which
        # would inflate the recovered singular values. The second sees a
        # well-conditioned Gram matrix.
        return half_orth(half_orth(Y))

    Y = orthonormalize(states @ Omega)
    for _ in range(power_iters):
        Y = orthonormalize(states @ (states.T @ Y))

    B = Y.T @ states  # (l, k)
    w, V = torch.linalg.eigh((B @ B.T).to(torch.float64))  # ascending
    svdvals = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
    U = Y @ V.flip(1)[:, :num_vectors].to(dt)
    return U, svdvals


def sharded_gram_pod(states: torch.Tensor, num_vectors: int):
    """POD basis of (n, k) snapshots by the Gram route (method of
    snapshots): eigh of the (k, k) matrix X^T X, then U = X V / s. For a
    few snapshots of many degrees of freedom.

    Returns (U (n, num_vectors), svdvals (k,) descending).
    """
    w, V = torch.linalg.eigh(states.T @ states)
    w, V = w.flip(0), V.flip(1)
    svdvals = torch.sqrt(torch.clamp(w, min=0.0))
    safe = torch.where(svdvals > 0, svdvals, torch.ones_like(svdvals))
    U = (states @ V[:, :num_vectors]) / safe[:num_vectors]
    return U, svdvals
