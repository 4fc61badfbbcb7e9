"""Tall-matrix factorizations: TSQR thin SVD and POD by a randomized
range finder or by the Gram route (counterpart of
``gp_bayesopinf_tpu/parallel/sharded.py``).

With ``mesh=None`` each runs on one device. With a mesh
(``parallel.mesh.make_mesh``) every rank passes the same global array,
works on its block of the long axis, sums or gathers the small factors
((d, d) triangles, (l, l) and (l, k) products), gathers a POD's basis, and
returns the same global results as the other ranks: the JAX package's sharded forms, with its
``mesh``, ``spec`` and ``row_axis``. Their sums run in another order than
on one device, so a mesh changes results at roundoff.

Precision: the large products run in the dtype of the input (the scaled
pipeline's snapshot matrix and sketch are float32); every small
factorization ((d, d) triangles, (l, l) Gram matrices) runs in float64
on the same device.
"""

from typing import Optional

import torch

from .mesh import all_reduce_sum, axis_size, gather_leading_axis, shard_leading_axis


def _on_dim(fn, x, dim, *args):
    """``fn`` of ``parallel.mesh`` applied along dimension ``dim``."""
    return fn(x.movedim(dim, 0), *args).movedim(0, dim)


def _block_r(X: torch.Tensor, P: int) -> torch.Tensor:
    """The R factors of P row blocks of (..., M, d), stacked: (..., P k, d)
    with k = min(M / P, d)."""
    *batch, M, d = X.shape
    Rb = torch.linalg.qr(X.reshape(*batch, P, M // P, d), mode="r").R  # (..., P, k, d)
    return Rb.reshape(*batch, -1, d)


def _blocks(M: int, d: int, P: int) -> int:
    """P capped so that every block keeps at least d rows, lowered to a
    divisor of M."""
    P = max(1, min(P, M // max(d, 1)))
    while M % P:
        P -= 1
    return P


def tall_skinny_svd(
    X: torch.Tensor,
    mesh=None,
    spec: Optional[tuple] = None,
    row_blocks: Optional[int] = None,
):
    """Thin SVD of tall (..., M, d) stacks by TSQR.

    The M axis is split into row blocks, each block QR-factorized (no
    Gram matrix, so the condition number is not squared), the stacked R
    factors reduced by one more QR to a (d, d) triangle per problem, whose
    SVD runs in float64. Singular values and V are accurate to ~eps of
    the input's dtype; U = X V / S, so the U columns of near-null
    directions are meaningful only as directions, and every later use
    goes through S / (S^2 + lambda^2), which suppresses them.

    ``mesh`` and ``spec``: ``spec`` names a mesh axis (or None) for each
    dimension of X, None for the last, e.g. ``("mode", "draw", None)`` to
    split the problems over "mode" and the M rows over "draw". Each rank
    QRs its own row blocks of its own problems; the R factors are gathered
    over the row axis, the second QR and the SVD run on every rank of it,
    and S and V are gathered over the problem axes. U = X V / S is then
    formed from the global X on every rank, without communication.

    ``row_blocks`` is the block count along M (default 8 on one device,
    the row axis's extent on a mesh, so that each rank QRs its rows as one
    block; capped so that every block keeps at least d rows, and lowered
    to a divisor of the rows).

    Returns (U (..., M, d), S (..., d) descending, V (..., d, d) columns)
    with X = U diag(S) V^T.
    """
    *batch, M, d = X.shape
    if mesh is None:
        P = _blocks(M, d, 8 if row_blocks is None else row_blocks)
        Rstack = _block_r(X, P)
    else:
        if spec is None or len(spec) != X.ndim or spec[-1] is not None:
            raise ValueError("spec names a mesh axis (or None) for each dimension of X, "
                             f"None for the last; got {spec} for shape {tuple(X.shape)}")
        Xl = X
        for dim, ax in enumerate(spec[:-1]):
            if ax is not None:
                Xl = _on_dim(shard_leading_axis, Xl, dim, mesh, ax)
        row_ax = spec[-2]
        ranks = 1 if row_ax is None else axis_size(mesh, row_ax)
        P = _blocks(M, d, ranks if row_blocks is None else row_blocks)
        Rstack = _block_r(Xl, _blocks(Xl.shape[-2], d, max(1, P // ranks)))
        if row_ax is not None:
            Rstack = _on_dim(gather_leading_axis, Rstack, -2, mesh, row_ax)
    R2 = torch.linalg.qr(Rstack, mode="r").R  # (..., d, d)
    _, S, Vh = torch.linalg.svd(R2.to(torch.float64), full_matrices=False)
    S, V = S.to(X.dtype), Vh.transpose(-1, -2).to(X.dtype)
    if mesh is not None:
        for dim, ax in enumerate(spec[:-2]):
            if ax is not None:
                S = _on_dim(gather_leading_axis, S, dim, mesh, ax)
                V = _on_dim(gather_leading_axis, V, dim, mesh, ax)
    safe = torch.where(S > 0, S, torch.ones_like(S))
    U = (X @ V) / safe[..., None, :]
    return U, S, V


def randomized_pod(
    states: torch.Tensor,
    num_vectors: int,
    mesh=None,
    row_axis="seq",
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

    With a ``mesh`` the n rows are split over ``row_axis`` (a name or a
    tuple of names): each rank's tall products run on its rows, the (l,
    l) Gram matrices, X^T Y and B are summed over the ranks, and U is
    gathered. Every rank draws the sketch in its global shape from its own
    copy of the same generator, so that several ranks compute one rank's
    numbers up to the order of those sums.

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
    if mesh is None:
        X, total = states, (lambda A: A)
    else:
        X = shard_leading_axis(states, mesh, row_axis)
        total = lambda A: all_reduce_sum(A, mesh, row_axis)  # noqa: E731

    # Eigenvalues of the Gram matrix below its own roundoff (eps of the
    # products' dtype, relative to the largest) are noise, of either sign:
    # floored there, their directions stay small in the first pass and are
    # normalized by the second. (The JAX package floors at 1e-12 whatever
    # the dtype, which in float32 lets a noise eigenvalue scale its
    # direction up by orders of magnitude and inflates the singular values.)
    floor = max(1e-12, torch.finfo(dt).eps)

    def half_orth(Y):
        w, V = torch.linalg.eigh(total(Y.T @ Y).to(torch.float64))
        w = torch.maximum(w, torch.clamp(w[-1], min=0.0) * floor + 1e-300)
        return Y @ ((V / torch.sqrt(w)) @ V.T).to(dt)  # right-multiply by G^{-1/2}

    def orthonormalize(Y):
        # Two passes (CholeskyQR2): after a power iteration the sketch's
        # condition number, squared in the Gram matrix, passes float32;
        # one pass leaves the small directions short of orthonormal, which
        # would inflate the recovered singular values. The second sees a
        # well-conditioned Gram matrix.
        return half_orth(half_orth(Y))

    Y = orthonormalize(X @ Omega)
    for _ in range(power_iters):
        Y = orthonormalize(X @ total(X.T @ Y))

    B = total(Y.T @ X)  # (l, k)
    w, V = torch.linalg.eigh((B @ B.T).to(torch.float64))  # ascending
    svdvals = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
    U = Y @ V.flip(1)[:, :num_vectors].to(dt)
    return (U if mesh is None else gather_leading_axis(U, mesh, row_axis)), svdvals


def sharded_gram_pod(states: torch.Tensor, num_vectors: int, mesh=None, row_axis="seq"):
    """POD basis of (n, k) snapshots by the Gram route (method of
    snapshots): eigh of the (k, k) matrix X^T X, then U = X V / s. For a
    few snapshots of many degrees of freedom. With a ``mesh`` the n rows
    are split over ``row_axis``: X^T X is summed over the ranks and U
    gathered.

    Returns (U (n, num_vectors), svdvals (k,) descending).
    """
    X = states if mesh is None else shard_leading_axis(states, mesh, row_axis)
    G = X.T @ X
    w, V = torch.linalg.eigh(G if mesh is None else all_reduce_sum(G, mesh, row_axis))
    w, V = w.flip(0), V.flip(1)
    svdvals = torch.sqrt(torch.clamp(w, min=0.0))
    safe = torch.where(svdvals > 0, svdvals, torch.ones_like(svdvals))
    U = (X @ V[:, :num_vectors]) / safe[:num_vectors]
    return (U if mesh is None else gather_leading_axis(U, mesh, row_axis)), svdvals
