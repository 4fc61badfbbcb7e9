"""The shape of a user-given Tikhonov regularizer (counterpart of
``gp_bayesopinf_tpu/pipeline/scaled.py::_resolve_gamma``)."""

from typing import Tuple

import torch


def resolve_gamma(
    tikhonov_gamma, Dt_flat: torch.Tensor, r: int, d: int, W: int
) -> Tuple[str, torch.Tensor]:
    """``tikhonov_gamma`` as the regularizer of every row problem:
    ``("diag", (W r, d))`` or ``("matrix", (W r, d, d))``, on the device
    and in the dtype of the weighted data matrices ``Dt_flat`` (W r, mw, d).

    Accepted:

    * ``"colnorm"``: a diagonal per row from the column norms of its
      weighted data matrix (scaled Tikhonov: shrinkage in proportion to
      each feature's leverage);
    * (d,) one diagonal for all rows, (r, d) a diagonal per mode;
    * (d, d) one matrix for all rows, (r, d, d) a matrix per mode. A
      square (r, r) input with r = d is taken as a (d, d) matrix.
    """
    if isinstance(tikhonov_gamma, str):
        if tikhonov_gamma != "colnorm":
            raise ValueError(f"unknown tikhonov_gamma preset '{tikhonov_gamma}'")
        return "diag", torch.linalg.norm(Dt_flat, dim=1)
    G = torch.as_tensor(tikhonov_gamma, dtype=Dt_flat.dtype, device=Dt_flat.device)
    shape = tuple(G.shape)
    if G.ndim == 1:
        if shape != (d,):
            raise ValueError(f"tikhonov_gamma shape {shape} != ({d},)")
        return "diag", G.expand(W * r, d)
    if shape == (r, d) and r != d:
        return "diag", G.repeat(W, 1)
    if shape == (d, d):
        return "matrix", G.expand(W * r, d, d)
    if shape == (r, d, d):
        return "matrix", G.repeat(W, 1, 1)
    raise ValueError(
        f"tikhonov_gamma shape {shape} is none of ({d},), ({r}, {d}), "
        f"({d}, {d}), ({r}, {d}, {d})"
    )
