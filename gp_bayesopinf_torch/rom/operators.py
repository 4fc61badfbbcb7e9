"""Polynomial operator structures of continuous reduced-order models
(counterpart of ``gp_bayesopinf_tpu/rom/operators.py``).

    dq/dt = c + A q + H ckron(q) + B u + N (u ⊗ q)

The packed operator matrix Ohat is (r, d) with column blocks in structure
order; ``assemble_data_matrix`` builds the (k, d) regression features in
the same order, so the regression unknowns are exactly Ohat's rows.
``rom_rhs`` and ``rom_rhs_jacobian`` take leading batch axes (posterior
draws, trajectories) on the operators, states and inputs, which
broadcast against each other.
"""

from typing import Dict, Optional

import torch

from ..ops.quadratic import ckron, ckron_jacobian_pattern, state_input_kron

_VALID = set("cAHBN")


def operator_dims(structure: str, r: int, m: int = 0) -> Dict[str, int]:
    """Column-block widths per operator, in structure order."""
    if not set(structure) <= _VALID:
        raise ValueError(f"unknown operators in structure '{structure}'")
    widths = {"c": 1, "A": r, "H": r * (r + 1) // 2, "B": m, "N": r * m}
    return {ch: widths[ch] for ch in structure}


def total_dim(structure: str, r: int, m: int = 0) -> int:
    return sum(operator_dims(structure, r, m).values())


def operator_splits(structure: str, r: int, m: int = 0):
    """(name, start, stop) column spans of each operator block."""
    spans, pos = [], 0
    for ch, w in operator_dims(structure, r, m).items():
        spans.append((ch, pos, pos + w))
        pos += w
    return spans


def extract_operators(Ohat: torch.Tensor, structure: str, r: int, m: int = 0):
    """Unpack (..., r, d) operators into named blocks."""
    ops = {}
    for ch, a, b in operator_splits(structure, r, m):
        block = Ohat[..., a:b]
        ops[ch] = block[..., 0] if ch == "c" else block
    return ops


def _features(
    q: torch.Tensor, u: Optional[torch.Tensor], structure: str
) -> torch.Tensor:
    """(..., d) features of (..., r) states and (..., m) inputs."""
    if set("BN") & set(structure):
        if u is None:
            raise ValueError(f"structure '{structure}' needs inputs u")
        batch = torch.broadcast_shapes(q.shape[:-1], u.shape[:-1])
        q = q.expand(batch + q.shape[-1:])
        u = u.expand(batch + u.shape[-1:])
    feats = []
    for ch in structure:
        if ch == "c":
            feats.append(torch.ones_like(q[..., :1]))
        elif ch == "A":
            feats.append(q)
        elif ch == "H":
            feats.append(ckron(q, dim=-1))
        elif ch == "B":
            feats.append(u)
        else:
            feats.append(state_input_kron(u, q, dim=-1))
    return torch.cat(feats, dim=-1)


def assemble_data_matrix(
    states: torch.Tensor, inputs: Optional[torch.Tensor], structure: str
) -> torch.Tensor:
    """(k, d) regression data matrix from (r, k) state snapshots and (m, k)
    input snapshots (None for an autonomous structure)."""
    m = 0 if inputs is None else inputs.shape[0]
    operator_dims(structure, states.shape[0], m)  # validates the structure
    return _features(states.T, None if inputs is None else inputs.T, structure)


def rom_rhs(
    Ohat: torch.Tensor,
    q: torch.Tensor,
    u: Optional[torch.Tensor],
    structure: str,
) -> torch.Tensor:
    """dq/dt = Ohat @ features(q, u) for (..., r, d) operators, (..., r)
    states and (..., m) inputs (None for an autonomous structure)."""
    return torch.einsum("...rd,...d->...r", Ohat, _features(q, u, structure))


def rom_rhs_jacobian(
    Ohat: torch.Tensor,
    q: torch.Tensor,
    u: Optional[torch.Tensor],
    structure: str,
) -> torch.Tensor:
    """Analytic state Jacobian of ``rom_rhs``, (..., r, r):

        d rhs_i / dq_j = A[i, j] + sum_z H[i, z] d ckron(q)_z / dq_j
                         + sum_a N[i, a r + j] u_a.
    """
    r = q.shape[-1]
    m = 0 if u is None else u.shape[-1]
    ops = extract_operators(Ohat, structure, r, m)
    batch = torch.broadcast_shapes(
        Ohat.shape[:-2], q.shape[:-1], () if u is None else u.shape[:-1]
    )
    J = torch.zeros(batch + (r, r), dtype=Ohat.dtype, device=Ohat.device)
    if "A" in ops:
        J = J + ops["A"]
    if "H" in ops:
        T = ckron_jacobian_pattern(r, q.dtype, q.device)
        dquad = torch.einsum("zjc,...c->...zj", T, q)  # d ckron(q) / dq
        J = J + torch.einsum("...iz,...zj->...ij", ops["H"], dquad)
    if "N" in ops:
        N = ops["N"].unflatten(-1, (m, r))  # (..., r, m, r): (i, a, j)
        J = J + torch.einsum("...iaj,...a->...ij", N, u)
    return J
