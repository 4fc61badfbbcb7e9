"""Polynomial operator structures of continuous reduced-order models
(counterpart of ``gp_bayesopinf_tpu/rom/operators.py``, autonomous "cAH"
structures; the input terms B and N come with the heat-multi slice).

    dq/dt = c + A q + H ckron(q)

The packed operator matrix Ohat is (r, d) with column blocks in structure
order; ``assemble_data_matrix`` builds the (k, d) regression features in
the same order, so the regression unknowns are exactly Ohat's rows.
"""

from typing import Dict

import torch

from ..ops.quadratic import ckron

_VALID = set("cAH")


def operator_dims(structure: str, r: int) -> Dict[str, int]:
    """Column-block widths per operator, in structure order."""
    if not set(structure) <= _VALID:
        raise ValueError(
            f"unsupported operators in structure '{structure}' (only c, A, H)"
        )
    widths = {"c": 1, "A": r, "H": r * (r + 1) // 2}
    return {ch: widths[ch] for ch in structure}


def total_dim(structure: str, r: int) -> int:
    return sum(operator_dims(structure, r).values())


def operator_splits(structure: str, r: int):
    """(name, start, stop) column spans of each operator block."""
    spans, pos = [], 0
    for ch, w in operator_dims(structure, r).items():
        spans.append((ch, pos, pos + w))
        pos += w
    return spans


def extract_operators(Ohat: torch.Tensor, structure: str, r: int):
    """Unpack (..., r, d) operators into named blocks."""
    ops = {}
    for ch, a, b in operator_splits(structure, r):
        block = Ohat[..., a:b]
        ops[ch] = block[..., 0] if ch == "c" else block
    return ops


def _features(q: torch.Tensor, structure: str) -> torch.Tensor:
    """(..., d) features of (..., r) states."""
    feats = []
    for ch in structure:
        if ch == "c":
            feats.append(torch.ones_like(q[..., :1]))
        elif ch == "A":
            feats.append(q)
        else:
            feats.append(ckron(q, dim=-1))
    return torch.cat(feats, dim=-1)


def assemble_data_matrix(states: torch.Tensor, structure: str) -> torch.Tensor:
    """(k, d) regression data matrix from (r, k) state snapshots."""
    operator_dims(structure, states.shape[0])  # validates the structure
    return _features(states.T, structure)


def rom_rhs(Ohat: torch.Tensor, q: torch.Tensor, structure: str) -> torch.Tensor:
    """dq/dt = Ohat @ features(q) for (..., r, d) operators and (..., r)
    states (leading axes broadcast)."""
    return torch.einsum("...rd,...d->...r", Ohat, _features(q, structure))
