"""Reduced-order models (counterpart of ``gp_bayesopinf_tpu/rom/``)."""

from .basis import EulerScaledBasis, PODBasis, shift
from .model import GalerkinROM
from .operators import (
    assemble_data_matrix,
    extract_operators,
    operator_dims,
    rom_rhs,
    total_dim,
)

__all__ = [
    "EulerScaledBasis", "PODBasis", "shift", "GalerkinROM",
    "assemble_data_matrix", "extract_operators", "operator_dims",
    "rom_rhs", "total_dim",
]
