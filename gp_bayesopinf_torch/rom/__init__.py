"""Reduced-order models (counterpart of ``gp_bayesopinf_tpu/rom/``)."""

from .basis import EulerScaledBasis, PODBasis, QuadraticLiftedBasis, shift
from .model import GalerkinROM
from .operators import (
    assemble_data_matrix,
    extract_operators,
    operator_dims,
    rom_rhs,
    rom_rhs_jacobian,
    total_dim,
)

__all__ = [
    "EulerScaledBasis", "PODBasis", "QuadraticLiftedBasis", "shift",
    "GalerkinROM", "assemble_data_matrix", "extract_operators",
    "operator_dims", "rom_rhs", "rom_rhs_jacobian", "total_dim",
]
