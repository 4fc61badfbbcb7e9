"""Continuous-time Galerkin reduced-order model
(counterpart of ``gp_bayesopinf_tpu/rom/model.py``, explicit RK4 path).

The model object holds only static metadata; operator values are passed
explicitly, so a batch of posterior draws integrates as one call with a
leading draw axis on the operators.
"""

import dataclasses

import torch

from .operators import assemble_data_matrix, rom_rhs, total_dim
from ..solve.ivp import rk4_solve


@dataclasses.dataclass(frozen=True)
class GalerkinROM:
    """Polynomial-structure continuous ROM: dq/dt = Ohat @ features(q).

    Attributes
    ----------
    structure : operator-structure string, "cAH" or a subset of it.
    state_dimension : r.
    ivp_method : "rk4" (the only integrator of this slice).
    substeps : integrator substeps per output interval.
    """

    structure: str
    state_dimension: int
    ivp_method: str = "rk4"
    substeps: int = 8

    def __post_init__(self):
        if self.ivp_method != "rk4":
            raise ValueError(f"unsupported ivp_method '{self.ivp_method}'")

    @property
    def operator_dimension(self) -> int:
        """Number of regression unknowns d per operator row."""
        return total_dim(self.structure, self.state_dimension)

    def data_matrix(self, states: torch.Tensor) -> torch.Tensor:
        """(k, d) regression features from (r, k) states."""
        return assemble_data_matrix(states, self.structure)

    def predict(
        self, Ohat: torch.Tensor, q0: torch.Tensor, t_eval: torch.Tensor
    ) -> torch.Tensor:
        """Integrate the ROM for (..., r, d) operators from (r,) or (..., r)
        initial states; returns (..., r, k)."""
        q0 = q0.expand(Ohat.shape[:-1])
        return rk4_solve(
            lambda t, q: rom_rhs(Ohat, q, self.structure),
            q0, t_eval, substeps=self.substeps,
        )
