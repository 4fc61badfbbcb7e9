"""Continuous-time Galerkin reduced-order model
(counterpart of ``gp_bayesopinf_tpu/rom/model.py``).

The model object holds only static metadata; operator values are passed
explicitly, so a batch of posterior draws integrates as one call with a
leading draw axis on the operators.
"""

import dataclasses
from typing import Callable, Optional

import torch

from .operators import assemble_data_matrix, rom_rhs, rom_rhs_jacobian, total_dim
from ..ops.cahbn_screen import input_stage_times
from ..solve.ivp import dirk2_solve, rk4_solve, rk4_stage_times


@dataclasses.dataclass(frozen=True)
class GalerkinROM:
    """Polynomial-structure continuous ROM: dq/dt = Ohat @ features(q, u).

    Attributes
    ----------
    structure : operator-structure string, e.g. "cAH" or "cAHBN".
    state_dimension : r.
    input_dimension : m (0 for autonomous models).
    ivp_method : "rk4" (non-stiff) or "dirk2" (stiff; SDIRK2 with Newton).
    substeps : integrator substeps per output interval.
    """

    structure: str
    state_dimension: int
    input_dimension: int = 0
    ivp_method: str = "rk4"
    substeps: int = 8

    def __post_init__(self):
        if self.ivp_method not in ("rk4", "dirk2"):
            raise ValueError(f"unknown ivp_method '{self.ivp_method}'")

    @property
    def operator_dimension(self) -> int:
        """Number of regression unknowns d per operator row."""
        return total_dim(self.structure, self.state_dimension, self.input_dimension)

    def data_matrix(
        self, states: torch.Tensor, inputs: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(k, d) regression features from (r, k) states [+ (m, k) inputs]."""
        return assemble_data_matrix(states, inputs, self.structure)

    def predict(
        self,
        Ohat: torch.Tensor,
        q0: torch.Tensor,
        t_eval: torch.Tensor,
        input_func: Optional[Callable] = None,
    ) -> torch.Tensor:
        """Integrate the ROM for (..., r, d) operators from (r,) or (..., r)
        initial states; returns (..., r, k).

        ``input_func(times)`` maps a (n,) tensor of times to (m, n) inputs,
        or to (..., m, n) whose leading axes broadcast against the batch
        (one input history per trajectory). It is called once, on every
        time the integrator touches (``input_stage_times`` for dirk2,
        ``rk4_stage_times`` for rk4), for the whole batch.
        """
        S = self.structure
        q0 = q0.expand(Ohat.shape[:-1])
        if self.ivp_method == "rk4":
            if input_func is None:
                return rk4_solve(
                    lambda t, q: rom_rhs(Ohat, q, None, S), q0, t_eval, substeps=self.substeps
                )
            u = input_func(rk4_stage_times(t_eval, self.substeps)).movedim(-1, 0)
            return rk4_solve(
                lambda j, q: rom_rhs(Ohat, q, u[j], S), q0, t_eval,
                substeps=self.substeps, stage_index=True,
            )
        u = [None] * (3 * (t_eval.shape[0] - 1) * self.substeps)
        if input_func is not None:
            u = input_func(input_stage_times(t_eval, self.substeps)).movedim(-1, 0)
        return dirk2_solve(
            lambda j, q: rom_rhs(Ohat, q, u[j], S),
            q0, t_eval,
            jac=lambda j, q: rom_rhs_jacobian(Ohat, q, u[j], S),
            substeps=self.substeps,
        )
