"""Continuous-time Galerkin reduced-order model
(counterpart of ``gp_bayesopinf_tpu/rom/model.py``).

The model object holds only static metadata; operator values are passed
explicitly, so a batch of posterior draws integrates as one call with a
leading draw axis on the operators.

A dirk2 "cAHBN" ROM whose draws lie on the card integrates in one launch of
the fused float64 kernel (``ops/cahbn_dirk2.py``), as ``fused_dirk2``
decides from the call's tensors; every other dirk2 call, every CPU tensor
included, takes ``solve.ivp.dirk2_solve``.
"""

import dataclasses
import math
from typing import Callable, Optional

import torch

from .operators import (
    assemble_data_matrix, extract_operators, rom_rhs, rom_rhs_jacobian, total_dim,
)
from ..ops import cahbn_dirk2
from ..ops.cahbn_screen import input_stage_times
from ..solve.ivp import dirk2_solve, rk4_solve, rk4_stage_times


def fused_dirk2(structure: str, Ohat, q0, u) -> bool:
    """Whether ``GalerkinROM.predict`` integrates by SDIRK2 in the fused
    kernel: a "cAHBN" ROM whose (..., r, d) operators, initial states and
    (n, ..., nu) input table lie on one CUDA device, the operators and states
    in float64, with 1 <= r <= 8 and 1 <= nu <= 2 (the kernel's instances)
    and at least one draw. Reads only each tensor's ``device``, ``dtype``
    and ``shape``."""
    r, nu = Ohat.shape[-2], u.shape[-1]
    return (structure == "cAHBN" and Ohat.device.type == "cuda" and math.prod(Ohat.shape) > 0
            and q0.device == Ohat.device and u.device == Ohat.device
            and Ohat.dtype == torch.float64 and q0.dtype == torch.float64
            and 1 <= r <= cahbn_dirk2.MAX_STATE and 1 <= nu <= cahbn_dirk2.MAX_INPUT)


def input_problems(u: torch.Tensor, batch: torch.Size):
    """The (n, ..., nu) input table of a batch of draws as the fused kernel
    takes it: (P, n, nu) float64, the inputs of the P = prod(batch[:a])
    problems over which they vary (a the axis after the last of ``batch``
    along which u is not broadcast), and D = prod(batch[a:]) draws a
    problem, draw b of the flattened batch reading problem b // D."""
    n, nu = u.shape[0], u.shape[-1]
    axes = (1,) * (len(batch) - (u.ndim - 2)) + tuple(u.shape[1:-1])
    if torch.broadcast_shapes(batch, axes) != batch:
        raise ValueError(f"inputs of batch {axes} widen the draws' batch {tuple(batch)}")
    a = max((i + 1 for i, s in enumerate(axes) if s != 1), default=0)
    P = math.prod(batch[:a])
    table = u.reshape((n,) + axes[:a] + (nu,)).expand((n,) + tuple(batch[:a]) + (nu,))
    table = table.reshape(n, P, nu).movedim(0, 1).to(torch.float64).contiguous()
    return table, P, math.prod(batch[a:])


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

    def extract_operators(self, Ohat: torch.Tensor):
        """The named blocks {"c", "A", "H", "B", "N"} of (..., r, d)
        operators."""
        return extract_operators(Ohat, self.structure, self.state_dimension, self.input_dimension)

    def rhs(
        self,
        Ohat: torch.Tensor,
        t,
        q: torch.Tensor,
        input_func: Optional[Callable] = None,
    ) -> torch.Tensor:
        """dq/dt at time ``t`` for (..., r, d) operators and (..., r)
        states; ``input_func`` as in ``predict``, called on the one time
        ``t`` (the inputs are its (m,) or (..., m) column)."""
        u = None
        if input_func is not None:
            u = input_func(torch.atleast_1d(torch.as_tensor(t, dtype=q.dtype, device=q.device)))
            u = u[..., 0]
        return rom_rhs(Ohat, q, u, self.structure)

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

        dirk2 integrates in the fused kernel where ``fused_dirk2`` says so
        (the same states to float64 roundoff), else in ``dirk2_solve``.
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
            if fused_dirk2(S, Ohat, q0, u):
                batch, (r, d) = Ohat.shape[:-2], Ohat.shape[-2:]
                table, P, D = input_problems(u, batch)
                out = cahbn_dirk2.cahbn_dirk2_cuda(
                    Ohat.reshape(P * D, r, d).contiguous(), q0.reshape(P * D, r).contiguous(),
                    t_eval, table, substeps=self.substeps,
                )
                return out.reshape(batch + out.shape[-2:])
        return dirk2_solve(
            lambda j, q: rom_rhs(Ohat, q, u[j], S),
            q0, t_eval,
            jac=lambda j, q: rom_rhs_jacobian(Ohat, q, u[j], S),
            substeps=self.substeps,
        )
