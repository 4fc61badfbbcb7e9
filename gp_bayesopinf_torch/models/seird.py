"""SEIRD epidemic models, the truth models of the ODE pipeline
(counterpart of ``gp_bayesopinf_tpu/models/seird.py``; plotting is left
out).

Two parameterizations:

* ``SEIRD``: six parameters (N, beta, delta, gamma, alpha, rho).
* ``SEIRD2``: four parameters (p1, p2, p3, p4) = (beta / N, delta,
  (1 - alpha) gamma, alpha rho), the estimation target, linear in the
  parameters:

      dS/dt = -p1 S I
      dE/dt =  p1 S I - p2 E
      dI/dt =  p2 E - p3 I - p4 I
      dR/dt =  p3 I
      dD/dt =  p4 I

States are (..., 5) tensors and parameters (..., 4) or (..., 6) tensors;
leading axes are a batch of parameter draws, integrated as one batch. The
truncated-normal noise model keeps states in [0, 1] and exact zeros
exactly zero; it and the truth solves of the pipeline's data stage run on
the host in NumPy, as the reference runs them (``noise_host``,
``solve_host``), and on the device too (``noise``, ``solve``).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..solve.ivp import rk4_solve, rk4_solve_np


def _truncnorm_noise_np(rng: np.random.Generator, states, noise_level: float) -> np.ndarray:
    """Truncated-normal noise with support [0, 1] per state, sampled by
    CDF inversion, ``ndtri(ndtr(a) + u (ndtr(b) - ndtr(a)))`` with u
    uniform from ``rng``. The standard deviation is ``noise_level`` times
    the state; zeros stay zero."""
    from scipy.special import ndtr, ndtri

    states = np.asarray(states, np.float64)
    iszero = np.abs(states) < 5e-16
    std = np.where(iszero, 1e-3, np.abs(noise_level * states))
    a = np.minimum(0.0, -states / std)
    b = np.maximum(0.0, (1.0 - states) / std)
    cdf_a = ndtr(a)
    u = rng.uniform(size=states.shape)
    z = ndtri(cdf_a + u * (ndtr(b) - cdf_a))
    return np.where(iszero, 0.0, states + std * z)


def _rhs4(p1, p2, p3, p4, S, E, I, stack):
    dS = -p1 * S * I
    dE = -dS - p2 * E
    dR = p3 * I
    dD = p4 * I
    dI = p2 * E - dR - dD
    return stack([dS, dE, dI, dR, dD])


def _rhs6(N, beta, delta, gamma, alpha, rho, S, E, I, stack):
    dS = -beta * S * I / N
    dE = -dS - delta * E
    dD = alpha * rho * I
    dR = (1 - alpha) * gamma * I
    dI = delta * E - dR - dD
    return stack([dS, dE, dI, dR, dD])


def _stack_last(parts):
    return torch.stack(parts, dim=-1)


@dataclasses.dataclass(frozen=True)
class SEIRD2:
    """Four-parameter SEIRD reparameterization."""

    parameters: tuple = (0.00025, 0.1, 0.099, 0.005)
    substeps: int = 4

    LABELS = ("Susceptible", "Exposed", "Infected", "Recovered", "Deceased")
    num_variables = 5
    num_parameters = 4
    _rhs = staticmethod(_rhs4)

    @staticmethod
    def convert_parameters(params6) -> torch.Tensor:
        """(..., 6) (N, beta, delta, gamma, alpha, rho) -> (..., 4)
        (p1, p2, p3, p4)."""
        if not isinstance(params6, torch.Tensor):
            params6 = torch.as_tensor(np.asarray(params6, dtype=np.float64))
        N, beta, delta, gamma, alpha, rho = params6.unbind(dim=-1)
        return torch.stack([beta / N, delta, (1 - alpha) * gamma, alpha * rho], dim=-1)

    def _parameters(self, parameters, like: torch.Tensor) -> torch.Tensor:
        if parameters is None:
            parameters = self.parameters
        return torch.as_tensor(parameters, dtype=like.dtype, device=like.device)

    def derivative(self, t, state: torch.Tensor, parameters=None) -> torch.Tensor:
        """Right-hand side at (..., 5) states; ``parameters`` (..., 4)
        broadcast against the states' leading axes."""
        params = self._parameters(parameters, state)
        S, E, I = state[..., 0], state[..., 1], state[..., 2]
        return self._rhs(*params.unbind(dim=-1), S, E, I, _stack_last)

    def solve(
        self, initial_conditions: torch.Tensor, timepoints: torch.Tensor,
        parameters=None, strict: bool = False,
    ) -> torch.Tensor:
        """(..., 5, k) trajectories over ``timepoints`` by fixed-step RK4 on
        the device of ``initial_conditions``.

        ``parameters`` may carry leading axes, (N, 4) for N posterior
        draws: all N integrate as one batch from the same (5,) initial
        state. With ``strict=True`` the initial conditions must sum to
        the population (N for the six-parameter model, 1 here).
        """
        if strict:
            N = self.parameters[0] if self.num_parameters == 6 else 1.0
            total = float(initial_conditions.sum())
            if abs(total - N) > 1e-12 * max(1.0, abs(N)):
                raise ValueError(f"initial conditions sum to {total}, not {N}")
        params = self._parameters(parameters, initial_conditions)
        q0 = initial_conditions.expand(params.shape[:-1] + initial_conditions.shape[-1:])
        return rk4_solve(
            lambda t, q: self.derivative(t, q, params), q0, timepoints,
            substeps=self.substeps,
        )

    def _rhs_np(self, parameters=None):
        """NumPy right-hand side of one (5,) state, for ``solve_host``."""
        params = tuple(self.parameters if parameters is None else parameters)

        def f(t, q):
            return self._rhs(*params, q[0], q[1], q[2], np.array)

        return f

    def solve_host(self, initial_conditions, timepoints, parameters=None) -> np.ndarray:
        """Host twin of ``solve`` for one trajectory (the same RK4
        stepping in NumPy); (5, k). The pipeline's truth solves use it:
        thousands of tiny steps cost less on the host than as device
        launches."""
        return rk4_solve_np(
            self._rhs_np(parameters), initial_conditions, timepoints,
            substeps=self.substeps,
        )

    def noise(
        self,
        states: torch.Tensor,
        noise_level: float = 0.0,
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Truncated-normal noise on the device of ``states``: the model of
        ``noise_host``, drawn by the same CDF inversion in float64, so the
        uniforms ``u`` (shaped like ``states``; from ``generator`` unless
        given) give the host twin's numbers."""
        if not noise_level:
            return states
        x = states.to(torch.float64)
        if u is None:
            u = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        iszero = x.abs() < 5e-16
        std = torch.where(iszero, 1e-3, (noise_level * x).abs())
        a = torch.clamp(-x / std, max=0.0)
        b = torch.clamp((1.0 - x) / std, min=0.0)
        cdf_a = torch.special.ndtr(a)
        z = torch.special.ndtri(cdf_a + u.to(x) * (torch.special.ndtr(b) - cdf_a))
        return torch.where(iszero, 0.0, x + std * z).to(states.dtype)

    def noise_host(self, rng: np.random.Generator, states, noise_level: float = 0.0):
        """Truncated-normal noise on host states, drawn from the NumPy
        ``Generator`` ``rng``."""
        if not noise_level:
            return np.asarray(states)
        return _truncnorm_noise_np(rng, states, noise_level)

    def cah_operators(self, params: torch.Tensor) -> torch.Tensor:
        """Quadratic "cAH" operator rows equivalent to ``derivative``.

        The right-hand side is exactly quadratic in the state, so a
        parameter vector defines operator rows over the features
        ``[1, q, ckron(q)]`` (``ops.quadratic.ckron`` ordering) with

            O @ features == derivative(t, q, params)   for all q.

        This maps posterior parameter draws onto the ensemble screen's
        operator layout, so the regularization search of the ODE pipeline
        runs on the quadratic screen kernel.

        Parameters
        ----------
        params : (4,) or (1, 4) parameters, or a batch (N, 1, 4) of draws
            (the regression's one parameter row); 6 in place of 4 is
            converted by ``convert_parameters`` first.

        Returns
        -------
        (5, 21) operators ``[c | A | H]``, or (N, 5, 21) for a batch, in
        ``params``' dtype.
        """
        if params.ndim == 3:
            params = params[:, 0, :]
        else:
            params = params.reshape(-1)
        if params.shape[-1] == 6:
            params = self.convert_parameters(params)
        p1, p2, p3, p4 = params.unbind(dim=-1)
        r = self.num_variables
        d = 1 + r + r * (r + 1) // 2
        # Column layout: [0] constant; [1 + j] linear in q_j;
        # [1 + r + i (i + 1) / 2 + j] quadratic q_i q_j (i >= j).
        E_col, I_col, SI_col = 1 + 1, 1 + 2, 1 + r + 2 * 3 // 2 + 0
        rows = [0, 1, 1, 2, 2, 3, 4]
        cols = [SI_col, SI_col, E_col, E_col, I_col, I_col, I_col]
        values = torch.stack([-p1, p1, -p2, p2, -(p3 + p4), p3, p4], dim=-1)
        O = torch.zeros(params.shape[:-1] + (r, d), dtype=params.dtype, device=params.device)
        O[..., rows, cols] = values
        return O

    @staticmethod
    def data_matrix_blocks(states: torch.Tensor) -> torch.Tensor:
        """(5, k, 4) per-equation blocks of the linear-in-parameters
        regression, in the equation order (dS, dE, dI, dR, dD), from
        (5, k) states."""
        S, E, I = states[0], states[1], states[2]
        SI = S * I
        Z = torch.zeros_like(S)
        return torch.stack(
            [
                torch.stack([-SI, Z, Z, Z], dim=1),
                torch.stack([SI, -E, Z, Z], dim=1),
                torch.stack([Z, E, -I, -I], dim=1),
                torch.stack([Z, Z, I, Z], dim=1),
                torch.stack([Z, Z, Z, I], dim=1),
            ]
        )

    @classmethod
    def data_matrix(cls, states: torch.Tensor) -> torch.Tensor:
        """The blocks of ``data_matrix_blocks`` stacked to (5k, 4)."""
        return cls.data_matrix_blocks(states).flatten(0, 1)


@dataclasses.dataclass(frozen=True)
class SEIRD(SEIRD2):
    """Six-parameter SEIRD model (N, beta, delta, gamma, alpha, rho)."""

    parameters: tuple = (1000.0, 0.25, 0.1, 0.1, 0.01, 0.05)
    num_parameters = 6
    _rhs = staticmethod(_rhs6)
