"""Forced 1-D heat equation with Dirichlet boundary conditions, and its
cubic-reaction variant: the truth models of the multi-trajectory
pipeline (counterpart of ``gp_bayesopinf_tpu/models/heat.py``; plotting
and animation are left out).

    q_t = kappa q_xx [- q^3] + f(x, t),    q(0, t) = left_bc, q(L, t) = right_bc
    f(x, t) = a sin(2 pi t) / (1 + 100 (x - 1/4)^2)
            + b sin(4 pi t) / (1 + 100 (x - 3/4)^2)

Second-order finite differences in space; the stiff system is integrated
on the host with the SDIRK2 of ``solve.ivp.dirk2_solve_np``, whose Newton
systems are tridiagonal and go to LAPACK ``dgtsv``. The JAX package runs
these truth solves on the host too, on every backend; PyTorch has no
tridiagonal solver, and a device solve is later work (ROADMAP).
"""

import dataclasses
import math
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ..solve.ivp import dirk2_solve_np


@dataclasses.dataclass(frozen=True)
class HeatBimodal:
    spatial_domain: np.ndarray  # (N+2,) including the boundary points
    left_bc: float = 0.0
    right_bc: float = 1.0
    diffusion: float = 1e-2
    a: float = 1.0
    b: float = 1.0
    substeps: int = 2

    num_variables = 1

    @property
    def x(self) -> np.ndarray:
        """Interior grid points."""
        return np.asarray(self.spatial_domain)[1:-1]

    @property
    def N(self) -> int:
        return len(self.spatial_domain) - 2

    @property
    def dx(self) -> float:
        sd = np.asarray(self.spatial_domain)
        return float(sd[1] - sd[0])

    @cached_property
    def _ops(self):
        """(dx2inv, c, B): the stencil coefficient, the boundary constant
        vector and the (N, 2) forcing input matrix."""
        dx2inv = self.diffusion / self.dx**2
        c = np.zeros(self.N)
        c[0] = self.left_bc * dx2inv
        c[-1] = self.right_bc * dx2inv
        B = np.column_stack(
            [
                1.0 / (1.0 + 100.0 * (self.x - 0.25) ** 2),
                1.0 / (1.0 + 100.0 * (self.x - 0.75) ** 2),
            ]
        )
        return dx2inv, c, B

    # -- forcing -----------------------------------------------------------------
    @staticmethod
    def oscillators(t: torch.Tensor, a, b) -> torch.Tensor:
        """The two forcing inputs (a sin(2 pi t), b sin(4 pi t)) stacked on a
        new leading axis: (2,) + the broadcast shape of t, a and b."""
        return torch.stack(
            [a * torch.sin(2.0 * math.pi * t), b * torch.sin(4.0 * math.pi * t)]
        )

    # -- initial conditions ------------------------------------------------------
    @staticmethod
    def initial_conditions(x, alpha: float, beta: float) -> np.ndarray:
        """Closed-form initial condition on the full grid ``x``, meeting
        the boundary values alpha and beta."""
        x = np.asarray(x, np.float64)
        L = x[-1] - x[0]
        h1 = 6.0 * np.exp(-x) * x * (L - x) ** 3
        h2 = 10.0 * np.exp(x) * x * (L - x) * np.sin(x / (L * 6.0))
        nonhom = alpha + (beta - alpha) / L * (x - x[0])
        return h1 - h2 + nonhom

    # -- dynamics (host NumPy) ---------------------------------------------------
    def derivative(self, t: float, q: np.ndarray) -> np.ndarray:
        """Right-hand side on the interior degrees of freedom."""
        dx2inv, c, B = self._ops
        lap = -2.0 * q
        lap[:-1] += q[1:]
        lap[1:] += q[:-1]
        osc = np.array([self.a * np.sin(2.0 * np.pi * t), self.b * np.sin(4.0 * np.pi * t)])
        return c + dx2inv * lap + B @ osc + self.reaction(q)

    @cached_property
    def _bands(self):
        """Constant sub- and super-diagonals and base diagonal of the
        Jacobian; only the reaction term of the diagonal depends on q."""
        dx2inv = self._ops[0]
        dl = np.full(self.N, dx2inv)
        dl[0] = 0.0
        du = np.full(self.N, dx2inv)
        du[-1] = 0.0
        return dl, np.full(self.N, -2.0 * dx2inv), du

    def jacobian_tridiag(self, t: float, q: np.ndarray):
        """(dl, diag, du) of the state Jacobian, gtsv layout."""
        dl, d_base, du = self._bands
        return dl, d_base + self.reaction_jac_diag(q), du

    @staticmethod
    def reaction(Q):
        """Reaction term of the right-hand side (none for the linear model)."""
        return 0.0

    @staticmethod
    def reaction_jac_diag(Q):
        return 0.0

    def _interior(self, initial_conditions) -> np.ndarray:
        q0 = np.asarray(initial_conditions, np.float64)
        if q0.shape[0] == self.N + 2:
            bl, br = float(q0[0]), float(q0[-1])
            if abs(bl - self.left_bc) > 1e-8 or abs(br - self.right_bc) > 1e-8:
                raise ValueError(
                    f"initial condition boundary values ({bl:.6g}, {br:.6g}) do "
                    "not match the Dirichlet boundary conditions "
                    f"({self.left_bc:.6g}, {self.right_bc:.6g})"
                )
            return q0[1:-1]
        if q0.shape[0] != self.N:
            raise ValueError(
                f"initial conditions must have {self.N} (interior) or "
                f"{self.N + 2} (full-grid) entries, got {q0.shape[0]}"
            )
        return q0

    def solve_host(self, initial_conditions, timepoints) -> np.ndarray:
        """Integrate on the host; returns (N+2, k) float64 states including
        the boundary rows. The initial condition may include the boundary
        points, which must then match the Dirichlet values."""
        q0 = self._interior(initial_conditions)
        t_eval = np.asarray(timepoints, np.float64)
        sol = dirk2_solve_np(
            self.derivative, q0, t_eval,
            jac_tridiag=self.jacobian_tridiag, substeps=self.substeps,
        )
        k = t_eval.size
        return np.concatenate(
            [np.full((1, k), self.left_bc), sol, np.full((1, k), self.right_bc)]
        )

    # -- noise -------------------------------------------------------------------
    def noise(
        self,
        states: torch.Tensor,
        noise_level: float = 0.0,
        generator: Optional[torch.Generator] = None,
        normals: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Relative Gaussian noise on the interior points, sparing the
        initial column and the boundary rows.

        The standard normals, shaped (N, k - 1), come from ``generator``
        unless given as ``normals``.
        """
        if not noise_level:
            return states
        interior = states[1:-1, 1:]
        if normals is None:
            normals = torch.randn(
                interior.shape, generator=generator, dtype=states.dtype,
                device=states.device,
            )
        noised = interior + (noise_level * interior) * normals
        body = torch.cat([states[:1, 1:], noised, states[-1:, 1:]], dim=0)
        return torch.cat([states[:, :1], body], dim=1)


@dataclasses.dataclass(frozen=True)
class CubicHeatBimodal(HeatBimodal):
    """Heat equation with the cubic reaction term -q^3."""

    @staticmethod
    def reaction(Q):
        return -(Q**3)

    @staticmethod
    def reaction_jac_diag(Q):
        return -3.0 * Q * Q


def solve_host_stacked(foms, initial_conditions, timepoints) -> np.ndarray:
    """Solve L heat trajectories from one initial condition as one stacked
    host SDIRK2 system.

    The models must share the grid, boundary values, diffusion, substeps
    and class; only the forcing amplitudes (a, b) may differ. Their
    tridiagonal Newton matrices stack into one of size L N with the
    couplings across block boundaries zeroed, so every Newton iteration is
    one ``dgtsv`` call for all L. Returns (L, N+2, k) full-grid states.
    """
    f0 = foms[0]
    cls = type(f0)
    for f in foms[1:]:
        if (
            type(f) is not cls
            or f.N != f0.N
            or f.substeps != f0.substeps
            or f.diffusion != f0.diffusion
            or f.left_bc != f0.left_bc
            or f.right_bc != f0.right_bc
        ):
            raise ValueError(
                "solve_host_stacked requires homogeneous models (same grid, "
                "boundary values, diffusion, substeps, class); only the "
                "forcing amplitudes may differ"
            )
    L, n = len(foms), f0.N
    dx2inv, c, Bmat = f0._ops
    amps = np.array([[f.a, f.b] for f in foms], dtype=np.float64)  # (L, 2)
    q0 = f0._interior(initial_conditions)

    def rhs(t, qflat):
        Q = qflat.reshape(L, n)
        lap = -2.0 * Q
        lap[:, :-1] += Q[:, 1:]
        lap[:, 1:] += Q[:, :-1]
        osc = np.stack(
            [amps[:, 0] * np.sin(2.0 * np.pi * t), amps[:, 1] * np.sin(4.0 * np.pi * t)],
            axis=1,
        )  # (L, 2)
        return (c + dx2inv * lap + osc @ Bmat.T + cls.reaction(Q)).ravel()

    dl = np.full(L * n, dx2inv)
    du = np.full(L * n, dx2inv)
    dl[::n] = 0.0
    du[n - 1 :: n] = 0.0
    d_base = np.full(L * n, -2.0 * dx2inv)

    def jac_tridiag(t, qflat):
        extra = cls.reaction_jac_diag(qflat.reshape(L, n))
        return dl, d_base + np.ravel(extra), du

    sol = dirk2_solve_np(
        rhs, np.tile(q0, L), timepoints, jac_tridiag=jac_tridiag, substeps=f0.substeps
    )  # (L n, k)
    k = sol.shape[1]
    return np.concatenate(
        [np.full((L, 1, k), f0.left_bc), sol.reshape(L, n, k), np.full((L, 1, k), f0.right_bc)],
        axis=1,
    )
