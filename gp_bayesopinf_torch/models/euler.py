"""1-D compressible Euler equations on a periodic domain, the truth model
of the Euler pipeline (counterpart of ``gp_bayesopinf_tpu/models/euler.py``;
plotting is left out).

Conservative variables (rho, rho v, rho e) with an ideal-gas closure
(gamma = 1.4) are integrated with first-order upwind differences; the
learning variables are the specific-volume variables (v, p, 1/rho), in
which the dynamics are quadratic.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..solve.ivp import rk4_solve
from ..utils.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class Euler:
    """Periodic 1-D Euler solver in conservative variables.

    Parameters
    ----------
    spatial_domain : (nx,) uniform periodic grid (endpoint not repeated).
    substeps : minimum RK4 substeps per output interval; ``solve`` raises
        it to meet the CFL limit.
    cfl_safety : CFL number used for the substep count.
    """

    spatial_domain: np.ndarray
    substeps: int = 12
    cfl_safety: float = 0.4

    gamma = 1.4
    num_variables = 3

    @property
    def dx(self) -> float:
        return float(self.spatial_domain[1] - self.spatial_domain[0])

    # -- variable transforms ---------------------------------------------------
    @staticmethod
    def split(states: torch.Tensor):
        return torch.chunk(states, 3, dim=0)

    @classmethod
    def lift(cls, states: torch.Tensor) -> torch.Tensor:
        """[rho, rho v, rho e] -> [v, p, 1/rho]."""
        rho, rho_v, rho_e = cls.split(states)
        v = rho_v / rho
        p = (cls.gamma - 1.0) * (rho_e - 0.5 * rho * v * v)
        return torch.cat([v, p, 1.0 / rho], dim=0)

    @classmethod
    def unlift(cls, lifted: torch.Tensor) -> torch.Tensor:
        """[v, p, 1/rho] -> [rho, rho v, rho e]."""
        v, p, zeta = cls.split(lifted)
        rho = 1.0 / zeta
        rho_v = rho * v
        rho_e = p / (cls.gamma - 1.0) + 0.5 * rho * v * v
        return torch.cat([rho, rho_v, rho_e], dim=0)

    @classmethod
    def lift_ddts(cls, states: torch.Tensor, ddts: torch.Tensor) -> torch.Tensor:
        """Chain rule: time derivatives of the conservative ``states`` ->
        time derivatives of [v, p, 1/rho]."""
        rho, rho_v, _ = cls.split(states)
        drho, drho_v, drho_e = cls.split(ddts)
        v = rho_v / rho
        dv = (drho_v - drho * v) / rho
        dp = (cls.gamma - 1.0) * (drho_e - rho_v * dv - drho * v * v / 2.0)
        dzeta = -drho / (rho * rho)
        return torch.cat([dv, dp, dzeta], dim=0)

    # -- initial conditions -----------------------------------------------------
    def initial_conditions(
        self, init_params, device: DeviceLike, dtype=torch.float64
    ) -> torch.Tensor:
        """Periodic-cubic-spline initial condition in [v, p, 1/rho].

        ``init_params`` are three density knots then three velocity knots
        at x0 + (0, L/3, 2L/3); the pressure is a constant 1e5.
        """
        import scipy.interpolate

        x = np.asarray(self.spatial_domain)
        L = x[-1] - x[0]
        nodes = np.array([0.0, L / 3.0, 2.0 * L / 3.0, L]) + x[0]
        init_params = np.asarray(init_params, dtype=np.float64)
        rho0 = np.concatenate([init_params[:3], init_params[:1]])
        v0 = np.concatenate([init_params[3:], init_params[3:4]])
        v = scipy.interpolate.CubicSpline(nodes, v0, bc_type="periodic")(x)
        rho = scipy.interpolate.CubicSpline(nodes, rho0, bc_type="periodic")(x)
        p = 1e5 * np.ones_like(v)
        return torch.as_tensor(
            np.concatenate([v, p, 1.0 / rho]), dtype=dtype, device=device
        )

    # -- dynamics ----------------------------------------------------------------
    def derivative(self, t, state: torch.Tensor) -> torch.Tensor:
        """Upwind semi-discrete right-hand side in conservative variables."""
        rho, rho_v, rho_e = self.split(state)
        v = rho_v / rho
        p = (self.gamma - 1.0) * (rho_e - 0.5 * rho_v * v)

        def ddx(w):
            return (w - torch.roll(w, 1, dims=0)) / self.dx

        return -torch.cat(
            [ddx(rho_v), ddx(rho_v * v + p), ddx((rho_e + p) * v)], dim=0
        )

    def solve(self, initial_conditions: torch.Tensor, timepoints) -> torch.Tensor:
        """Integrate from a lifted initial condition; returns lifted (3nx, k).

        The substep count comes from the CFL limit at the initial
        condition over the largest output interval, so non-uniform sample
        times stay stable.
        """
        ics = initial_conditions.detach().cpu().numpy()
        v, p, zeta = np.split(ics, 3)
        sound = np.sqrt(self.gamma * np.abs(p) / (1.0 / zeta))
        speed = float(np.max(np.abs(v) + sound))
        dt_cfl = self.cfl_safety * self.dx / max(speed, 1e-30)
        t_np = np.asarray(timepoints, dtype=np.float64)
        substeps = max(self.substeps, int(np.ceil(np.max(np.diff(t_np)) / dt_cfl)))

        q0 = self.unlift(initial_conditions)
        t = torch.as_tensor(t_np, dtype=q0.dtype, device=q0.device)
        return self.lift(rk4_solve(self.derivative, q0, t, substeps=substeps))

    # -- noise --------------------------------------------------------------------
    def noise(
        self,
        states: torch.Tensor,
        noise_level: float = 0.0,
        generator: Optional[torch.Generator] = None,
        normals: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Scale-relative Gaussian noise applied in conservative variables;
        the initial-condition column stays clean.

        The standard normals, shaped (3nx, k - 1), come from ``generator``
        unless given as ``normals``.
        """
        if not noise_level:
            return states
        unlifted = self.unlift(states[:, 1:])
        scale = torch.cat(
            [
                torch.full_like(var, noise_level * float(var.max() - var.min()))
                for var in self.split(unlifted)
            ],
            dim=0,
        )
        if normals is None:
            normals = torch.randn(
                unlifted.shape, generator=generator, dtype=unlifted.dtype,
                device=unlifted.device,
            )
        noised = unlifted + scale * normals
        return torch.cat([states[:, :1], self.lift(noised)], dim=1)
