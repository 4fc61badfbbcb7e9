"""1-D compressible Euler equations on a periodic domain, the truth model
of the Euler pipeline (counterpart of ``gp_bayesopinf_tpu/models/euler.py``).

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
from ..utils.device import DeviceLike, to_host


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

    # -- visualization ------------------------------------------------------------
    # matplotlib renderings of solved trajectories. They take tensors on any
    # device or NumPy arrays and draw from host copies; matplotlib is
    # imported inside each method, so the solve path never pays for it.
    def _format_space_axes(self, axes):
        x = np.asarray(self.spatial_domain)
        axes[-1].set_xlim(x[0], x[-1])
        axes[-1].set_xlabel(r"$x$")
        axes[0].set_ylabel("Velocity")
        axes[1].set_ylabel("Pressure")
        axes[2].set_ylabel("Density")

    def plot_space(self, vpzeta):
        """Velocity / pressure / density over space at one instant of a
        (3nx,) lifted state."""
        import matplotlib.pyplot as plt

        v, p, zeta = np.split(to_host(vpzeta), 3, axis=0)
        fig, axes = plt.subplots(3, 1, sharex=True)
        x = np.asarray(self.spatial_domain)
        axes[0].plot(x, v)
        axes[1].plot(x, p)
        axes[2].plot(x, 1.0 / zeta)
        self._format_space_axes(axes)
        return fig, axes

    def plot_time(self, t, series):
        """One lifted variable at a fixed spatial point over time."""
        import matplotlib.pyplot as plt

        t, series = to_host(t), to_host(series)
        fig, ax = plt.subplots(1, 1, figsize=(6, 2))
        ax.plot(t, series)
        ax.set_xlim(float(t[0]), float(t[-1]))
        ax.set_xlabel(r"$t$")
        return fig, ax

    def plot_traces(self, t, vpzeta, nlocs: int = 20, cmap=None, isdata=False):
        """Time traces of all three variables at ``nlocs`` spatial points,
        colored by location, with a colorbar."""
        import matplotlib.colors as mcolors
        import matplotlib.pyplot as plt

        t = to_host(t)
        v, p, zeta = np.split(to_host(vpzeta), 3, axis=0)
        nx = v.shape[0]
        xlocs = np.linspace(0, nx, nlocs + 1, dtype=int)[:-1]
        xlocs += max(xlocs[1] // 2, 0) if nlocs > 1 else 0
        cmap = cmap or plt.cm.twilight
        colors = cmap(np.linspace(0, 1, nlocs + 1)[:-1])

        fig, axes = plt.subplots(3, 1, sharex=True, figsize=(12, 6))
        ls = "." if isdata else "-"
        for j, c in zip(xlocs, colors):
            axes[0].plot(t, v[j], ls, color=c, lw=1)
            axes[1].plot(t, p[j], ls, color=c, lw=1)
            axes[2].plot(t, 1.0 / zeta[j], ls, color=c, lw=1)
        axes[-1].set_xlim(t[0], t[-1])
        axes[-1].set_xlabel(r"$t$")
        axes[0].set_ylabel("Velocity")
        axes[1].set_ylabel("Pressure")
        axes[2].set_ylabel("Density")

        x = np.asarray(self.spatial_domain)
        mappable = plt.cm.ScalarMappable(
            norm=mcolors.Normalize(vmin=0, vmax=1),
            cmap=mcolors.LinearSegmentedColormap.from_list(
                "euler", cmap(np.linspace(0, 1, 400)), N=nlocs
            ),
        )
        cbar = fig.colorbar(mappable, ax=axes, pad=0.015)
        cbar.set_ticks(x[xlocs] / (x[-1] - x[0]))
        cbar.set_ticklabels([f"{xx:.2f}" for xx in x[xlocs]])
        cbar.set_label(r"spatial coordinate $x$")
        return fig, axes

    def plot_spacetime(self, t, vpzeta):
        """pcolormesh of velocity, pressure and density over space-time of
        a (3nx, k) lifted trajectory."""
        import matplotlib.pyplot as plt

        arr = to_host(vpzeta)
        if arr.ndim != 2:
            raise ValueError("argument 'vpzeta' must be two dimensional")
        v, p, zeta = np.split(arr, 3, axis=0)
        x = np.asarray(self.spatial_domain)
        X, T = np.meshgrid(x, to_host(t), indexing="ij")

        fig, axes = plt.subplots(3, 1, sharex=True, sharey=True, figsize=(6, 6))
        for var, ax, title in zip(
            (v, p, 1.0 / zeta), axes, ("Velocity", "Pressure", "Density")
        ):
            cdata = ax.pcolormesh(X, T, var, shading="nearest", cmap="viridis")
            fig.colorbar(cdata, ax=ax, extend="both")
            ax.set_ylabel(r"$t$")
            ax.set_title(title)
        axes[-1].set_xlabel(r"$x$")
        return fig, axes

    def animate(self, profile, skip: int = 20, saveas=None):
        """Animate a lifted (3nx, k) trajectory, every ``skip``-th time;
        returns the ``FuncAnimation`` (``.to_jshtml()`` embeds it in a
        notebook) and saves it to ``saveas`` if given."""
        import matplotlib.animation as manimation
        import matplotlib.pyplot as plt

        profile = to_host(profile)
        if profile.ndim != 2:
            raise ValueError("two-dimensional data required for animation")
        data = np.split(profile, 3, axis=0)
        x = np.asarray(self.spatial_domain)

        fig, axes = plt.subplots(3, 1, sharex=True, figsize=(6, 6), dpi=150)
        lines = [ax.plot([], [])[0] for ax in axes]

        def update(index):
            for line, var in zip(lines, data):
                line.set_data(x, var[:, index * skip])
            axes[0].set_title(rf"$t = t_{{{index * skip}}}$")
            return lines

        for ax, var in zip(axes, data):
            ax.set_ylim(var.min() * 0.95, var.max() * 1.05)
        self._format_space_axes(axes)

        ani = manimation.FuncAnimation(
            fig, update, frames=profile.shape[1] // skip, interval=30,
            blit=True,
        )
        plt.close(fig)
        if saveas:
            ani.save(saveas)
        return ani

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
