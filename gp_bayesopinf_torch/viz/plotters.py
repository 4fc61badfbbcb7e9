"""Per-pipeline plotters (counterpart of
``gp_bayesopinf_tpu/viz/plotters.py``).

Behavioral spec: reference ``ODEs/step4_plot.py`` (``ODEPlotter``),
``PDEs/step4_plot.py`` (``ReducedPlotter``, ``StatePlotter``), and the
PDEsMulti trajectory-indexed variants. Each plotter renders GP training
fits and posterior ensembles and persists/reloads its datasets through
HDF5 so figures are reproducible from artifacts alone.
"""

from typing import Optional

import numpy as np
import h5py
import matplotlib.pyplot as plt

from .baseplots import BasePlotter


class ODEPlotter(BasePlotter):
    """SEIRD plotter: one panel per state variable."""

    def __init__(
        self,
        sampling_time_domain,
        training_time_domain,
        prediction_time_domain,
        snapshots,
        true_states,
        gp_means,
        gp_stds,
        draws,
        labels=("S", "E", "I", "R", "D"),
    ):
        super().__init__(
            sampling_time_domain, training_time_domain, prediction_time_domain
        )
        self.snapshots = np.asarray(snapshots)
        self.true_states = np.asarray(true_states)
        self.gp_means = np.asarray(gp_means)
        self.gp_stds = np.asarray(gp_stds)
        self.draws = np.asarray(draws)
        self.labels = list(labels)

    def plot_gp_training_fit(self):
        n = self.snapshots.shape[0]
        fig, axes = plt.subplots(n, 1, figsize=(8, 2 * n), sharex=True)
        for i, ax in enumerate(np.atleast_1d(axes)):
            times = (
                self.sampling_time_domain[i]
                if self.sampling_time_domain.ndim == 2
                else self.sampling_time_domain
            )
            self.plot_data(ax, self.snapshots[i], times=times)
            self.plot_gp(ax, self.gp_means[i], self.gp_stds[i])
            ax.set_ylabel(self.labels[i])
        np.atleast_1d(axes)[-1].set_xlabel("$t$")
        np.atleast_1d(axes)[0].legend(loc="best", fontsize="small")
        return fig

    def plot_posterior(self, individual: bool = False, newic_draws=None):
        draws = self.draws if newic_draws is None else np.asarray(newic_draws)
        n = self.true_states.shape[0]
        fig, axes = plt.subplots(n, 1, figsize=(8, 2 * n), sharex=True)
        for i, ax in enumerate(np.atleast_1d(axes)):
            self.plot_truth(ax, self.true_states[i])
            if individual:
                self.plot_draws(ax, draws[:, i, :])
            else:
                self.plot_percentiles(ax, draws[:, i, :])
            self.plot_samplemean(ax, draws[:, i, :].mean(axis=0))
            ax.set_ylabel(self.labels[i])
        np.atleast_1d(axes)[-1].set_xlabel("$t$")
        np.atleast_1d(axes)[0].legend(loc="best", fontsize="small")
        return fig

    # -- persistence ------------------------------------------------------------
    def save(self, path, overwrite=True):
        import os

        if os.path.isfile(path) and not overwrite:
            raise FileExistsError(path)
        with h5py.File(path, "w") as hf:
            for name in (
                "sampling_time_domain",
                "training_time_domain",
                "prediction_time_domain",
                "snapshots",
                "true_states",
                "gp_means",
                "gp_stds",
                "draws",
            ):
                hf.create_dataset(name, data=getattr(self, name))
            hf.attrs["labels"] = self.labels

    @classmethod
    def load(cls, path):
        with h5py.File(path, "r") as hf:
            kw = {
                name: hf[name][:]
                for name in (
                    "sampling_time_domain",
                    "training_time_domain",
                    "prediction_time_domain",
                    "snapshots",
                    "true_states",
                    "gp_means",
                    "gp_stds",
                    "draws",
                )
            }
            labels = list(hf.attrs["labels"])
        return cls(labels=labels, **kw)


class ReducedPlotter(BasePlotter):
    """Reduced-space plotter: GP fit + posterior per POD mode (<= 8 shown,
    as in the reference)."""

    MAXMODES = 8

    def __init__(
        self,
        sampling_time_domain,
        training_time_domain,
        prediction_time_domain,
        snapshots_compressed,
        true_states_compressed,
        gp_means,
        gp_stds,
        draws_compressed,
    ):
        super().__init__(
            sampling_time_domain, training_time_domain, prediction_time_domain
        )
        self.snapshots_compressed = np.asarray(snapshots_compressed)
        self.true_states_compressed = (
            None if true_states_compressed is None
            else np.asarray(true_states_compressed)
        )
        self.gp_means = np.asarray(gp_means)
        self.gp_stds = np.asarray(gp_stds)
        self.draws_compressed = np.asarray(draws_compressed)

    def _grid(self, r):
        rows = min(r, self.MAXMODES)
        fig, axes = plt.subplots(rows, 1, figsize=(8, 1.8 * rows), sharex=True)
        return fig, np.atleast_1d(axes)

    def plot_gp_training_fit(self, width: float = 3.0):
        r = min(self.snapshots_compressed.shape[0], self.MAXMODES)
        fig, axes = self._grid(r)
        for i, ax in enumerate(axes):
            self.plot_data(ax, self.snapshots_compressed[i])
            self.plot_gp(ax, self.gp_means[i], self.gp_stds[i], width=width)
            ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
        axes[-1].set_xlabel("$t$")
        axes[0].legend(loc="best", fontsize="small")
        return fig

    def plot_posterior(self, individual: bool = False):
        r = min(self.draws_compressed.shape[1], self.MAXMODES)
        fig, axes = self._grid(r)
        for i, ax in enumerate(axes):
            if self.true_states_compressed is not None:
                self.plot_truth(ax, self.true_states_compressed[i])
            if individual:
                self.plot_draws(ax, self.draws_compressed[:, i, :])
            else:
                self.plot_percentiles(ax, self.draws_compressed[:, i, :])
            self.plot_samplemean(ax, self.draws_compressed[:, i, :].mean(axis=0))
            ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
        axes[-1].set_xlabel("$t$")
        axes[0].legend(loc="best", fontsize="small")
        return fig

    def save(self, path, overwrite=True):
        import os

        if os.path.isfile(path) and not overwrite:
            raise FileExistsError(path)
        with h5py.File(path, "w") as hf:
            for name in (
                "sampling_time_domain",
                "training_time_domain",
                "prediction_time_domain",
                "snapshots_compressed",
                "true_states_compressed",
                "gp_means",
                "gp_stds",
                "draws_compressed",
            ):
                value = getattr(self, name)
                if value is not None:
                    hf.create_dataset(name, data=value)

    @classmethod
    def load(cls, path):
        with h5py.File(path, "r") as hf:
            kw = {
                name: hf[name][:]
                for name in (
                    "sampling_time_domain",
                    "training_time_domain",
                    "prediction_time_domain",
                    "snapshots_compressed",
                    "true_states_compressed",
                    "gp_means",
                    "gp_stds",
                    "draws_compressed",
                )
            }
        return cls(**kw)


class MultiTrajectoryPlotter(BasePlotter):
    """Trajectory-indexed reduced-space plotter for the multi-trajectory
    pipeline (reference ``PDEsMulti/step4_plot.py:19-217``): every dataset
    carries a leading trajectory axis, plus an optional unseen-parameter
    trajectory rendered by :meth:`plot_posterior_newparams`
    (reference ``step4_plot.py:180-217,447-509``)."""

    def __init__(
        self,
        sampling_time_domain,
        training_time_domain,
        prediction_time_domain,
        trajectory_parameters,  # (L, p) training input parameters
        snapshots_compressed,  # (L, r, m)
        true_states_compressed,  # (L, r, k)
        gp_means,  # (L, r, m')
        gp_stds,  # (L, r, m')
        draws_compressed,  # (L, ndraws, r, k)
        test_parameters=None,  # (p,) unseen input parameters
        newparam_draws=None,  # (ndraws, r, k)
        newparam_true_compressed=None,  # (r, k)
    ):
        super().__init__(
            sampling_time_domain, training_time_domain, prediction_time_domain
        )
        self.trajectory_parameters = np.asarray(trajectory_parameters)
        self.snapshots_compressed = np.asarray(snapshots_compressed)
        self.true_states_compressed = np.asarray(true_states_compressed)
        self.gp_means = np.asarray(gp_means)
        self.gp_stds = np.asarray(gp_stds)
        self.draws_compressed = np.asarray(draws_compressed)
        self.test_parameters = (
            None if test_parameters is None else np.asarray(test_parameters)
        )
        self.newparam_draws = (
            None if newparam_draws is None else np.asarray(newparam_draws)
        )
        self.newparam_true_compressed = (
            None
            if newparam_true_compressed is None
            else np.asarray(newparam_true_compressed)
        )

    @property
    def num_trajectories(self) -> int:
        return self.snapshots_compressed.shape[0]

    @property
    def num_modes(self) -> int:
        return self.snapshots_compressed.shape[1]

    def _traj_grid(self, trajectories):
        import matplotlib.pyplot as plt

        r, L = self.num_modes, len(trajectories)
        fig, axes = plt.subplots(
            r, L, figsize=(3.2 * L, 1.6 * r), sharex=True, sharey="row"
        )
        return fig, np.atleast_2d(axes).reshape(r, L)

    def plot_gp_training_fit(self, trajectories=None, width: float = 3.0):
        """Modes x trajectories grid of GP fits (``step4_plot.py`` gpfit
        layout: truth, observations, GP band per panel)."""
        trajectories = (
            list(range(self.num_trajectories))
            if trajectories is None
            else list(trajectories)
        )
        fig, axes = self._traj_grid(trajectories)
        for col, ell in enumerate(trajectories):
            for i in range(self.num_modes):
                ax = axes[i, col]
                self.plot_truth(ax, self.true_states_compressed[ell, i])
                self.plot_data(ax, self.snapshots_compressed[ell, i])
                self.plot_gp(
                    ax, self.gp_means[ell, i], self.gp_stds[ell, i], width=width
                )
                if i == 0:
                    params = tuple(self.trajectory_parameters[ell])
                    ax.set_title(rf"$(a, b) = {params}$", fontsize="small")
                if col == 0:
                    ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
        for ax in axes[-1, :]:
            ax.set_xlabel("$t$")
        return fig

    def plot_posterior(self, trajectories=None, spread: bool = True):
        """Modes x trajectories grid of posterior ensembles."""
        trajectories = (
            list(range(self.num_trajectories))
            if trajectories is None
            else list(trajectories)
        )
        fig, axes = self._traj_grid(trajectories)
        for col, ell in enumerate(trajectories):
            draws = self.draws_compressed[ell]
            for i in range(self.num_modes):
                ax = axes[i, col]
                self.plot_truth(ax, self.true_states_compressed[ell, i])
                self.plot_data(ax, self.snapshots_compressed[ell, i])
                if spread:
                    self.plot_percentiles(ax, draws[:, i, :])
                else:
                    self.plot_draws(ax, draws[:, i, :])
                self.plot_samplemean(ax, draws[:, i, :].mean(axis=0))
                if i == 0:
                    params = tuple(self.trajectory_parameters[ell])
                    ax.set_title(rf"$(a, b) = {params}$", fontsize="small")
                if col == 0:
                    ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
        for ax in axes[-1, :]:
            ax.set_xlabel("$t$")
        return fig

    def plot_posterior_newparams(self, spread: bool = True):
        """Posterior ensemble at the UNSEEN input parameters (reference
        ``PDEsMulti/step4_plot.py:180-217,447-509``)."""
        import matplotlib.pyplot as plt

        if self.newparam_draws is None:
            raise ValueError("no new-parameter draws stored")
        r = self.num_modes
        fig, axes = plt.subplots(r, 1, figsize=(8, 1.7 * r), sharex=True)
        axes = np.atleast_1d(axes)
        draws = self.newparam_draws
        for i, ax in enumerate(axes):
            if self.newparam_true_compressed is not None:
                self.plot_truth(ax, self.newparam_true_compressed[i])
            if spread:
                self.plot_percentiles(ax, draws[:, i, :])
            else:
                self.plot_draws(ax, draws[:, i, :])
            self.plot_samplemean(ax, draws[:, i, :].mean(axis=0))
            ax.set_ylabel(rf"$\hat{{q}}_{{{i + 1}}}(t)$")
        axes[-1].set_xlabel("$t$")
        if self.test_parameters is not None:
            fig.suptitle(rf"$(a, b) = {tuple(self.test_parameters)}$")
        return fig

    # -- persistence ------------------------------------------------------------
    _DATASETS = (
        "sampling_time_domain",
        "training_time_domain",
        "prediction_time_domain",
        "trajectory_parameters",
        "snapshots_compressed",
        "true_states_compressed",
        "gp_means",
        "gp_stds",
        "draws_compressed",
    )
    _OPTIONAL = (
        "test_parameters",
        "newparam_draws",
        "newparam_true_compressed",
    )

    def save(self, path, overwrite=True):
        import os

        if os.path.isfile(path) and not overwrite:
            raise FileExistsError(path)
        with h5py.File(path, "w") as hf:
            for name in self._DATASETS + self._OPTIONAL:
                value = getattr(self, name)
                if value is not None:
                    hf.create_dataset(name, data=value)

    @classmethod
    def load(cls, path):
        with h5py.File(path, "r") as hf:
            kw = {name: hf[name][:] for name in cls._DATASETS}
            for name in cls._OPTIONAL:
                kw[name] = hf[name][:] if name in hf else None
        return cls(**kw)


class StatePlotter(BasePlotter):
    """Full-state plotter: posterior at selected spatial points
    (reference ``PDEs/step4_plot.py:187-382``)."""

    def __init__(
        self,
        sampling_time_domain,
        training_time_domain,
        prediction_time_domain,
        spatial_domain,
        num_variables,
        snapshots,
        true_states,
        true_states_projected,
        draws,
        numspatialpoints: int = 4,
    ):
        super().__init__(
            sampling_time_domain, training_time_domain, prediction_time_domain
        )
        self.spatial_domain = np.asarray(spatial_domain)
        self.num_variables = int(num_variables)
        self.snapshots = np.asarray(snapshots)
        self.true_states = np.asarray(true_states)
        self.true_states_projected = np.asarray(true_states_projected)
        self.draws = np.asarray(draws)
        self.numspatialpoints = int(numspatialpoints)

    def _point_indices(self):
        nx = self.spatial_domain.size
        if self.numspatialpoints <= 0:
            return np.arange(nx)
        return np.linspace(0, nx - 1, self.numspatialpoints).astype(int)

    def plot_posterior(self, individual: bool = False):
        """One figure per state variable; panels are spatial locations."""
        nx = self.spatial_domain.size
        idxs = self._point_indices()
        figures = []
        for v in range(self.num_variables):
            fig, axes = plt.subplots(
                len(idxs), 1, figsize=(8, 1.8 * len(idxs)), sharex=True
            )
            for j, ax in zip(idxs, np.atleast_1d(axes)):
                row = v * nx + j
                self.plot_truth(ax, self.true_states[row])
                self.plot_truth_projected(ax, self.true_states_projected[row])
                if individual:
                    self.plot_draws(ax, self.draws[:, row, :])
                else:
                    self.plot_percentiles(ax, self.draws[:, row, :])
                self.plot_samplemean(ax, self.draws[:, row, :].mean(axis=0))
                ax.set_ylabel(rf"$x = {self.spatial_domain[j]:.2f}$")
            np.atleast_1d(axes)[-1].set_xlabel("$t$")
            figures.append(fig)
        return figures

    def save(self, path, overwrite=True):
        import os

        if os.path.isfile(path) and not overwrite:
            raise FileExistsError(path)
        with h5py.File(path, "w") as hf:
            for name in (
                "sampling_time_domain",
                "training_time_domain",
                "prediction_time_domain",
                "spatial_domain",
                "snapshots",
                "true_states",
                "true_states_projected",
                "draws",
            ):
                hf.create_dataset(name, data=getattr(self, name))
            hf.attrs["num_variables"] = self.num_variables
            hf.attrs["numspatialpoints"] = self.numspatialpoints

    @classmethod
    def load(cls, path):
        with h5py.File(path, "r") as hf:
            kw = {
                name: hf[name][:]
                for name in (
                    "sampling_time_domain",
                    "training_time_domain",
                    "prediction_time_domain",
                    "spatial_domain",
                    "snapshots",
                    "true_states",
                    "true_states_projected",
                    "draws",
                )
            }
            kw["num_variables"] = int(hf.attrs["num_variables"])
            kw["numspatialpoints"] = int(hf.attrs["numspatialpoints"])
        return cls(**kw)
