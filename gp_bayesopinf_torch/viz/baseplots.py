"""Shared plotting primitives (counterpart of
``gp_bayesopinf_tpu/viz/baseplots.py``).

Behavioral spec: reference ``codebase/baseplots.py`` — a fixed semantic
color map and line-plot primitives over the three time domains (sampling,
training/estimation, prediction): truth, projected truth, data markers,
GP mean +/- band, sample mean, individual draws, inter-quartile shading.
LaTeX text rendering is optional (mathtext by default so figures render
without a TeX install).
"""

import numpy as np
import matplotlib.pyplot as plt

# Semantic colors (one hue per role, as in the reference's COLORS map).
COLORS = {
    "truth": "#222222",
    "truth_projected": "#555555",
    "data": "#d95f02",
    "gp": "#1b9e77",
    "samplemean": "#7570b3",
    "draw": "#a6bddb",
    "percentile": "#9ecae1",
}

plt.rc("axes", titlesize="x-large", labelsize="large")
plt.rc("legend", edgecolor="none", frameon=False)


class BasePlotter:
    """Plot primitives over sampling / training / prediction time domains.

    Parameters
    ----------
    sampling_time_domain : (m,) or (r, m) times of the noisy snapshots.
    training_time_domain : (m',) GP estimation times.
    prediction_time_domain : (k,) prediction/truth times.
    """

    def __init__(
        self,
        sampling_time_domain,
        training_time_domain,
        prediction_time_domain,
    ):
        self.sampling_time_domain = np.asarray(sampling_time_domain)
        self.training_time_domain = np.asarray(training_time_domain)
        self.prediction_time_domain = np.asarray(prediction_time_domain)

    @property
    def end_train_index(self) -> int:
        """Index of the first prediction time past the training span."""
        tf = self.training_time_domain[-1]
        return int(np.searchsorted(self.prediction_time_domain, tf, "right"))

    def _vline(self, ax):
        ax.axvline(self.training_time_domain[-1], color="k", lw=0.5, ls="--")

    # -- primitives -------------------------------------------------------------
    def plot_truth(self, ax, vals, **kw):
        kw.setdefault("color", COLORS["truth"])
        kw.setdefault("lw", 1.5)
        ax.plot(self.prediction_time_domain, vals, label="truth", **kw)

    def plot_truth_projected(self, ax, vals, **kw):
        kw.setdefault("color", COLORS["truth_projected"])
        kw.setdefault("lw", 1.0)
        kw.setdefault("ls", "-.")
        ax.plot(self.prediction_time_domain, vals, label="projected truth", **kw)

    def plot_data(self, ax, vals, times=None, **kw):
        kw.setdefault("color", COLORS["data"])
        kw.setdefault("ms", 3)
        t = self.sampling_time_domain if times is None else np.asarray(times)
        ax.plot(t, vals, "o", label="noisy data", **kw)

    def plot_gp(self, ax, mean, std, width=1.96, **kw):
        color = kw.pop("color", COLORS["gp"])
        t = self.training_time_domain
        ax.plot(t, mean, color=color, lw=1.2, label="GP mean", **kw)
        ax.fill_between(
            t, mean - width * std, mean + width * std,
            color=color, alpha=0.25, lw=0, label="GP band",
        )

    def plot_samplemean(self, ax, vals, **kw):
        kw.setdefault("color", COLORS["samplemean"])
        kw.setdefault("lw", 1.2)
        ax.plot(self.prediction_time_domain, vals, label="sample mean", **kw)
        self._vline(ax)

    def plot_draws(self, ax, draws, **kw):
        kw.setdefault("color", COLORS["draw"])
        kw.setdefault("lw", 0.3)
        kw.setdefault("alpha", 0.4)
        for d in draws:
            ax.plot(self.prediction_time_domain, d, **kw)
        self._vline(ax)

    def plot_percentiles(self, ax, draws, lo=25, hi=75, **kw):
        kw.setdefault("color", COLORS["percentile"])
        kw.setdefault("alpha", 0.5)
        draws = np.asarray(draws)
        ax.fill_between(
            self.prediction_time_domain,
            np.percentile(draws, lo, axis=0),
            np.percentile(draws, hi, axis=0),
            lw=0,
            label=f"{lo}-{hi}%",
            **kw,
        )
        self._vline(ax)
