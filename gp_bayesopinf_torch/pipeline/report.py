"""Experiment reports and the figures folder (counterpart of
``gp_bayesopinf_tpu/pipeline/report.py``): a dated figures folder, a
``report.txt`` describing the experimental scenario, and the posterior
summary of the parameter-estimation pipeline. The text is the JAX
package's, character for character."""

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch


def figures_path(base: str = "figures") -> str:
    """The dated figures folder ``<base>/<monthday>/<H-M-S>``, created on
    first use."""
    folder = os.path.join(base, time.strftime("%b%d").lower(), time.strftime("%H-%M-%S"))
    os.makedirs(folder, exist_ok=True)
    return folder


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _array2string(arr) -> str:
    arr = _host(arr)
    if arr.ndim > 1:
        return "[" + "\n ".join(_array2string(sub) for sub in arr) + "]"
    return "[ " + ", ".join(f"{x:.4e}" for x in arr) + " ]"


def summarize_experiment(
    training_span: Tuple[float, float],
    num_samples: int,
    noiselevel: float,
    num_regression_points: int,
    numPODmodes: Optional[int] = None,
    gp_regularizer: Optional[float] = None,
    ndraws: Optional[int] = None,
    folder: Optional[str] = None,
) -> str:
    """Write the experimental-scenario report to ``<folder>/report.txt``,
    print it and return it."""
    report = [
        "EXPERIMENTAL SCENARIO",
        f"Data: {num_samples:d} uniformly sampled snapshots "
        f"over {training_span[0]:.2f} <= t < {training_span[1]:.2f} "
        f"with {noiselevel:.2%} noise",
    ]
    if numPODmodes is not None:
        report.append(f"Dimension: retaining {numPODmodes} POD modes")
    report.append(f"Training: using {num_regression_points:d} regression points")
    if gp_regularizer is not None:
        report.append(f"GP regularization: eta = {gp_regularizer:.2e}")
    if ndraws is not None:
        report.append(f"Posterior: {ndraws} draws")
    text = "\n".join(report)

    folder = folder or figures_path()
    with open(os.path.join(folder, "report.txt"), "w") as out:
        out.write(text)
    print("\n" + text + "\n")
    return text


def summarize_posterior(parameters, bayesian_model, folder: Optional[str] = None) -> str:
    """Append the posterior summary of parameter estimation (the true
    parameters, the posterior mean and covariance) to
    ``<folder>/report.txt``, print it and return it. Tensors on any device
    are moved to the host."""
    text = "\n".join(
        [
            "POSTERIOR DISTRIBUTION",
            f"True parameters:\t{_array2string(parameters)}",
            f"Posterior mean:\t\t{_array2string(bayesian_model.mean)}",
            f"Posterior covariance:\n{_array2string(bayesian_model.cov)}",
        ]
    )
    folder = folder or figures_path()
    with open(os.path.join(folder, "report.txt"), "a") as out:
        out.write("\n" + text)
    print("\n" + text)
    return text
