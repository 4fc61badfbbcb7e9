"""HDF5 files of posteriors and pipeline results (counterpart of
``gp_bayesopinf_tpu/io/hdf5.py``).

The schema is the JAX package's, dataset for dataset, so files written by
either package load in the other, and the reference's plotters
(``gp_bayesopinf_tpu/viz``) read the port's exports unchanged:

* Bayesian ODE posterior: ``mean``, ``cov``.
* Bayesian ROM posterior: ``state_dimension``, ``means_{i}``, ``covs_{i}``
  and a ``model`` group (the ROM's metadata as attributes and the
  operator means as ``operators``).
* Pipeline exports: ``<prefix>_data.h5`` (SEIRD, heat-multi) or
  ``<prefix>_data-reduced.h5`` / ``<prefix>_data-full.h5`` (Euler, with
  ``<prefix>-svdvals.npy`` and ``<prefix>-ddtdata.h5``), and
  ``<prefix>_posterior.h5``.

``h5py`` is imported inside the functions (``require_h5py``): without it
they raise an ImportError naming the package, and nothing else of the
port needs it.
Tensors on any device are moved to the host before writing.
"""

import os

import numpy as np
import torch

from ..bayes.posterior import BayesianODE, BayesianROM, OperatorPosterior
from ..rom.model import GalerkinROM
from ..utils.device import DeviceLike


def require_h5py():
    """The ``h5py`` module; raises an ImportError naming it if it is not
    installed."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "HDF5 files (--exportto, io.hdf5) need the 'h5py' package, which is not installed"
        ) from exc
    return h5py


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _check_overwrite(path: str, overwrite: bool):
    if os.path.isfile(path) and not overwrite:
        raise FileExistsError(path)


# ---- Bayesian posteriors -------------------------------------------------------
def save_bayesian_ode(bm: BayesianODE, path: str, overwrite: bool = True):
    h5py = require_h5py()
    _check_overwrite(path, overwrite)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("mean", data=_host(bm.mean))
        hf.create_dataset("cov", data=_host(bm.cov))


def load_bayesian_ode(path: str, model, *, device: DeviceLike) -> BayesianODE:
    """The posterior of ``save_bayesian_ode`` (or of the JAX package's)
    over ``model``'s parameters, on ``device``."""
    h5py = require_h5py()
    with h5py.File(path, "r") as hf:
        mean = torch.as_tensor(hf["mean"][:], device=device)
        cov = torch.as_tensor(hf["cov"][:], device=device)
    return BayesianODE(model, OperatorPosterior.from_moments(mean[None], cov))


def save_bayesian_rom(bm: BayesianROM, path: str, overwrite: bool = True):
    h5py = require_h5py()
    _check_overwrite(path, overwrite)
    means, covs = _host(bm.means), _host(bm.covs)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("state_dimension", data=[bm.ndims])
        for i in range(bm.ndims):
            hf.create_dataset(f"means_{i}", data=means[i])
            hf.create_dataset(f"covs_{i}", data=covs[i])
        grp = hf.create_group("model")
        grp.attrs["structure"] = bm.model.structure
        grp.attrs["state_dimension"] = bm.model.state_dimension
        grp.attrs["input_dimension"] = bm.model.input_dimension
        grp.attrs["ivp_method"] = bm.model.ivp_method
        grp.attrs["substeps"] = bm.model.substeps
        grp.create_dataset("operators", data=means)
        if bm.regularizer is not None:
            grp.attrs["regularizer"] = bm.regularizer


def load_bayesian_rom(path: str, *, device: DeviceLike) -> BayesianROM:
    """The posterior of ``save_bayesian_rom`` (or of the JAX package's) on
    ``device``."""
    h5py = require_h5py()
    with h5py.File(path, "r") as hf:
        r = int(hf["state_dimension"][0])
        means = np.stack([hf[f"means_{i}"][:] for i in range(r)])
        covs = np.stack([hf[f"covs_{i}"][:] for i in range(r)])
        grp = hf["model"]
        rom = GalerkinROM(
            structure=str(grp.attrs["structure"]),
            state_dimension=int(grp.attrs["state_dimension"]),
            input_dimension=int(grp.attrs["input_dimension"]),
            ivp_method=str(grp.attrs["ivp_method"]),
            substeps=int(grp.attrs["substeps"]),
        )
        reg = float(grp.attrs["regularizer"]) if "regularizer" in grp.attrs else None
    posterior = OperatorPosterior.from_moments(
        torch.as_tensor(means, device=device), torch.as_tensor(covs, device=device)
    )
    return BayesianROM(rom, posterior, reg)


# ---- pipeline exports ------------------------------------------------------------
def export_result(result, prefix: str, overwrite: bool = True):
    """Write a pipeline result's files under ``prefix``, by its type:
    ``SEIRDResult``, ``EulerResult`` or ``HeatMultiResult``."""
    h5py = require_h5py()
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    name = type(result).__name__
    if name == "SEIRDResult":
        _export_seird(h5py, result, prefix, overwrite)
    elif name == "EulerResult":
        _export_euler(h5py, result, prefix, overwrite)
    elif name == "HeatMultiResult":
        _export_heat_multi(h5py, result, prefix, overwrite)
    else:
        raise TypeError(f"unknown result type {name}")


def _export_seird(h5py, r, prefix, overwrite):
    path = f"{prefix}_data.h5"
    _check_overwrite(path, overwrite)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("prediction_time_domain", data=_host(r.time_domain))
        hf.create_dataset("true_states", data=_host(r.true_states))
        hf.create_dataset("sampling_time_domain", data=np.stack([_host(t) for t in r.sample_times]))
        hf.create_dataset("snapshots", data=_host(r.snapshots))
        hf.create_dataset("training_time_domain", data=_host(r.t_estimation))
        hf.create_dataset("draws", data=_host(r.draws))
        hf.create_dataset("draws_valid", data=_host(r.valid))
        if r.newic_draws is not None:
            hf.create_dataset("newic_draws", data=_host(r.newic_draws))
            hf.create_dataset("newic_valid", data=_host(r.newic_valid))
        _write_gp_moments(hf, r.gps, r.t_estimation)
    save_bayesian_ode(r.bayesian_model, f"{prefix}_posterior.h5", overwrite)


def _compress(basis, states) -> np.ndarray:
    """``basis.compress`` of host or device states, on the basis' device."""
    x = torch.as_tensor(_host(states), device=basis.entries.device)
    return _host(basis.compress(x))


def _decompress(basis, compressed) -> np.ndarray:
    x = torch.as_tensor(_host(compressed), device=basis.entries.device)
    return _host(basis.decompress(x))


def _export_euler(h5py, r, prefix, overwrite):
    path = f"{prefix}_data-reduced.h5"
    _check_overwrite(path, overwrite)
    truth_compressed = _compress(r.basis, r.true_states)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("sampling_time_domain", data=_host(r.time_domain_sampled))
        hf.create_dataset("training_time_domain", data=_host(r.t_estimation))
        hf.create_dataset("prediction_time_domain", data=_host(r.time_domain))
        hf.create_dataset("snapshots_compressed", data=_host(r.snapshots_compressed))
        hf.create_dataset("true_states_compressed", data=truth_compressed)
        hf.create_dataset("draws_compressed", data=_host(r.draws_compressed))
        hf.create_dataset("draws_valid", data=_host(r.valid))
        _write_gp_moments(hf, r.gps, r.t_estimation)

    # The full-space data, with the projected truth of the close-up figure.
    path = f"{prefix}_data-full.h5"
    _check_overwrite(path, overwrite)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("sampling_time_domain", data=_host(r.time_domain_sampled))
        hf.create_dataset("training_time_domain", data=_host(r.t_estimation))
        hf.create_dataset("prediction_time_domain", data=_host(r.time_domain))
        hf.create_dataset("snapshots", data=_host(r.snapshots_sampled))
        hf.create_dataset("true_states", data=_host(r.true_states))
        hf.create_dataset("true_states_projected", data=_decompress(r.basis, truth_compressed))
        hf.create_dataset("spatial_domain", data=_host(r.model.spatial_domain))
        hf.attrs["num_variables"] = r.model.num_variables
        if r.draws is not None:
            hf.create_dataset("draws", data=_host(r.draws))
    if r.svdvals is not None:
        np.save(f"{prefix}-svdvals.npy", _host(r.svdvals))
    if r.ddtdata is not None:
        path = f"{prefix}-ddtdata.h5"
        _check_overwrite(path, overwrite)
        with h5py.File(path, "w") as hf:
            for k, v in r.ddtdata.items():
                hf.create_dataset(k, data=_host(v))
    save_bayesian_rom(r.bayesian_model, f"{prefix}_posterior.h5", overwrite)


def _export_heat_multi(h5py, r, prefix, overwrite, numspatialpoints: int = 8):
    path = f"{prefix}_data.h5"
    _check_overwrite(path, overwrite)

    # Full-state draws are kept at ``numspatialpoints`` spatial rows only.
    def _decompress_rows(draws, rows):
        if not len(draws):
            return np.zeros((0, len(rows), len(r.time_domain)))
        return np.stack([_decompress(r.basis, d)[rows] for d in draws])

    n_full = r.true_states[0].shape[0]
    rows = np.linspace(0, n_full - 1, numspatialpoints).astype(int)

    with h5py.File(path, "w") as hf:
        hf.create_dataset("sampling_time_domain", data=_host(r.time_domain_sampled))
        hf.create_dataset("training_time_domain", data=_host(r.t_estimation))
        hf.create_dataset("prediction_time_domain", data=_host(r.time_domain))
        if r.spatial_domain is not None:
            hf.create_dataset("spatial_domain", data=_host(r.spatial_domain))
        hf.create_dataset("spatial_rows", data=rows)
        if r.input_parameters is not None:
            hf.create_dataset("input_parameters", data=np.asarray(r.input_parameters))
        if r.test_parameters is not None:
            hf.create_dataset("test_parameters", data=np.asarray(r.test_parameters))
        for ell in range(len(r.snapshots)):
            grp = hf.create_group(f"trajectory_{ell}")
            valid = _host(r.valid[ell]).astype(bool)
            draws = _host(r.draws_compressed[ell])
            grp.create_dataset("snapshots", data=_host(r.snapshots[ell]))
            grp.create_dataset("true_states", data=_host(r.true_states[ell]))
            grp.create_dataset("snapshots_compressed", data=_host(r.snapshots_compressed[ell]))
            grp.create_dataset("true_states_compressed",
                               data=_compress(r.basis, r.true_states[ell]))
            grp.create_dataset("draws_compressed", data=draws)
            grp.create_dataset("draws_valid", data=_host(r.valid[ell]))
            grp.create_dataset("draws_full", data=_decompress_rows(draws[valid], rows))
            _write_gp_moments(grp, r.gps[ell], r.t_estimation)
        if r.newparam_draws is not None:
            grp = hf.create_group("new_trajectory")
            valid = _host(r.newparam_valid).astype(bool)
            draws = _host(r.newparam_draws)
            grp.create_dataset("draws_compressed", data=draws)
            grp.create_dataset("draws_valid", data=_host(r.newparam_valid))
            grp.create_dataset("true_states", data=_host(r.newparam_true))
            grp.create_dataset("true_states_compressed", data=_compress(r.basis, r.newparam_true))
            grp.create_dataset("draws_full", data=_decompress_rows(draws[valid], rows))
    save_bayesian_rom(r.bayesian_model, f"{prefix}_posterior.h5", overwrite)


def _write_gp_moments(hf, gps, t_est):
    """The GPs' predictive means and standard deviations at the estimation
    times (the plotters' inputs), ``gp_means`` and ``gp_stds``."""
    flat = gps if not isinstance(gps[0], (list, tuple)) else [g for sub in gps for g in sub]
    means, stds = [], []
    for gp in flat:
        t = torch.as_tensor(_host(t_est), dtype=gp.y.dtype, device=gp.y.device)
        m, s = gp.predict(t)
        means.append(_host(m))
        stds.append(_host(s))
    hf.create_dataset("gp_means", data=np.stack(means))
    hf.create_dataset("gp_stds", data=np.stack(stds))
