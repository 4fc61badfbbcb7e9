"""Carry the JAX package's state into the port's objects (no JAX
counterpart: this is the bridge the parity tests cross).

Each function reads a ``gp_bayesopinf_tpu`` object field by field as
numpy arrays (``np.asarray`` works on JAX arrays without importing JAX)
and builds the port's counterpart on ``device``, which every function
requires. The parity tests use these to run both packages from the same
state; shapes carry over as they are, so the multi-trajectory forms (a
(r, L, m', m') weight-root stack behind ``weighted_lstsq``) need nothing
extra.
"""

from typing import List

import numpy as np
import torch

from .bayes.posterior import OperatorPosterior
from .gp.estimates import GPEstimates
from .gp.fit import FitResult
from .gp.gp import GaussianProcess
from .gp.lowrank import LowRankWeightRoot
from .models.seird import SEIRD, SEIRD2
from .rom.basis import EulerScaledBasis, QuadraticLiftedBasis
from .solve.lstsq import MatrixTikhonovLSTSQ, TikhonovLSTSQ, WeightedLSTSQ
from .utils.device import DeviceLike


def tensor(x, *, device: DeviceLike) -> torch.Tensor:
    """A JAX or numpy array as a tensor on ``device`` (same dtype)."""
    return torch.as_tensor(np.array(x), device=device)


def _fields(obj, names, device):
    return [tensor(getattr(obj, name), device=device) for name in names]


def fit_result(fit, *, device: DeviceLike) -> FitResult:
    return FitResult(*_fields(fit, FitResult._fields, device))


def gp_estimates(est, *, device: DeviceLike) -> GPEstimates:
    return GPEstimates(*_fields(est, GPEstimates._fields, device))


def lowrank_root(root, *, device: DeviceLike) -> LowRankWeightRoot:
    """A JAX-package ``LowRankWeightRoot`` (NumPy fields) to the port's."""
    Q, gain, lam = _fields(root, ("Q", "gain", "lam"), device)
    return LowRankWeightRoot(Q, gain, lam, float(root.eta), float(root.resid))


def gaussian_processes(gps, *, device: DeviceLike) -> List[GaussianProcess]:
    """JAX ``GaussianProcess`` objects (any weight root) to the port's."""
    out = []
    for gp in gps:
        arrays = {
            name: None if getattr(gp, name) is None else tensor(getattr(gp, name), device=device)
            for name in ("t_training", "y", "t_estimation", "state_estimate",
                         "ddt_estimate", "ddt_covariance", "sqrtW")
        }
        out.append(GaussianProcess(
            constant=float(gp.constant),
            length_scale=float(gp.length_scale),
            noise_level=float(gp.noise_level),
            weight_method=gp.weight_method,
            lowrank_root=(
                None if gp.lowrank_root is None else lowrank_root(gp.lowrank_root, device=device)
            ),
            **arrays,
        ))
    return out


def euler_scaled_basis(basis, *, device: DeviceLike) -> EulerScaledBasis:
    entries, shift_vec, svdvals = _fields(
        basis, ("entries", "shift_vec", "svdvals"), device
    )
    return EulerScaledBasis(
        entries, shift_vec, svdvals,
        v_ref=float(basis.v_ref), rho_ref=float(basis.rho_ref),
    )


def quadratic_lifted_basis(basis, *, device: DeviceLike) -> QuadraticLiftedBasis:
    return QuadraticLiftedBasis(*_fields(basis, ("entries", "shift_vec", "svdvals"), device))


def weighted_lstsq(fac, *, device: DeviceLike) -> WeightedLSTSQ:
    return WeightedLSTSQ(*_fields(fac, WeightedLSTSQ._fields, device))


def tikhonov_lstsq(tik, *, device: DeviceLike) -> TikhonovLSTSQ:
    return TikhonovLSTSQ(*_fields(tik, TikhonovLSTSQ._fields, device))


def matrix_tikhonov_lstsq(mt, *, device: DeviceLike) -> MatrixTikhonovLSTSQ:
    return MatrixTikhonovLSTSQ(*_fields(mt, MatrixTikhonovLSTSQ._fields, device))


def operator_posterior(post, *, device: DeviceLike) -> OperatorPosterior:
    return OperatorPosterior(*_fields(post, OperatorPosterior._fields, device))


def seird_model(model) -> SEIRD2:
    """A JAX ``SEIRD2`` or ``SEIRD`` truth model to the port's (plain
    numbers only, so no device)."""
    cls = SEIRD if model.num_parameters == 6 else SEIRD2
    return cls(parameters=tuple(float(p) for p in model.parameters), substeps=int(model.substeps))
