"""Feature maps, kernels of the GP and the ensemble-screen kernel
(counterpart of ``gp_bayesopinf_tpu/ops/``)."""

from .quadratic import ckron, ckron_indices
from .rbf import (
    KernelMatrices,
    derivative_gram,
    lstsq_kernel_matrices,
    rbf,
    rbf_gram,
)
from .ensemble_screen import (
    quadratic_ensemble_screen,
    quadratic_ensemble_screen_cuda,
    quadratic_ensemble_screen_torch,
)

__all__ = [
    "ckron", "ckron_indices",
    "KernelMatrices", "derivative_gram", "lstsq_kernel_matrices", "rbf",
    "rbf_gram",
    "quadratic_ensemble_screen", "quadratic_ensemble_screen_cuda",
    "quadratic_ensemble_screen_torch",
]
