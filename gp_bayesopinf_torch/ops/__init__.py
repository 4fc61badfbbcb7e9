"""Feature maps, kernels of the GP and the ensemble-screen kernels
(counterpart of ``gp_bayesopinf_tpu/ops/``)."""

from .quadratic import ckron, ckron_indices, state_input_kron
from .rbf import (
    KernelMatrices,
    derivative_gram,
    lstsq_kernel_matrices,
    rbf,
    rbf_gram,
)
from .cahbn_screen import (
    cahbn_ensemble_screen,
    cahbn_ensemble_screen_cuda,
    cahbn_ensemble_screen_torch,
    input_stage_times,
)
from .ensemble_screen import (
    quadratic_ensemble_screen,
    quadratic_ensemble_screen_cuda,
    quadratic_ensemble_screen_torch,
)

__all__ = [
    "ckron", "ckron_indices", "state_input_kron",
    "KernelMatrices", "derivative_gram", "lstsq_kernel_matrices", "rbf",
    "rbf_gram",
    "quadratic_ensemble_screen", "quadratic_ensemble_screen_cuda",
    "quadratic_ensemble_screen_torch",
    "cahbn_ensemble_screen", "cahbn_ensemble_screen_cuda",
    "cahbn_ensemble_screen_torch", "input_stage_times",
]
