"""Problem configurations (counterpart of
``gp_bayesopinf_tpu/pipeline/configs.py``, the SEIRD, Euler and
heat-multi scenarios; defaults match the reference's ``ODEs/config*.py``,
``PDEs/config*.py`` and ``PDEsMulti/config*.py``).
"""

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GPBounds:
    """Hyperparameter box and restart budget for the GP fits."""

    constant: Tuple[float, float]
    length_scale: Tuple[float, float]
    noise_level: Tuple[float, float]
    n_restarts: int


@dataclasses.dataclass(frozen=True)
class SEIRDConfig:
    """SEIRD parameter-estimation scenario."""

    time_domain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0, 200, 500)
    )
    true_parameters6: Tuple[float, ...] = (1.0, 0.25, 0.1, 0.1, 0.05, 0.05)
    initial_conditions: Tuple[float, ...] = (0.994, 0.005, 0.001, 0.0, 0.0)
    test_initial_conditions: Tuple[float, ...] = (0.722, 0.208, 0.070, 0.0, 0.0)
    gp_bounds: GPBounds = GPBounds((1e-8, 1e5), (0.1, 100.0), (1e-16, 0.5), 100)
    reg_grid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.logspace(-16, 5, 22)
    )
    seed: int = 21092023
    substeps: int = 8


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    """Euler GP-BayesOpInf scenario."""

    spatial_domain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0, 2, 201)[:-1]
    )
    time_domain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0, 0.15, 401)
    )
    init_params: Tuple[float, ...] = (22, 20, 24, 95, 105, 100)
    v_ref: float = 100.0
    rho_ref: float = 10.0
    structure: str = "cAH"
    ivp_method: str = "rk4"
    gp_bounds: GPBounds = GPBounds((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2), 100)
    reg_grid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.logspace(-16, 4, 81)
    )
    seed: int = 27092023
    fom_substeps: int = 12
    rom_substeps: int = 8


@dataclasses.dataclass(frozen=True)
class HeatMultiConfig:
    """Cubic-heat multi-trajectory scenario."""

    spatial_domain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0, 1, 500)
    )
    time_domain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0, 2, 500)
    )
    left_bc: float = 0.0
    right_bc: float = 1.0
    diffusion: float = 1e-2
    input_parameters: Tuple[Tuple[float, float], ...] = (
        (-2, 0),
        (-1, -2),
        (0, 1),
        (1, -1),
        (2, 2),
    )
    test_parameters: Tuple[float, float] = (1.5, 0.5)
    structure: str = "cAHBN"
    ivp_method: str = "dirk2"
    gp_bounds: GPBounds = GPBounds((1e-5, 1e5), (1e-5, 1e2), (1e-16, 1e2), 100)
    reg_grid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.logspace(-16, 4, 81)
    )
    seed: int = 29012024
    fom_substeps: int = 4
    rom_substeps: int = 4


# -- file-name formatters ---------------------------------------------------------
def TRNFMT(k: int) -> str:
    return f"trainsize{k:0>3d}"


def SPRSFMT(sparsity: float) -> str:
    return f"sparsity{int(sparsity * 100):0>3d}"


def NOISEFMT(level: float) -> str:
    return "noise000" if not level else f"noise{int(level * 100):0>3d}"


def DIMFMT(i: int) -> str:
    return f"mode{i:0>2d}"
