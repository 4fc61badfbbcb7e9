"""Problem configurations (counterpart of
``gp_bayesopinf_tpu/pipeline/configs.py``, the Euler and heat-multi
scenarios; defaults match the reference's ``PDEs/config*.py`` and
``PDEsMulti/config*.py``).
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
