"""HDF5 files in the reference's schema, and checkpoints
(counterpart of ``gp_bayesopinf_tpu/io/``)."""

from .checkpoint import load_checkpoint, pipeline_stage_state, save_checkpoint
from .hdf5 import (
    export_result,
    load_bayesian_ode,
    load_bayesian_rom,
    save_bayesian_ode,
    save_bayesian_rom,
)

__all__ = [
    "save_bayesian_ode",
    "load_bayesian_ode",
    "save_bayesian_rom",
    "load_bayesian_rom",
    "export_result",
    "save_checkpoint",
    "load_checkpoint",
    "pipeline_stage_state",
]
