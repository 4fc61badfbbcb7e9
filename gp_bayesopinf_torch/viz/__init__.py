"""viz: matplotlib plotting of GP fits and posterior ensembles from host
arrays and the pipelines' HDF5 exports (counterpart of
``gp_bayesopinf_tpu/viz/``, the same public names, HDF5 keys and figure
layout).

It imports numpy, h5py and matplotlib only, neither ``torch`` nor
``jax``, so the port's exports are plotted where the JAX package is not
installed. Nothing on the pipelines' path imports it; without matplotlib
or h5py its import raises ``ImportError`` naming the missing package
(``pip install .[viz,io]``).
"""

from .baseplots import COLORS, BasePlotter
from .plotters import (
    MultiTrajectoryPlotter,
    ODEPlotter,
    ReducedPlotter,
    StatePlotter,
)

__all__ = [
    "COLORS",
    "BasePlotter",
    "MultiTrajectoryPlotter",
    "ODEPlotter",
    "ReducedPlotter",
    "StatePlotter",
]
