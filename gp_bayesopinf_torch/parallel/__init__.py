"""Several devices and the tall-matrix factorizations of the
production-scale pipeline (counterpart of ``gp_bayesopinf_tpu/parallel/``):
process groups (``distributed``), named meshes and the collectives
(``mesh``), and the factorizations on one device or split over a mesh
(``sharded``)."""

from .distributed import global_mesh, initialize, shutdown, spawn
from .mesh import gather_leading_axis, make_mesh, mesh_shape_for, shard_leading_axis
from .sharded import randomized_pod, sharded_gram_pod, tall_skinny_svd

__all__ = [
    "gather_leading_axis", "global_mesh", "initialize", "make_mesh", "mesh_shape_for",
    "randomized_pod", "shard_leading_axis", "sharded_gram_pod", "shutdown", "spawn",
    "tall_skinny_svd",
]
