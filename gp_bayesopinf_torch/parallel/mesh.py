"""Named device meshes and the port's collectives (counterpart of
``gp_bayesopinf_tpu/parallel/mesh.py`` and ``sharded.shard_leading_axis``).

Axis names, as in the JAX package:

* ``"draw"``: posterior draws and regularization candidates (independent);
* ``"mode"``: POD modes and regression row problems (independent GP fits);
* ``"seq"``: a long axis of rows (snapshot rows, regression points),
  whose products are summed over the ranks.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group (``parallel.distributed``), one process group per axis.
JAX places a global array by a sharding annotation and lets XLA insert the
collectives; PyTorch has no such annotation, so ``named_sharding`` has no
counterpart. Every rank holds the same global array and takes its block
(``shard_leading_axis``); the functions here are the only collectives of
the port: a sum (``all_reduce_sum``), a gather (``gather_leading_axis``)
and a broadcast from rank 0 (``broadcast_from_first``).

A block of a dimension split over several axes is indexed row-major over
them, as JAX's ``PartitionSpec(("a", "b"))``. Each collective adds one to
``collectives`` and its wall time to ``collective_seconds``, CUDA work
waited for (a caller sets both to 0 before what it measures).
"""

import time
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

collectives = 0
collective_seconds = 0.0


def mesh_sizes(axis_sizes: Dict[str, int], n: int) -> list:
    """The axis sizes of a mesh of ``n`` devices: ``axis_sizes`` with a
    -1 (at most one) resolved like a reshape. Raises ValueError, with the
    JAX package's messages, where they do not multiply to ``n``."""
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return sizes


def make_mesh(axis_sizes: Dict[str, int], device_type: str = "cuda"):
    """A named mesh over every rank of the process group, ranks laid out
    row-major; ``axis_sizes`` maps axis name -> size, one size may be -1.

    Needs the process group (``parallel.distributed.initialize``, or a
    rank of ``parallel.distributed.spawn``), also for one rank."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    sizes = mesh_sizes(axis_sizes, n)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.distributed.initialize or run "
            "in a rank of parallel.distributed.spawn"
        )
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(axis_sizes))


def mesh_shape_for(n_devices: int) -> Dict[str, int]:
    """Default 2-D (draw, mode) factorization for n devices."""
    mode = 1
    for cand in (4, 2, 1):
        if n_devices % cand == 0 and n_devices >= cand:
            mode = cand
            break
    return {"draw": n_devices // mode, "mode": mode}


def _names(mesh, axes: Axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    missing = [a for a in names if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {missing}")
    return names


def axis_size(mesh, axes: Axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names)."""
    dims = mesh.mesh_dim_names
    return int(np.prod([mesh.size(dims.index(a)) for a in _names(mesh, axes)]))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's coordinate along ``axes``, row-major over a tuple."""
    dims, index = mesh.mesh_dim_names, 0
    for a in _names(mesh, axes):
        index = index * mesh.size(dims.index(a)) + mesh.get_local_rank(a)
    return index


def shard_leading_axis(x, mesh, axis: Axes):
    """This rank's block of ``x`` (a tensor or array) along its leading
    dimension, split over ``axis`` (a name or a tuple of names). The
    dimension must divide, as in JAX."""
    n, P = x.shape[0], axis_size(mesh, axis)
    if n % P:
        raise ValueError(f"a leading dimension of {n} does not divide over {P} ranks of {axis}")
    i = axis_index(mesh, axis)
    return x[i * (n // P) : (i + 1) * (n // P)]


def _timed(op: Callable, x: torch.Tensor):
    global collectives, collective_seconds
    t0 = time.perf_counter()
    out = op()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    collectives += 1
    collective_seconds += time.perf_counter() - t0
    return out


def gather_leading_axis(block: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """The inverse of ``shard_leading_axis``: every rank's block along
    ``axis``, concatenated in order, on every rank (blocks of one shape)."""
    out = block.contiguous()
    dims = mesh.mesh_dim_names
    for a in reversed(_names(mesh, axis)):  # the fastest axis first
        parts = [torch.empty_like(out) for _ in range(mesh.size(dims.index(a)))]
        _timed(lambda: dist.all_gather(parts, out, group=mesh.get_group(a)), out)
        out = torch.cat(parts)
    return out


def all_reduce_sum(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, on each of them (a
    new tensor; over a tuple of axes, one axis after the other)."""
    out = x.clone(memory_format=torch.contiguous_format)
    for a in _names(mesh, axis):
        _timed(lambda: dist.all_reduce(out, group=mesh.get_group(a)), out)
    return out


def broadcast_from_first(x: torch.Tensor, mesh) -> torch.Tensor:
    """Mesh rank 0's ``x`` on every rank of the mesh (a new tensor): a
    decision that must not differ between ranks by a last bit."""
    out = x.clone(memory_format=torch.contiguous_format)
    first = int(mesh.mesh.flatten()[0])
    _timed(lambda: dist.broadcast(out, src=first), out)
    return out


def sharded_map(fn: Callable, n: int, mesh, axis: Axes) -> torch.Tensor:
    """``fn`` over the indices 0..n-1, split over the ranks along ``axis``:
    each rank calls ``fn`` once on its slice of the indices (a LongTensor
    on the CPU) and the results, each with a leading axis of that length,
    are gathered. The indices are padded by wrapping to a multiple of the
    rank count and the padding is discarded, as the JAX package's
    ``_mesh_sharded_grid`` does."""
    P = axis_size(mesh, axis)
    idx = torch.arange(-(-n // P) * P) % n
    return gather_leading_axis(fn(shard_leading_axis(idx, mesh, axis)), mesh, axis)[:n]
