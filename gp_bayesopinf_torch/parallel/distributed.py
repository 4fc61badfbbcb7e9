"""Process groups over several devices (counterpart of
``gp_bayesopinf_tpu/parallel/distributed.py``).

JAX drives every device of a host from one process and inserts the
collectives itself. The PyTorch idiom is one process ("rank") per device,
joined by ``torch.distributed``; the port's collectives are explicit
(``parallel.mesh``) and are three: a sum (``all_reduce``), a gather
(``all_gather``, list form) and a broadcast.

Backends: NCCL for CUDA devices, gloo for the CPU. ``backend="gloo"`` may be
named for CUDA devices, for one case: several ranks sharing one card, which
NCCL refuses. Nothing switches backend or device on its own: an unknown
backend, NCCL on the CPU and NCCL with two ranks on one card raise.

``spawn`` starts the ranks of one host as processes on a free localhost
port; a rank that raises, dies or stops answering becomes an exception of
the caller within the time limit, never a hang.
"""

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike

BACKENDS = ("nccl", "gloo")
#: Seconds allowed for the process group's set-up and for each collective.
DEFAULT_TIMEOUT = 600.0


def _backend_for(device: DeviceLike, backend: Optional[str]):
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend '{backend}': one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL takes CUDA devices, not '{dev}': use backend='gloo'")
    return dev, backend


def check_distinct_cards(cards: Sequence[str]):
    """Raise ValueError if two ranks name the same card: NCCL takes one
    rank a card (it fails with "Duplicate GPU detected")."""
    seen: Dict[str, int] = {}
    for rank, card in enumerate(cards):
        if card in seen:
            raise ValueError(
                f"ranks {seen[card]} and {rank} are on the same card ({card}); NCCL takes one "
                "rank a card: name backend='gloo' to share one"
            )
        seen[card] = rank


def _join(address: str, num_processes: int, process_id: int, backend, device, timeout: float):
    """Set this rank's device and join the process group of
    ``num_processes`` ranks through a TCP store at ``address`` (host:port,
    served by rank 0)."""
    dev, backend = _backend_for(device, backend)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id)))
        torch.cuda.set_device(dev)
    host, port = address.rsplit(":", 1)
    limit = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=limit)
    if backend == "nccl":
        # Through the store, before NCCL sees the ranks.
        store.set(f"gpboi/card/{process_id}", str(torch.cuda.get_device_properties(dev).uuid))
        check_distinct_cards(
            [store.get(f"gpboi/card/{r}").decode() for r in range(num_processes)]
        )
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=limit)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
    timeout: float = DEFAULT_TIMEOUT,
):
    """Join this process, as rank ``process_id`` of ``num_processes``, to
    the process group served at ``coordinator_address`` ("host:port", by
    rank 0); a no-op for a single process.

    Arguments left None are read from the variables that ``torchrun``
    sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
    without ``WORLD_SIZE`` the process is alone. ``device`` is this rank's
    device, made current; "cuda" without an index means ``cuda:<LOCAL_RANK>``
    (``torchrun``), else ``cuda:<process_id>``. ``backend`` follows the
    device unless named (module docstring). ``timeout`` bounds the set-up
    and every collective, in seconds."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    _join(coordinator_address, num_processes, process_id, backend, device, timeout)


def global_mesh(axis_sizes: Dict[str, int], device_type: str = "cuda"):
    """A mesh over every rank of every host: ``torch.distributed``'s world
    group already spans the hosts, so this is ``make_mesh`` over the world."""
    from .mesh import make_mesh

    return make_mesh(axis_sizes, device_type)


def shutdown():
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, address, device, backend, timeout, args, results):
    """A spawned rank: join the group (also alone: a mesh needs one), run
    ``fn(rank, *args)`` and report its value or its traceback."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        _join(address, nprocs, rank, backend, device, timeout)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(
    fn: Callable,
    nprocs: int,
    devices: Sequence[DeviceLike],
    backend: Optional[str] = None,
    args: tuple = (),
    timeout: float = DEFAULT_TIMEOUT,
) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes, rank i on
    ``devices[i]``, joined in one process group on a free localhost port;
    returns their values in rank order.

    ``fn``, ``args`` and the values are pickled: ``fn`` must be importable
    at module level, and arrays travel best as NumPy arrays. A CPU rank
    runs one thread. If a rank raises or exits without a value, or the
    values are not all in within ``timeout`` seconds, the other ranks are
    terminated and RuntimeError (TimeoutError) is raised here, with the
    rank's traceback. Build kernels before spawning: each rank loads the
    cached library."""
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} processes")
    for dev in devices:
        _backend_for(dev, backend)  # refuse before starting anything
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{_free_port()}"
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, rank, nprocs, address, str(devices[rank]), backend, timeout, args,
                          results))
        for rank in range(nprocs)
    ]
    for p in procs:
        p.start()
    values, suspects = {}, set()
    deadline = time.monotonic() + timeout
    try:
        while len(values) < nprocs:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank's value may still be in the pipe when its exit
                # code shows: call it dead on the second look.
                dead = {r for r, p in enumerate(procs) if r not in values and p.exitcode is not None}
                if dead & suspects:
                    codes = {r: procs[r].exitcode for r in sorted(dead & suspects)}
                    raise RuntimeError(f"rank(s) exited without a value, exit codes {codes}")
                suspects = dead
                if time.monotonic() > deadline:
                    missing = sorted(set(range(nprocs)) - set(values))
                    raise TimeoutError(f"rank(s) {missing} gave no value within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{value}")
            values[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [values[r] for r in range(nprocs)]
