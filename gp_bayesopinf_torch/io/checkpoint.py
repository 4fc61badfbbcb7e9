"""Checkpoints of pipeline state (counterpart of
``gp_bayesopinf_tpu/io/checkpoint.py``, which writes orbax checkpoints).

A checkpoint is a directory holding one ``state.pt``: ``torch.save`` of a
dict of tensors (the state) and a dict of plain Python values (the
metadata). It is written to a temporary file and renamed, so an
interrupted save leaves the previous checkpoint whole, and loaded with
``weights_only=True``, so loading runs no pickled code. In a process group
(``parallel.distributed``) every rank saves the same state: rank 0 writes
it and the others wait for it at a barrier.
"""

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike

_FILE = "state.pt"


def save_checkpoint(path: str, state: Dict[str, torch.Tensor], metadata: Optional[Dict] = None):
    """Save ``state`` (name -> tensor, on any device) and ``metadata``
    into the directory ``path``, replacing what it held; in a process
    group only rank 0 writes, and every rank returns once it has."""
    grouped = dist.is_initialized()
    if not grouped or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        payload = {
            "state": {k: v.detach().cpu() for k, v in state.items()},
            "metadata": dict(metadata or {}),
        }
        tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
    if grouped:
        dist.barrier()


def has_checkpoint(path: str) -> bool:
    """Whether the directory ``path`` holds a checkpoint of this module."""
    return os.path.isfile(os.path.join(path, _FILE))


def load_checkpoint(path: str, *, device: DeviceLike) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state, metadata) of the checkpoint in ``path``, the tensors on
    ``device``."""
    payload = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    return payload["state"], dict(payload.get("metadata", {}))


def pipeline_stage_state(**arrays) -> Dict[str, torch.Tensor]:
    """Pack named stage outputs (tensors or arrays; None is left out) into
    a checkpointable dict of tensors."""
    return {
        k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        for k, v in arrays.items() if v is not None
    }
