"""Device policy.

The JAX package moves arrays between a host CPU device and the
accelerator (``gp_bayesopinf_tpu/utils/hostmath.py``) because the TPU has
no native float64. The H100 has, so the port keeps everything on the one
device the caller names. There is no default and no fallback: asking for
CUDA on a machine without it is an error.
"""

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false"
        )
    return dev
