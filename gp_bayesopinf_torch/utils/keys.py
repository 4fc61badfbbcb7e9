"""Named random streams (counterpart of ``gp_bayesopinf_tpu/utils/keys.py``).

The JAX package splits one PRNG key into one key per pipeline stage. Here
one ``torch.Generator`` per stage is seeded from
``np.random.SeedSequence(seed).spawn(...)``, so every stage's stream is
independent and a run is reproducible from its seed. Torch's generators
give other numbers than JAX's threefry from the same seed; the parity
tests inject the reference's random numbers instead of relying on seeds.
"""

from typing import Dict, Sequence

import numpy as np
import torch

from .device import DeviceLike

#: The stages of a pipeline run that draw random numbers.
STAGES = ("sample", "noise", "fit", "search", "draws")
#: The multi-trajectory pipeline's stages: one more stream, for the
#: ensemble at the test parameters. ``SeedSequence.spawn`` gives child i
#: the same state whatever the count, so the first five streams are
#: ``STAGES``'s.
MULTI_STAGES = STAGES + ("newparam",)
#: The ODE pipeline's stages: its data stage draws times and noise from one
#: host stream, and the ensemble from unseen initial conditions has its own.
ODE_STAGES = ("sample", "fit", "search", "draws", "newic")


def _children(seed: int, names: Sequence[str]):
    return zip(names, np.random.SeedSequence(seed).spawn(len(names)))


def stage_generators(
    seed: int, device: DeviceLike, names: Sequence[str] = STAGES
) -> Dict[str, torch.Generator]:
    """One seeded ``torch.Generator`` on ``device`` per stage name."""
    out = {}
    for name, child in _children(seed, names):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0]))
        out[name] = gen
    return out


def host_rng(seed: int, name: str, names: Sequence[str] = STAGES) -> np.random.Generator:
    """The NumPy ``Generator`` of stage ``name``, for a stage that draws on
    the host; seeded from the same child of the seed as the stage's
    ``torch.Generator`` would be."""
    return np.random.default_rng(dict(_children(seed, names))[name])
