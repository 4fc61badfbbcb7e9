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


def stage_generators(
    seed: int, device: DeviceLike, names: Sequence[str] = STAGES
) -> Dict[str, torch.Generator]:
    """One seeded ``torch.Generator`` on ``device`` per stage name."""
    out = {}
    for name, child in zip(names, np.random.SeedSequence(seed).spawn(len(names))):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0]))
        out[name] = gen
    return out
