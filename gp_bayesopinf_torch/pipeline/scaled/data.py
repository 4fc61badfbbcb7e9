"""Snapshot sources of the production-scale pipeline (counterpart of
``gp_bayesopinf_tpu/pipeline/scaled.py``, ``_synthetic_states`` and
``_euler_states``).

Both return the (n, k) snapshot matrix in float32 on the device: it is
the one large array of the run, and the POD's tall products read it in
that precision. The Euler truth solve itself runs in float64.
"""

import math
from typing import Optional

import numpy as np
import torch

from ...models import Euler
from ...utils.device import DeviceLike


def synthetic_states(
    n: int, k: int, num_modes: int, *, device: DeviceLike,
    generator: Optional[torch.Generator] = None,
    lift_normals: Optional[torch.Tensor] = None,
    noise_normals: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Low-rank snapshots from a stable latent linear system lifted to n
    spatial degrees of freedom.

    The latent dynamics are damped rotation pairs

        q_{2p}'   = -gamma_p q_{2p} - omega_p q_{2p+1},
        q_{2p+1}' =  omega_p q_{2p} - gamma_p q_{2p+1},

    on a ladder of distinct frequencies omega_p = 2 pi (p + 1) 0.8, so
    that over t in [0, 1] the trajectory has numerical rank ``num_modes``
    (similar low frequencies would leave the trailing POD modes pure
    noise, whose near-zero stability envelopes reject every draw). A "cAH"
    ROM represents them exactly (c = 0, H = 0, block-diagonal A).

    The (n, num_modes) lift and the (n, k) noise are standard normals
    from ``generator`` unless given.
    """
    t = torch.linspace(0.0, 1.0, k, dtype=dtype, device=device)
    comps = []
    for p in range(num_modes // 2 + 1):
        omega = 2.0 * math.pi * (p + 1) * 0.8
        damp = (p + 1.0) ** -0.5 * torch.exp(-(0.2 + 0.1 * (p % 5)) * t)
        comps += [damp * torch.cos(omega * t), damp * torch.sin(omega * t)]
    latent = torch.stack(comps[:num_modes])

    def normals(given, shape):
        if given is not None:
            return given.to(dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    # A near-orthogonal random lift: POD orthogonalizes anyway.
    lift = normals(lift_normals, (n, num_modes)) / math.sqrt(n)
    return lift @ latent + 0.003 * normals(noise_normals, (n, k))


def euler_states(
    n: int, k: int, *, device: DeviceLike,
    generator: Optional[torch.Generator] = None,
    noise_normals: Optional[torch.Tensor] = None,
    noiselevel: float = 0.002, t_final: float = 0.06,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Physical snapshots: the Euler model at n = 3 nx lifted degrees of
    freedom ([v, p, 1/rho] on nx periodic cells), k snapshots over the
    training span [0, ``t_final``], which the pipeline maps onto its unit
    time axis (a constant rate factor that the learned operators absorb).

    Over [0, 0.06] the waves are smooth and a quadratic "cAH" closure can
    be learned; later they steepen towards shocks. The truth solve runs
    in float64; each lifted variable block is scaled to O(1) by its
    largest magnitude, so that POD weighs v ~ 1e2, p ~ 1e5 and 1/rho ~
    5e-2 alike; then multiplicative noise at ``noiselevel``, from
    ``generator`` unless ``noise_normals`` (n, k) are given.
    """
    if n % 3:
        raise ValueError("euler data source needs n_space divisible by 3")
    model = Euler(spatial_domain=np.linspace(0.0, 2.0, n // 3 + 1)[:-1])
    ics = model.initial_conditions((22.0, 20.0, 24.0, 95.0, 105.0, 100.0), device=device)
    sol = model.solve(ics, np.linspace(0.0, t_final, k))
    scaled = torch.cat([b / b.abs().max() for b in torch.chunk(sol, 3, dim=0)], dim=0)
    if noise_normals is None:
        noise_normals = torch.randn(
            scaled.shape, generator=generator, dtype=torch.float32, device=device
        )
    return (scaled * (1.0 + noiselevel * noise_normals.to(device))).to(dtype)
