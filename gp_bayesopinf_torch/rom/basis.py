"""POD bases with shift and scaling transforms
(counterpart of ``gp_bayesopinf_tpu/rom/basis.py``).

* ``PODBasis``: mean-snapshot shift, then a thin SVD.
* ``EulerScaledBasis``: nondimensionalizes (v, p, 1/rho) by
  (v_ref, rho_ref v_ref^2, 1/rho_ref) before the POD.

Singular vectors are defined up to sign, and ``torch.linalg.svd`` may
choose other signs than JAX's; compare bases up to column sign.
"""

import dataclasses
from typing import Optional

import torch


def shift(states: torch.Tensor, shift_by: Optional[torch.Tensor] = None):
    """Subtract the mean snapshot, returning (shifted, mean); or subtract
    ``shift_by`` and return the shifted states only."""
    if shift_by is None:
        mean = torch.mean(states, dim=1)
        return states - mean[:, None], mean
    return states - shift_by[:, None]


@dataclasses.dataclass(frozen=True)
class PODBasis:
    """Rank-r POD basis with mean-snapshot centering."""

    entries: torch.Tensor  # (n, r) leading left singular vectors
    shift_vec: torch.Tensor  # (n,) mean snapshot
    svdvals: torch.Tensor  # (min(n, k),) full singular-value spectrum

    def _pre(self, states: torch.Tensor) -> torch.Tensor:
        return states

    def _post(self, states: torch.Tensor) -> torch.Tensor:
        return states

    @property
    def num_vectors(self) -> int:
        return self.entries.shape[1]

    @property
    def full_dimension(self) -> int:
        return self.entries.shape[0]

    @classmethod
    def fit(cls, states: torch.Tensor, num_vectors: int, **kwargs):
        """Fit the basis to (n, k) snapshots."""
        self0 = cls(entries=None, shift_vec=None, svdvals=None, **kwargs)
        shifted, mean = shift(self0._pre(states))
        U, S, _ = torch.linalg.svd(shifted, full_matrices=False)
        return dataclasses.replace(
            self0, entries=U[:, :num_vectors], shift_vec=mean, svdvals=S
        )

    def compress(self, states: torch.Tensor) -> torch.Tensor:
        """(n, k) states -> (r, k) POD coordinates."""
        return self.entries.T @ shift(self._pre(states), shift_by=self.shift_vec)

    def decompress(self, compressed: torch.Tensor) -> torch.Tensor:
        """(..., r, k) POD coordinates -> (..., n, k) states."""
        lifted = self.entries @ compressed + self.shift_vec[:, None]
        return self._post(lifted)


@dataclasses.dataclass(frozen=True)
class EulerScaledBasis(PODBasis):
    """POD over the jointly nondimensionalized Euler variables (v, p, 1/rho)."""

    v_ref: float = 100.0
    rho_ref: float = 10.0

    def _scale_vec(self, n3: int, like: torch.Tensor) -> torch.Tensor:
        scalers = torch.tensor(
            [self.v_ref, self.rho_ref * self.v_ref**2, 1.0 / self.rho_ref],
            dtype=like.dtype, device=like.device,
        )
        return torch.repeat_interleave(scalers, n3 // 3)

    def _pre(self, states: torch.Tensor) -> torch.Tensor:
        return states / self._scale_vec(states.shape[-2], states)[:, None]

    def _post(self, states: torch.Tensor) -> torch.Tensor:
        return states * self._scale_vec(states.shape[-2], states)[:, None]
