"""The CUDA ensemble-screen kernel against its plain PyTorch version, on
the card. Every test here needs a CUDA device and skips without one.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gp_bayesopinf_torch.ops import ensemble_screen as es


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(r, G, nd, k, device):
    rng = np.random.default_rng(11)
    d = 1 + r + r * (r + 1) // 2
    Ohat = 0.25 * rng.standard_normal((G * nd, r, d))
    Ohat[:, :, 1 : 1 + r] -= 0.9 * np.eye(r)
    Ohat[-nd:, :, 1 : 1 + r] += 3.0 * np.eye(r)  # the last candidate diverges
    Ohat[1, 0, 0] = np.nan
    arrays = (Ohat, 0.4 * rng.standard_normal(r), np.linspace(0, 2.0, k),
              np.zeros(r), np.full(r, 10.0), rng.standard_normal((r, k)))
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("r,G,nd", [(6, 4, 20), (3, 5, 7), (12, 2, 32)])
def test_kernel_matches_plain(cuda, r, G, nd):
    args = _case(r, G, nd, 40, cuda)
    before = es.launches
    s_k, e_k = es.quadratic_ensemble_screen(*args, nd=nd, substeps=4)
    torch.cuda.synchronize()
    assert es.launches == before + 1
    s_p, e_p = es.quadratic_ensemble_screen_torch(*args, nd=nd, substeps=4)
    assert torch.equal(s_k, s_p)
    assert not bool(s_k[1]) and not bool(s_k[-nd:].any())
    ok = s_p.reshape(G, nd).all(dim=1)
    # nvcc contracts multiply-adds, so err_sq differs in the last bits.
    torch.testing.assert_close(e_k[ok], e_p[ok], rtol=1e-3, atol=0.0)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = [a.float() for a in _case(3, 2, 4, 10, cuda)]
    with pytest.raises(ValueError, match="nd"):
        es.quadratic_ensemble_screen_cuda(*args, nd=3)
    with pytest.raises(ValueError, match="float32"):
        es.quadratic_ensemble_screen_cuda(args[0].double(), *args[1:], nd=4)
    r = 13  # above the compiled instances (1..12)
    wide = torch.zeros((44, r, 1 + r + r * (r + 1) // 2), device=cuda)
    zeros = torch.zeros(r, device=cuda)
    with pytest.raises(ValueError, match="no instance"):
        es.quadratic_ensemble_screen_cuda(wide, zeros, args[2], zeros, zeros + 1, nd=22)
