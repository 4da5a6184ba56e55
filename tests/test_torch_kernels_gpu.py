"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without CUDA. This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX.) Tolerances: the
matvecs sum in another order than cuBLAS, so rtol 1e-4 with an atol of 1e-5
times max|plain|; the rank-1 update is spelled in its plain version's order
and must match it bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import power_matvec as pm
from repro_torch.kernels import rank1_update as r1

SHAPES = [(512, 48), (300, 40), (65, 33), (37, 5), (1, 7)]


def _close(got, want, rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _misaligned(shape, device):
    """A contiguous float32 tensor whose data starts 4 bytes past a 16-byte
    boundary, so the kernels take their scalar (non-float4) path."""
    numel = int(np.prod(shape))
    return torch.randn(numel + 1, device=device)[1:].view(*shape)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", SHAPES + [(5000, 1000), (4099, 2048), (70001, 12)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_power_matvec_matches_plain(cuda, n, m, aligned):
    a = torch.randn(n, m, device=cuda) if aligned else _misaligned((n, m), cuda)
    v, u = torch.randn(m, device=cuda), torch.randn(n, device=cuda)
    before = kernels.launches()
    _close(pm.matvec(a, v).cpu(), pm.ref.matvec(a, v).cpu())
    out = pm.rmatvec(a, u)
    _close(out.cpu(), pm.ref.rmatvec(a, u).cpu())
    torch.cuda.synchronize()
    assert kernels.launches()["matvec"] == before["matvec"] + 1
    assert kernels.launches()["rmatvec"] == before["rmatvec"] + 1
    # two-stage fixed-order reduction: repeated calls give identical bits
    assert torch.equal(pm.rmatvec(a, u), out)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", SHAPES + [(5000, 1000), (333, 37)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_rank1_update_matches_plain(cuda, n, m, aligned):
    make = (lambda s: torch.randn(*s, device=cuda)) if aligned else (
        lambda s: _misaligned(s, cuda))
    z, y0 = make((n, m)), make((n, m))
    x, y = torch.randn(n, device=cuda), torch.randn(m, device=cuda)
    g = torch.full((), 0.3, device=cuda)
    scal2 = torch.stack([1.0 - g, -g * 2.0])
    scal3 = torch.stack([1.0 - g, -g * 2.0, -g])
    want = r1.ref.rank1_update(z, x, y, scal2)
    assert torch.equal(r1.rank1_update(z, x, y, 1.0 - g, -g * 2.0), want)
    want = r1.ref.rank1_update_axpy(z, y0, x, y, scal3)
    got = r1.rank1_update_axpy(z, y0, x, y, 1.0 - g, -g * 2.0, -g, out=z)
    assert got is z and torch.equal(z, want)
