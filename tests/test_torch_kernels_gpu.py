"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without CUDA. This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX.) Tolerances: the
matvecs sum in another order than cuBLAS (and the COO matvec than the
atomics of ``index_add_``), so rtol 1e-4 with an atol of 1e-5 times
max|plain|; the rank-1 update and the quantize pair are spelled in their
plain versions' order and must match them bit for bit.
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


def _coo(n_rows, n_cols, p, device, seed=0, heavy=0):
    """COO entries with a skewed row law, duplicates, an empty row and column
    and ``heavy`` extra entries in column 1 (several kernel pieces)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = (torch.arange(n_rows, dtype=torch.float64) + 1) ** -0.6
    rows = torch.multinomial(w, p, replacement=True, generator=g)
    cols = torch.randint(0, n_cols, (p,), generator=g)
    if heavy:
        rows = torch.cat([rows, torch.randint(0, n_rows, (heavy,), generator=g)])
        cols = torch.cat([cols, torch.ones(heavy, dtype=torch.long)])
    rows[rows == 2] = 1
    cols[cols == 0] = 1
    vals = torch.randn(rows.numel(), generator=g)
    return (rows.to(torch.int32).to(device), cols.to(torch.int32).to(device),
            vals.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy", [(40, 30, 600, 0), (1000, 300, 50000, 5000),
                                         (20000, 17, 300000, 0), (3, 5000, 7, 0)])
def test_cuda_coo_matvec_matches_plain(cuda, d, m, p, heavy):
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy)
    v, u = torch.randn(m, device=cuda), torch.randn(d, device=cuda)
    by_row, by_col = mc.build_order(rows, cols, d, m), mc.build_order(cols, rows, m, d)
    before = kernels.launches()["coo_matvec"]
    gv = mc.coo_matvec(by_row, vals, v)
    gu = mc.coo_matvec(by_col, vals, u)
    torch.cuda.synchronize()
    assert kernels.launches()["coo_matvec"] == before + 2
    _close(gv.cpu(), mc.ref.coo_matvec(rows, cols, vals, v, d).cpu())
    _close(gu.cpu(), mc.ref.coo_matvec(cols, rows, vals, u, m).cpu())
    if d > 3:
        assert float(gv[2]) == 0.0 and float(gu[0]) == 0.0  # empty row and column
    # no atomics: repeated calls give identical bits
    assert torch.equal(mc.coo_matvec(by_row, vals, v), gv)
    assert torch.equal(mc.coo_matvec(by_col, vals, u), gu)
    # zero-weight padding at (0, 0) changes no bit
    pad = torch.zeros(37, dtype=torch.int32, device=cuda)
    rows_p, cols_p = torch.cat([rows, pad]), torch.cat([cols, pad])
    vals_p = torch.cat([vals, torch.zeros(37, device=cuda)])
    assert torch.equal(mc.coo_matvec(mc.build_order(rows_p, cols_p, d, m), vals_p, v), gv)
    assert torch.equal(mc.coo_matvec(mc.build_order(cols_p, rows_p, m, d), vals_p, u), gu)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 37, 1000, 480_189])
@pytest.mark.parametrize("budget", [127, 15, 1])
def test_cuda_quantize_pair_matches_plain_bit_for_bit(cuda, n, budget):
    from repro_torch.kernels import quantize as qz

    x = torch.randn(n, device=cuda) * 3.0
    noise = torch.rand(n, device=cuda)
    scale = torch.max(torch.abs(x))
    # values on and beside the integer grid, where an FMA would floor differently
    k = torch.arange(n, device=cuda, dtype=torch.float32) % (2 * budget + 1) - budget
    grid = k * scale / budget
    before = kernels.launches()
    for xs, ns in ((x, noise), (grid, torch.zeros_like(grid)), (grid, torch.full_like(grid, 0.5))):
        q = qz.quantize(xs, ns, scale, budget=budget)
        assert q.dtype == torch.int8
        assert torch.equal(q, qz.ref.quantize(xs, ns, scale, budget))
        y = qz.dequantize(q, scale, budget=budget)
        assert torch.equal(y, qz.ref.dequantize(q, scale, budget))
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["quantize"] == before["quantize"] + 3
    assert after["dequantize"] == before["dequantize"] + 3
