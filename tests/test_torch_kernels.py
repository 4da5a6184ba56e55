"""The port's kernel modules (power_matvec, rank1_update) against the JAX
package's Pallas kernels and plain versions.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in interpret mode at 64x64 blocks, as tests/test_kernels.py runs
them. The same numpy inputs go to both. Tolerance: rtol 1e-5 with an atol of
1e-6 times max|reference| (f32 sums taken in another order).

The CUDA kernels themselves are tested on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import power_matvec as jpm
from repro.kernels import rank1_update as jr1
from repro_torch import kernels
from repro_torch.kernels import power_matvec as pm
from repro_torch.kernels import rank1_update as r1

torch.set_num_threads(2)

SHAPES = [(512, 48), (300, 40), (65, 33), (37, 5), (1, 7)]


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((n, m)) / np.sqrt(m)).astype(np.float32),
        rng.standard_normal(m).astype(np.float32),
        rng.standard_normal(n).astype(np.float32),
    )


@pytest.mark.parametrize("n,m", SHAPES)
def test_matvec_rmatvec_match_jax(n, m):
    a, v, u = _inputs(n, m)
    ta = torch.from_numpy(a)
    got_mv = pm.matvec(ta, torch.from_numpy(v)).numpy()
    got_rmv = pm.rmatvec(ta, torch.from_numpy(u)).numpy()
    ja, jv, ju = jnp.asarray(a), jnp.asarray(v), jnp.asarray(u)
    _close(got_mv, jpm.ops.matvec(ja, jv, block_r=64, block_c=64, interpret=True))
    _close(got_mv, jpm.ref.matvec(ja, jv)[:, 0])
    _close(got_rmv, jpm.ops.rmatvec(ja, ju, block_r=64, block_c=64, interpret=True))
    _close(got_rmv, jpm.ref.rmatvec(ja, ju)[:, 0])


@pytest.mark.parametrize("n,m", SHAPES)
def test_rank1_update_forms_match_jax(n, m):
    rng = np.random.default_rng(1)
    z, y0 = (rng.standard_normal((2, n, m))).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    a, b, c = 0.75, -0.125, -0.25
    jz, jy0, jx, jy = map(jnp.asarray, (z, y0, x, y))
    got = r1.rank1_update(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(y), a, b)
    _close(got, jr1.ops.rank1_update(jz, jx, jy, a, b, block_r=64, block_c=64, interpret=True))
    _close(got, jr1.ref.rank1_update(jz, jx, jy, a, b))
    got = r1.rank1_update_axpy(
        torch.from_numpy(z), torch.from_numpy(y0), torch.from_numpy(x), torch.from_numpy(y),
        a, b, c,
    )
    _close(got, jr1.ops.rank1_update_axpy(
        jz, jy0, jx, jy, a, b, c, block_r=64, block_c=64, interpret=True))
    _close(got, jr1.ref.rank1_update_axpy(jz, jy0, jx, jy, a, b, c))


def test_rank1_update_in_place_and_tensor_scalars():
    """``out=z`` updates z itself; 0-d float32 tensor scalars equal floats."""
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    y0 = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    x, y = torch.randn(9), torch.randn(6)
    want = r1.rank1_update_axpy(z, y0, x, y, 0.5, 2.0, -1.0)
    g = torch.tensor(0.5)
    out = r1.rank1_update_axpy(z, y0, x, y, 1.0 - g, g * 4.0, -2.0 * g, out=z)
    assert out is z
    torch.testing.assert_close(z, want, rtol=0, atol=0)


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    a = torch.randn(8, 4)
    pm.matvec(a, torch.randn(4))
    pm.rmatvec(a, torch.randn(8))
    r1.rank1_update(a, torch.randn(8), torch.randn(4), 1.0, 1.0)
    r1.rank1_update_axpy(a, a.clone(), torch.randn(8), torch.randn(4), 1.0, 1.0, 1.0)
    assert kernels.launches() == {name: 0 for name in kernels.WRAPPERS}


@pytest.mark.parametrize("case", ["float64", "bfloat16", "noncontiguous", "shape", "3d"])
def test_wrappers_refuse_bad_inputs(case):
    a = torch.randn(6, 4)
    v, u, x = torch.randn(4), torch.randn(6), torch.randn(6)
    if case in ("float64", "bfloat16"):
        a = a.to(getattr(torch, case))
        err = TypeError
    elif case == "noncontiguous":
        a = torch.randn(4, 6).T
        err = ValueError
    elif case == "shape":
        v, u, x = torch.randn(5), torch.randn(7), torch.randn(7)
        err = ValueError
    else:
        a = torch.randn(2, 3, 4)
        err = ValueError
    with pytest.raises(err):
        pm.matvec(a, v)
    with pytest.raises(err):
        pm.rmatvec(a, u)
    with pytest.raises(err):
        r1.rank1_update(a, x, v, 1.0, 1.0)
    with pytest.raises(err):
        r1.rank1_update_axpy(a, a, x, v, 1.0, 1.0, 1.0)


def test_rank1_update_refuses_bad_scalar():
    z = torch.randn(3, 2)
    with pytest.raises(TypeError):
        r1.rank1_update(z, torch.randn(3), torch.randn(2), torch.tensor(1.0, dtype=torch.float64), 1.0)
