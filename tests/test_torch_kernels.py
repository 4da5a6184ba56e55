"""The port's kernel modules (power_matvec, rank1_update) against the JAX
package's Pallas kernels and plain versions, and ``power_iter_step``, the
four matvecs of one two-sided power iteration, against the JAX package's.

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


@pytest.mark.parametrize("n,d,m", [(300, 40, 28), (65, 33, 7), (1, 7, 3)])
def test_power_iter_step_matches_jax(n, d, m):
    """At tests/test_kernels.py's shape (300, 40, 28) and two odd ones: unit
    (u, v') against the JAX ``ops.power_iter_step`` in interpret mode and its
    ``ref.power_iter_step``, rtol 1e-5 with an atol of 1e-6 of max (f32 sums
    in other orders; the reference's own test holds its two at 1e-4)."""
    rng = np.random.default_rng(n + d + m)
    x = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    r = rng.standard_normal((n, m)).astype(np.float32)
    v = rng.standard_normal(m).astype(np.float32)
    v /= np.linalg.norm(v)
    u1, v1 = pm.power_iter_step(*map(torch.from_numpy, (x, r, v)))
    assert u1.shape == (d,) and v1.shape == (m,) and u1.dtype == torch.float32
    pu, pv = pm.ref.power_iter_step(*map(torch.from_numpy, (x, r, v.reshape(-1, 1))))
    assert torch.equal(u1, pu) and torch.equal(v1, pv)
    jx, jr, jv = map(jnp.asarray, (x, r, v))
    ju, jv1 = jpm.ops.power_iter_step(jx, jr, jv, interpret=True)
    _close(u1, ju)
    _close(v1, jv1)
    ru, rv = jpm.ref.power_iter_step(jx, jr, jv.reshape(-1, 1))
    _close(u1, ru[:, 0])
    _close(v1, rv[:, 0])
    np.testing.assert_allclose([np.linalg.norm(u1.numpy()), np.linalg.norm(v1.numpy())], 1.0,
                               rtol=1e-6)


def test_power_iter_step_counts_four_launches_and_refuses_bad_inputs():
    """On the CPU no kernel launches; the inputs are checked as its matvecs
    check them."""
    kernels.reset_launches()
    x, r, v = torch.randn(20, 6), torch.randn(20, 5), torch.randn(5)
    pm.power_iter_step(x, r, v)
    assert kernels.launches()["matvec"] == kernels.launches()["rmatvec"] == 0
    with pytest.raises(TypeError):
        pm.power_iter_step(x.double(), r, v)
    with pytest.raises(ValueError):
        pm.power_iter_step(x, r, torch.randn(6))
    with pytest.raises(ValueError):
        pm.power_iter_step(x[:19], r, v)


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
    if case == "bfloat16":  # rank1_update's bf16 form takes a bf16 Z with f32 x, y
        assert r1.rank1_update(a, x, v, 1.0, 1.0).dtype == torch.bfloat16
        with pytest.raises(TypeError):
            r1.rank1_update(a, x.bfloat16(), v, 1.0, 1.0)
        with pytest.raises(TypeError):
            r1.rank1_update(a, x, v, 1.0, 1.0, out=torch.empty(6, 4))
    else:
        with pytest.raises(err):
            r1.rank1_update(a, x, v, 1.0, 1.0)
    with pytest.raises(err):
        r1.rank1_update_axpy(a, a, x, v, 1.0, 1.0, 1.0)


BF16_SHAPES = [(128, 64), (130, 72), (37, 5), (1, 9)]


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place (ordered bit
    patterns), so one ulp is a neighbouring value."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


@pytest.mark.parametrize("n,m", BF16_SHAPES)
def test_rank1_update_bf16_matches_jax_kernel(n, m):
    """The bf16 form (Z and out bf16, x, y and scalars f32) against the JAX
    kernel in interpret mode given a bf16 Z: f32 arithmetic rounded once to
    bf16. XLA may contract a*z + b*xy into one multiply-add, which moves the
    f32 value by an ulp and can move its bf16 rounding by one bf16 ulp; so
    the bits are held within one bf16 ulp, and most must be equal."""
    import ml_dtypes

    rng = np.random.default_rng(n + m)
    z = rng.standard_normal((n, m)).astype(ml_dtypes.bfloat16)
    x, y = rng.standard_normal(n).astype(np.float32), rng.standard_normal(m).astype(np.float32)
    a, b = 0.75, -1.25
    tz = torch.from_numpy(z.view(np.uint16).astype(np.int32).astype(np.int16)).view(torch.bfloat16)
    got = r1.rank1_update(tz, torch.from_numpy(x), torch.from_numpy(y), a, b)
    assert got.dtype == torch.bfloat16
    want = jr1.ops.rank1_update(jnp.asarray(z), jnp.asarray(x), jnp.asarray(y), a, b,
                                block_r=64, block_c=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want).view(np.uint16).astype(np.int32).astype(
        np.int16)).view(torch.bfloat16)
    assert _bf16_ulps(got, want) <= 1
    assert float((got != want).float().mean()) < 0.01
    # the plain chain the hybrid head checks against, bit for bit
    chain = (a * tz.float() + b * torch.outer(torch.from_numpy(x), torch.from_numpy(y))).bfloat16()
    assert torch.equal(got, chain)
    # in place
    out = r1.rank1_update(tz, torch.from_numpy(x), torch.from_numpy(y), a, b, out=tz)
    assert out.data_ptr() == tz.data_ptr() and torch.equal(tz, got)


def test_rank1_update_refuses_bad_scalar():
    z = torch.randn(3, 2)
    with pytest.raises(TypeError):
        r1.rank1_update(z, torch.randn(3), torch.randn(2), torch.tensor(1.0, dtype=torch.float64), 1.0)
