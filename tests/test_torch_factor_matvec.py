"""The port's factor_matvec kernel module against the JAX package's Pallas
kernel and plain versions.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX kernel
runs in interpret mode at block_b=32, block_o=64, as tests/test_kernels.py
runs it, at that file's four shapes (f32). The same numpy inputs go to both.
Tolerance: rtol 1e-5 with an atol of 1e-6 times max|reference| (f32 sums in
another order). Bucket padding with s = 0 rows must give the same bits.

The CUDA kernel itself is tested on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import factor_matvec as jfm
from repro_torch import kernels
from repro_torch.kernels import factor_matvec as fm

torch.set_num_threads(2)

SHAPES = [(128, 256, 8, 256), (130, 300, 7, 65), (1, 7, 1, 3), (33, 129, 12, 257)]


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _inputs(bt, n_in, r, n_out, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((bt, n_in)) / np.sqrt(n_in)).astype(np.float32),
        rng.standard_normal((r, n_in)).astype(np.float32),
        rng.standard_normal(r).astype(np.float32),
        rng.standard_normal((r, n_out)).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bt,n_in,r,n_out", SHAPES)
def test_factor_matvec_matches_jax(bt, n_in, r, n_out):
    x, a, s, b = _inputs(bt, n_in, r, n_out)
    got = fm.factor_matvec(*_t(x, a, s, b), alpha=0.7)
    assert got.shape == (bt, n_out) and got.dtype == torch.float32
    jx, ja, js, jb = map(jnp.asarray, (x, a, s, b))
    _close(got, jfm.factor_matvec(jx, ja, js, jb, alpha=0.7, block_b=32, block_o=64,
                                  interpret=True))
    _close(got, jfm.ref.factor_matvec(jx, ja, 0.7 * js, jb))


@pytest.mark.parametrize("bt,n_in,r,n_out", SHAPES)
def test_plain_versions_match_jax(bt, n_in, r, n_out):
    """ref.factor_matvec and ref.dense_matvec against the JAX ref twins."""
    x, a, s, b = _inputs(bt, n_in, r, n_out, seed=1)
    jx, ja, js, jb = map(jnp.asarray, (x, a, s, b))
    _close(fm.ref.factor_matvec(*_t(x, a, s, b)), jfm.ref.factor_matvec(jx, ja, js, jb))
    _close(fm.ref.dense_matvec(*_t(x, a, s, b)), jfm.ref.dense_matvec(jx, ja, js, jb))


@pytest.mark.parametrize("transpose", [False, True])
def test_scoring_both_directions_matches_dense(transpose):
    """X @ W is factor_matvec(x, u, s, v) and X @ W^T factor_matvec(x, v, s, u)."""
    rng = np.random.default_rng(2)
    d, m, k = 30, 20, 4
    u, s, v = (rng.standard_normal((k, d)).astype(np.float32),
               rng.standard_normal(k).astype(np.float32),
               rng.standard_normal((k, m)).astype(np.float32))
    w = 0.6 * (u.T * s) @ v
    x = rng.standard_normal((5, m if transpose else d)).astype(np.float32)
    args = (v, s, u) if transpose else (u, s, v)
    got = fm.factor_matvec(*_t(x, *args), alpha=0.6)
    _close(got, x @ (w.T if transpose else w), rtol=1e-4, atol_rel=1e-5)


def test_rank_zero_is_exact_zeros_without_a_launch():
    kernels.reset_launches()
    x = torch.randn(9, 50)
    z = fm.factor_matvec(x, torch.zeros(0, 50), torch.zeros(0), torch.zeros(0, 30), alpha=1.3)
    assert z.shape == (9, 30) and z.dtype == torch.float32 and not torch.any(z)
    jz = jfm.factor_matvec(jnp.asarray(x.numpy()), jnp.zeros((0, 50)), jnp.zeros((0,)),
                           jnp.zeros((0, 30)), interpret=True)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert fm.factor_matvec.launches == 0


@pytest.mark.parametrize("live,cap", [(3, 16), (20, 32), (20, 64), (1, 8)])
def test_zero_tail_rows_are_exact_noops(live, cap):
    """Capacity rows with s == 0 change no bit: a padded rank bucket scores
    exactly what the live rank alone scores."""
    x, a, s, b = _inputs(6, 40, live, 20, seed=3)

    def pad(t):
        return np.concatenate([t, np.zeros((cap - live,) + t.shape[1:], np.float32)])

    live_scores = fm.factor_matvec(*_t(x, a, s, b), alpha=0.9)
    padded = fm.factor_matvec(*_t(x, pad(a), pad(s), pad(b)), alpha=0.9)
    assert torch.equal(live_scores, padded)


def test_alpha_is_folded_into_s():
    x, a, s, b = _t(*_inputs(5, 24, 4, 11, seed=4))
    folded = fm.factor_matvec(x, a, s * 0.3, b)
    assert torch.equal(fm.factor_matvec(x, a, s, b, alpha=0.3), folded)
    assert torch.equal(fm.factor_matvec(x, a, s, b, alpha=torch.tensor(0.3)), folded)
    assert torch.equal(fm.factor_matvec(x, a, s, b), fm.ref.factor_matvec(x, a, s, b))
    assert torch.equal(fm.factor_matvec(x, a, s.reshape(-1, 1), b),
                       fm.factor_matvec(x, a, s, b))


def test_wrapper_refuses_bad_operands():
    x, a, s, b = _t(*_inputs(5, 24, 4, 11, seed=5))
    with pytest.raises(TypeError, match="float32"):
        fm.factor_matvec(x.double(), a, s, b)
    with pytest.raises(TypeError, match="float32"):
        fm.factor_matvec(x, a, s, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fm.factor_matvec(torch.randn(24, 5).T, a, s, b)
    with pytest.raises(ValueError, match="shape"):
        fm.factor_matvec(x, a[:, :20], s, b)
    with pytest.raises(ValueError, match="shape"):
        fm.factor_matvec(x, a, s[:3], b)
    with pytest.raises(ValueError, match="2-D"):
        fm.factor_matvec(x[0], a, s, b)
    with pytest.raises(TypeError, match="alpha"):
        fm.factor_matvec(x, a, s, b, alpha=torch.tensor([0.5, 0.5]))
    meta = [t.to("meta") for t in (x, a, s, b)]
    with pytest.raises(ValueError, match="is on"):
        fm.factor_matvec(x, *meta[1:])
    with pytest.raises(ValueError, match="no kernel for device"):
        fm.factor_matvec(*meta)


@pytest.mark.parametrize("bt,rows", [(1, 1), (64, 1), (130, 1), (300, 2), (600, 4),
                                     (1024, 8)])
def test_rows_per_block_reaches_every_compiled_value(bt, rows):
    """The batches of the card's tests (tests/test_torch_kernels_gpu.py)
    between them take every rows-per-block value the kernel is compiled for."""
    from repro_torch.kernels.factor_matvec import kernel

    assert kernel.rows_per_block(bt) == rows
    assert rows in kernel.ROWS_PER_BLOCK
