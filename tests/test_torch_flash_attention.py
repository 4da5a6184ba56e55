"""The port's flash_attention kernel module against the JAX package's Pallas
kernel and plain version.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX
kernel runs in interpret mode at block_q = block_k = 32 (the ops wrapper
pads to the blocks), as tests/test_kernels.py runs it. The same numpy
inputs (seeded) go to both. Tolerances: f32 to rtol 1e-5 with an atol of
1e-5 times max|reference| (the kernel's online softmax sums in another order
than one softmax over the row); bf16 to 5e-2, as tests/test_kernels.py
holds the Pallas kernel, because the kernel keeps p in f32 where the plain
version rounds it to bf16, and the output is rounded to bf16.

The CUDA kernel itself is tested on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _inputs(b, hq, hkv, sq, skv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32))


def _jax(q, k, v, *, causal, dtype=jnp.float32):
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    scale = q.shape[-1] ** -0.5
    kern = jfa.ops.flash_attention(jq, jk, jv, scale=scale, causal=causal, block_q=32,
                                   block_k=32, use_pallas=True, interpret=True)
    return np.asarray(kern, np.float32), np.asarray(
        jfa.ref.attention(jq, jk, jv, scale=scale, causal=causal), np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_attention_gqa_matches_jax(causal, hq, hkv):
    q, k, v = _inputs(2, hq, hkv, 96, 96, 32, seed=hq * 10 + hkv)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=32**-0.5, causal=causal)
    assert got.shape == (2, hq, 96, 32) and got.dtype == torch.float32
    want_kernel, want_ref = _jax(q, k, v, causal=causal)
    _close(got, want_kernel)
    _close(got, want_ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_matches_jax(causal):
    """Sq 50 / Skv 70: the JAX wrapper pads both to the blocks and masks the
    kv tail at kv_len; the causal mask is top-left aligned (kpos <= qpos)."""
    q, k, v = _inputs(1, 2, 2, 50, 70, 16, seed=3)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25, causal=causal)
    want_kernel, want_ref = _jax(q, k, v, causal=causal)
    _close(got, want_kernel)
    _close(got, want_ref)


def test_flash_attention_bf16_matches_jax():
    q, k, v = _inputs(2, 4, 2, 64, 64, 32, seed=5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, scale=32**-0.5, causal=True)
    assert got.dtype == torch.bfloat16
    want_kernel, want_ref = _jax(q, k, v, causal=True, dtype=jnp.bfloat16)
    _close(got.float(), want_kernel, rtol=5e-2, atol_rel=5e-2)
    _close(got.float(), want_ref, rtol=5e-2, atol_rel=5e-2)


@pytest.mark.parametrize("q_offset", [0, 5, 30])
def test_plain_attention_matches_jax_ref_with_offset(q_offset):
    q, k, v = _inputs(2, 6, 2, 7, 40, 12, seed=q_offset)
    got = fa.ref.attention(*map(torch.from_numpy, (q, k, v)), scale=0.3, causal=True,
                           q_offset=q_offset)
    want = jfa.ref.attention(*map(jnp.asarray, (q, k, v)), scale=0.3, causal=True,
                             q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,q_offset", [
    (2, 6, 2, 16, 64, 16, 48),  # the last of 4 sequence shards
    (1, 4, 4, 16, 64, 12, 16),  # the second of 4
    (2, 4, 1, 30, 130, 32, 100),  # an offset off every tile
    (1, 2, 2, 40, 40, 8, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_with_offset_matches_reference_dense_attention(b, hq, hkv, sq, skv, dh, q_offset,
                                                               dtype):
    """A sequence shard's rows [q_offset, q_offset + Sq) against the whole
    sequence's keys: on the CPU the wrapper's plain path against the JAX
    package's ``layers._dense_attention(..., q_offset=)``, the computation
    the reference's attention makes of the same rows of the global arrays
    (f32 rtol 1e-5; bf16 5e-2, the module's tolerances)."""
    from repro.models import layers as jlayers

    q, k, v = _inputs(b, hq, hkv, sq, skv, dh, seed=q_offset + sq)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, scale=dh**-0.5, causal=True, q_offset=q_offset)
    assert got.shape == (b, hq, sq, dh) and got.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers._dense_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale=dh**-0.5,
                                    causal=True, q_offset=q_offset)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    _close(got.float(), np.asarray(want, np.float32), rtol=tol, atol_rel=tol)
    if q_offset == 0 and sq == skv:  # no offset: the causal call it always was
        _close(got.float(), fa.flash_attention(tq, tk, tv, scale=dh**-0.5).float(), 0, 0)


@pytest.mark.parametrize("q_offset,exc", [
    (-1, ValueError), (49, ValueError), (2.0, TypeError), (True, TypeError),
])
def test_wrapper_refuses_offsets_outside_the_keys(q_offset, exc):
    """0 <= q_offset and q_offset + Sq <= Skv, an int: checked on the CPU as
    on the card, before any launch (at offset 0 any Sq, top-left aligned)."""
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 1, 16, 64, 16))
    with pytest.raises(exc, match="q_offset"):
        fa.flash_attention(q, k, v, scale=1.0, q_offset=q_offset)
    fa.flash_attention(q, k, v, scale=1.0, q_offset=48)  # the last rows fit
    fa.flash_attention(k.repeat(1, 2, 1, 1), q, q, scale=1.0)  # Sq 64 > Skv 16 at offset 0


def test_wrapper_reads_strided_head_major_views():
    """The head-major view of a (B, S, H * Dh) projection goes in as it is."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 40, 4 * 16)).astype(np.float32))
    q = x.reshape(2, 40, 4, 16).transpose(1, 2)
    kv = x[..., :32].reshape(2, 40, 2, 16).transpose(1, 2)
    assert not q.is_contiguous() and q.stride(-1) == 1
    got = fa.flash_attention(q, kv, kv, scale=0.25, causal=True)
    _close(got, fa.ref.attention(q.contiguous(), kv.contiguous(), kv.contiguous(), scale=0.25,
                                 causal=True))


def test_cpu_path_launches_nothing():
    kernels.reset_launches()
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 1, 8, 8, 8))
    fa.flash_attention(q, k, v, scale=1.0)
    assert fa.flash_attention.launches == 0 and kernels.launches()["flash_attention"] == 0


@pytest.mark.parametrize("case,exc", [
    ("f16", TypeError), ("int", TypeError), ("mixed", TypeError), ("3d", ValueError),
    ("heads", ValueError), ("dh", ValueError), ("kv_shape", ValueError), ("batch", ValueError),
    ("stride", ValueError), ("device", ValueError),
])
def test_wrapper_refusals(case, exc):
    q, k, v = map(torch.from_numpy, _inputs(2, 4, 2, 8, 8, 16))
    if case == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "int":
        q, k, v = q.int(), k.int(), v.int()
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "3d":
        q = q[0]
    elif case == "heads":
        q = torch.zeros(2, 3, 8, 16)
    elif case == "dh":
        q, k, v = torch.zeros(2, 4, 8, 129), torch.zeros(2, 2, 8, 129), torch.zeros(2, 2, 8, 129)
    elif case == "kv_shape":
        v = v[:, :, :5]
    elif case == "batch":
        k, v = k[:1], v[:1]
    elif case == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "device":
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(exc):
        fa.flash_attention(q, k, v, scale=1.0)


def test_kernel_helpers():
    """Compiled head-dim buckets and the 16-byte-load test (no card needed)."""
    assert [fa.kernel.head_dim_bucket(d) for d in (1, 12, 64, 65, 128)] == [64, 64, 64, 128, 128]
    t = torch.zeros(2, 4, 8, 16)
    assert fa.kernel.vec_ok(torch.float32, 16, t, t, t)
    assert fa.kernel.vec_ok(torch.bfloat16, 16, t.bfloat16(), t.bfloat16(), t.bfloat16())
    assert not fa.kernel.vec_ok(torch.bfloat16, 12, t[..., :12].bfloat16())
    assert not fa.kernel.vec_ok(torch.float32, 16, torch.zeros(2 * 4 * 8 * 16 + 1)[1:].view(
        2, 4, 8, 16))
