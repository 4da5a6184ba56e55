"""The port's WKV6 chunk (``repro_torch.kernels.wkv6_chunk``) against the
JAX package's, on the CPU.

Inputs are numpy draws from a seed, with the model's decay law (logw =
-exp(w), w ~ N(-1, 0.6): at q = 256 about a quarter of the (position,
channel) pairs have an in-chunk cumulative log decay past -80, so the
kernel's clamps bind), a nonzero bonus u and a nonzero state.

* The port's exact recurrence (``ref.wkv6_chunk``/``_batched``) against the
  JAX ``ref``: the same sequential f32 recurrence, so rtol 1e-5 with an
  atol of 1e-5 of max|reference|.
* The port's chunk form (``ops.wkv6_chunk`` on the CPU) against the Pallas
  kernel in interpret mode, each (head, row) of y to its own max|reference|
  and S_out to its max: 2e-5 where the in-chunk prefix sums stay above -40
  (q <= 64), 1e-3 for longer chunks (q = 100, 256). At q = 256 the prefix
  sums run to about -110,
  where one f32 ulp is 7.6e-6; the JAX package's cumsum is off by up to
  2.2e-5 there (against float64), PyTorch's CPU cumsum (which accumulates in
  f64) by 3.8e-6, and a pair's weight exp(clip(pw_t)) * exp(clip(-cw_s))
  carries that error relatively. Both are also held to the chunk form in
  float64 (numpy): the port to 1e-4 per row, the JAX kernel to 1e-3.
* Caveat (e): at q = 256 the chunk form and the exact recurrence differ by
  the same large amount in both packages (their gaps agree to 1e-3 of the
  gap); at q = 32 they agree to 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6_chunk import kernel as jkernel
from repro.kernels.wkv6_chunk import ops as jops
from repro.kernels.wkv6_chunk import ref as jref
from repro_torch import kernels
from repro_torch.kernels.wkv6_chunk import ops, ref

torch.set_num_threads(2)


def _inputs(b, h, q, dk, dv, seed, dtype=np.float32):
    """r, k, logw (b, h, q, dk), v (b, h, q, dv), u (h, dk), s0 (b, h, dk, dv);
    r/k/v/logw rounded to ``dtype`` (bf16 through ml_dtypes), u and s0 f32."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, q, dk)) * 0.5
    k = rng.standard_normal((b, h, q, dk)) * 0.5
    v = rng.standard_normal((b, h, q, dv))
    logw = -np.exp(rng.normal(-1.0, 0.6, (b, h, q, dk)))
    u = (rng.standard_normal((h, dk)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dk, dv)) * 0.3).astype(np.float32)
    cast = [np.asarray(a, np.float32).astype(dtype) for a in (r, k, v, logw)]
    return (*cast, u, s0)


def _torch(a):
    """numpy (f32 or ml_dtypes bf16) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_bh(a):
    """(b, h, ...) -> the JAX kernel's (b * h, ...)."""
    a = np.asarray(a)
    return jnp.asarray(a.reshape((-1,) + a.shape[2:]))


def _jax_kernel(r, k, v, logw, u, s0, interpret=True):
    b, h, q, dk = r.shape
    y, s = jkernel.wkv6_chunk(*map(_jax_bh, (r, k, v, logw)),
                              jnp.asarray(np.tile(u, (b, 1))), _jax_bh(s0),
                              interpret=interpret)
    return (np.asarray(y).reshape(b, h, q, -1), np.asarray(s).reshape(b, h, dk, -1))


def _port(r, k, v, logw, u, s0):
    y, s = ops.wkv6_chunk(*map(_torch, (r, k, v, logw, u, s0)))
    return y.numpy(), s.numpy()


def _row_rel(got, want):
    """max over rows of max|got - want| / max|want| along the last axis."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1), 1e-30)).max())


def _state_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _factored64(r, k, v, logw, u, s0):
    """The chunk form in float64 (numpy): the function both packages round."""
    r, k, v, lw, s0 = (np.asarray(a, np.float32).astype(np.float64)
                       for a in (r, k, v, logw, s0))
    q = r.shape[-2]
    cw = np.cumsum(lw, axis=-2)
    pw = cw - lw
    rp = r * np.exp(np.clip(pw, -80, 0))
    a = rp @ np.swapaxes(k * np.exp(np.clip(-cw, -80, 80)), -1, -2)
    a = np.where(np.tril(np.ones((q, q), bool), -1), a, 0.0)
    y = rp @ s0 + a @ v + np.sum(r * u.astype(np.float64)[:, None, :] * k, -1,
                                 keepdims=True) * v
    tail = np.exp(np.clip(cw[..., -1:, :] - cw, -80, 0))
    s = s0 * np.exp(np.clip(cw[..., -1, :], -80, 0))[..., None] + np.swapaxes(
        k * tail, -1, -2) @ v
    return y, s


# ---------------------------------------------------------------------------
# The exact recurrence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,dk,dv", [(32, 16, 16), (64, 64, 64), (16, 32, 64)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_exact_recurrence_matches_jax_ref(q, dk, dv, dt):
    dtype = jnp.bfloat16 if dt == "bfloat16" else np.float32
    r, k, v, logw, u, s0 = _inputs(3, 1, q, dk, dv, seed=q + dk, dtype=dtype)
    args = [a[:, 0] for a in (r, k, v, logw)]  # (bh = 3, q, d)
    ub = np.tile(u, (3, 1))
    yj, sj = jref.wkv6_chunk_batched(*map(jnp.asarray, args), jnp.asarray(ub),
                                     jnp.asarray(s0[:, 0]))
    yp, sp = ref.wkv6_chunk_batched(*map(_torch, args), _torch(ub), _torch(s0[:, 0]))
    for got, want in ((yp, yj), (sp, sj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # one head, no batch dims: the JAX ref.wkv6_chunk
    y1j, s1j = jref.wkv6_chunk(*(jnp.asarray(a[0]) for a in args), jnp.asarray(u[0]),
                               jnp.asarray(s0[0, 0]))
    y1p, s1p = ref.wkv6_chunk(*(_torch(a[0]) for a in args), _torch(u[0]), _torch(s0[0, 0]))
    np.testing.assert_allclose(y1p.numpy(), np.asarray(y1j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(y1j)).max())
    np.testing.assert_allclose(s1p.numpy(), np.asarray(s1j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(s1j)).max())


# ---------------------------------------------------------------------------
# The chunk form: the port's CPU path against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,q,dk,dv", [
    (2, 3, 32, 64, 64), (2, 3, 256, 64, 64), (1, 3, 50, 64, 64), (3, 1, 7, 64, 64),
    (3, 1, 1, 64, 64), (1, 2, 100, 16, 32),
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_chunk_form_matches_jax_kernel(b, h, q, dk, dv, dt):
    dtype = jnp.bfloat16 if dt == "bfloat16" else np.float32
    args = _inputs(b, h, q, dk, dv, seed=7 * q + b, dtype=dtype)
    yj, sj = _jax_kernel(*args)
    yp, sp = _port(*args)
    assert yp.shape == (b, h, q, dv) and sp.shape == (b, h, dk, dv)
    assert yp.dtype == np.float32 and sp.dtype == np.float32
    tol = 1e-3 if q > 64 else 2e-5
    assert _row_rel(yp, yj) <= tol and _state_rel(sp, sj) <= tol
    y64, s64 = _factored64(*args)
    assert _row_rel(yp, y64) <= 1e-4 and _state_rel(sp, s64) <= 1e-4
    assert _row_rel(yj, y64) <= 1e-3


def test_chunk_form_binds_the_clamps_at_256():
    """The draws put about a quarter of the pairs past -80 at q = 256 (the
    clamps bind) and none at q = 32."""
    logw = _inputs(2, 3, 256, 64, 64, seed=1)[3]
    cw = np.cumsum(logw.astype(np.float64), axis=2)
    assert 0.15 < float((cw < -80).mean()) < 0.4
    assert float(cw[:, :, :32].min()) > -40


def test_caveat_e_is_the_same_in_both_packages():
    """At q = 256 the chunk form departs from the exact recurrence, by the
    same amount in the JAX kernel and in the port; the JAX package's own
    ``ops.wkv6_chunk`` returns the exact recurrence off the TPU and the
    port's ``ops`` the chunk form. At q = 32 the two forms agree."""
    for q, big in ((256, True), (32, False)):
        args = _inputs(2, 3, q, 64, 64, seed=11)
        r, k, v, logw, u, s0 = args
        bh = [_jax_bh(a) for a in (r, k, v, logw)]
        ub, sb = jnp.asarray(np.tile(u, (2, 1))), _jax_bh(s0)
        ye_j = np.asarray(jref.wkv6_chunk_batched(*bh, ub, sb)[0]).reshape(2, 3, q, 64)
        ye_p = ref.wkv6_chunk(*map(_torch, args))[0].numpy()
        yk_j = _jax_kernel(*args)[0]
        yk_p = _port(*args)[0]
        gap_j = float(np.abs(yk_j - ye_j).max() / np.abs(ye_j).max())
        gap_p = float(np.abs(yk_p - ye_p).max() / np.abs(ye_p).max())
        if big:
            assert gap_j > 0.5 and gap_p > 0.5
            assert abs(gap_p - gap_j) <= 1e-3 * gap_j
            ops_j = np.asarray(jops.wkv6_chunk(*bh, ub, sb)[0]).reshape(2, 3, q, 64)
            np.testing.assert_allclose(ops_j, ye_j, rtol=1e-5, atol=1e-5 * np.abs(ye_j).max())
        else:
            assert gap_j <= 2e-5 and gap_p <= 2e-5


# ---------------------------------------------------------------------------
# The CUDA kernel's 3xTF32 split, emulated on the CPU
# ---------------------------------------------------------------------------

_TILE = 64


def _tf32_parts(x):
    """hi + lo of f32 ``x``, each truncated to TF32 (10 mantissa bits), as
    the kernel's ``split_tf32``; a part below f32's normal range is flushed
    to zero, the worst the tensor cores may do."""
    keep = -8192  # 0xffffe000: sign, exponent and the top 10 mantissa bits
    hi = (x.view(torch.int32) & keep).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & keep).view(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return tuple(torch.where(p.abs() < tiny, torch.zeros_like(p), p) for p in (hi, lo))


def _mm3(a, b):
    """a @ b as three TF32 products (lo*hi + hi*lo + hi*hi); the products of
    TF32 parts are exact in f64, summed there and rounded to f32 once."""
    (ah, al), (bh, bl) = _tf32_parts(a), _tf32_parts(b)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d) + ah.to(d) @ bh.to(d)).float()


def _kernel_form(r, k, v, logw, u, s0, scale):
    """The CUDA kernel's decomposition in f32 with every product split as
    above: 64-row tiles in order, y = R~ M_j + tril(R~ K~^T) V + bonus with
    M_j = S_in + the earlier tiles' K~^T V, S_out = decayed S_in + the
    tiles' K^^T V; R~ and K^ scaled by 2^58 and K~, M by 2^-58 when
    ``scale``."""
    up, down = (2.0 ** 58, 2.0 ** -58) if scale else (1.0, 1.0)
    r, k, v, lw, s0 = (torch.from_numpy(np.asarray(a, np.float32)) for a in (r, k, v, logw, s0))
    u = torch.from_numpy(u)
    q = r.shape[-2]
    cw = torch.cumsum(lw.double(), -2).float()
    rt = r * (torch.exp(torch.clamp(cw - lw, -80, 0)) * up)
    kt = k * (torch.exp(torch.clamp(-cw, -80, 80)) * down)
    kh = k * (torch.exp(torch.clamp(cw[..., -1:, :] - cw, -80, 0)) * up)
    m = s0 * down
    acc = torch.zeros_like(s0)
    ys = []
    for t0 in range(0, q, _TILE):
        tile = slice(t0, t0 + _TILE)
        n = min(_TILE, q - t0)
        below = torch.ones((n, n), dtype=torch.bool).tril(-1)
        a = torch.where(below, _mm3(rt[..., tile, :], kt[..., tile, :].transpose(-1, -2)), 0.0)
        ys.append(_mm3(rt[..., tile, :], m) + _mm3(a, v[..., tile, :]))
        m = m + _mm3(kt[..., tile, :].transpose(-1, -2), v[..., tile, :])
        acc = acc + _mm3(kh[..., tile, :].transpose(-1, -2), v[..., tile, :])
    y = torch.cat(ys, -2) + torch.sum(r * u[:, None, :] * k, -1, keepdim=True) * v
    s_out = s0 * torch.exp(torch.clamp(cw[..., -1, :], -80, 0))[..., None] + acc / up
    return y.numpy(), s_out.numpy()


def test_tf32_split_needs_the_rescale():
    """B * H = 4, q = 256, the model's decay law, bf16 r/k/v as on the main
    path: with the 2^+-58 rescale, the kernel's split products stay within
    2e-4 row-relative of the chunk form in float64 (y and S_out); without
    it, R~ near 2^-115 loses its lo part (or more) to the flush. The
    unscaled error is printed, not held."""
    args = _inputs(2, 2, 256, 64, 64, seed=21, dtype=jnp.bfloat16)
    y64, s64 = _factored64(*args)
    y, s = _kernel_form(*args, scale=True)
    assert _row_rel(y, y64) <= 2e-4 and _state_rel(s, s64) <= 2e-4
    y_raw, s_raw = _kernel_form(*args, scale=False)
    print(f"3xTF32 with flushed subnormal parts, row-relative error of y against float64: "
          f"{_row_rel(y, y64):.2e} rescaled, {_row_rel(y_raw, y64):.2e} unscaled "
          f"(S_out {_state_rel(s, s64):.2e}, {_state_rel(s_raw, s64):.2e})")


# ---------------------------------------------------------------------------
# The wrapper: strided views, out, launches, refusals
# ---------------------------------------------------------------------------


def test_reads_the_models_layout_and_writes_out():
    """(B, S, H, 64) projections at a chunk offset, as strided views, with y
    written into a (B, S, H, 64) buffer: the same numbers as contiguous
    copies; S_out is a new tensor."""
    b, s, h, q = 2, 96, 3, 32
    rng = np.random.default_rng(5)
    x = {n: torch.from_numpy(rng.standard_normal((b, s, h, 64)).astype(np.float32))
         for n in ("r", "k", "v")}
    x["logw"] = -torch.exp(torch.from_numpy(rng.normal(-1, 0.6, (b, s, h, 64)).astype(np.float32)))
    u = torch.from_numpy(rng.standard_normal((h, 64)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, 64, 64)).astype(np.float32))
    y = torch.full((b, s, h, 64), float("nan"))
    c = 32
    views = [x[n][:, c:c + q].transpose(1, 2) for n in ("r", "k", "v", "logw")]
    assert not views[0].is_contiguous()
    got_y, got_s = ops.wkv6_chunk(*views, u, s0, out=y[:, c:c + q].transpose(1, 2))
    want_y, want_s = ops.wkv6_chunk(*(t.contiguous() for t in views), u, s0)
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)
    assert torch.equal(y[:, c:c + q].transpose(1, 2), want_y)
    assert torch.isnan(y[:, :c]).all() and torch.isnan(y[:, c + q:]).all()
    assert got_s.data_ptr() != s0.data_ptr()


def test_cpu_path_launches_nothing():
    kernels.reset_launches()
    _port(*_inputs(1, 2, 64, 64, 64, seed=3))
    assert ops.wkv6_chunk.launches == 0
    assert kernels.launches()["wkv6_chunk"] == 0
    assert kernels.WRAPPERS["wkv6_chunk"] is ops.wkv6_chunk


def test_refusals():
    r, k, v, logw, u, s0 = map(_torch, _inputs(1, 2, 8, 64, 64, seed=4))
    ok = dict(r=r, k=k, v=v, logw=logw, u=u, s0=s0)

    def call(**kw):
        return ops.wkv6_chunk(**dict(ok, **kw))

    call()
    with pytest.raises(ValueError, match="4-D"):
        call(r=r[0])
    with pytest.raises(TypeError, match="one dtype"):
        call(k=k.to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        call(v=v.double())
    with pytest.raises(ValueError, match="one shape"):
        call(logw=logw[:, :, :4])
    with pytest.raises(ValueError, match="contiguous"):
        call(r=r.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="dk, dv <= 64"):
        wide = torch.zeros(1, 2, 8, 65)
        ops.wkv6_chunk(wide, wide, v, wide, torch.zeros(2, 65), torch.zeros(1, 2, 65, 64))
    with pytest.raises(ValueError, match="u has shape"):
        call(u=u[:1])
    with pytest.raises(TypeError, match="s0 must be float32"):
        call(s0=s0.to(torch.bfloat16))
    with pytest.raises(ValueError, match="out must be float32"):
        call(out=torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel"):
        ops.wkv6_chunk(*(t.to("meta") for t in (r, k, v, logw, u, s0)))
