"""Plain PyTorch versions of one RWKV-6 (WKV6) chunk, in f32.

Two functions of the same inputs (r, k, logw (..., q, dk); v (..., q, dv);
u (..., dk), broadcast over the leading dims of r; S_in (..., dk, dv)),
both returning (y (..., q, dv), S_out (..., dk, dv)) in f32:

* ``wkv6_chunk`` / ``wkv6_chunk_batched``: the exact per-token recurrence,
  the JAX package's ``kernels/wkv6_chunk/ref.py``:

      y_t = r_t @ (S_{t-1} + diag(u) k_t (x) v_t)
      S_t = diag(exp(logw_t)) S_{t-1} + k_t (x) v_t

* ``wkv6_chunk_factored``: the chunk form that the TPU kernel
  (``kernels/wkv6_chunk/kernel.py`` ``_wkv6_kernel``) and the model's own
  chunk scan (``models/rwkv6.time_mix``) compute, op for op, with the
  kernel's five clamps. Its intra-chunk pair weight exp(pw_t - cw_s) is
  taken as exp(clip(pw_t, -80, 0)) * exp(clip(-cw_s, -80, 80)); once a
  channel's in-chunk cumulative log decay passes -80, both factors saturate
  and the pair's weight becomes 1 instead of exp(pw_t - cw_s) (ROADMAP,
  reference caveat (e)). This is the plain version of the port's CUDA
  kernel: the CPU path, the tests and the on-card checks hold the kernel
  to it.
"""
from __future__ import annotations

from typing import Tuple

import torch

CLAMP = 80.0


def wkv6_chunk(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence, token by token; any leading dims (a single
    (q, dk) head as in the JAX ``ref.wkv6_chunk``, or a batch of them)."""
    r, k, v, logw, u, s = (t.float() for t in (r, k, v, logw, u, s0))
    ys = []
    for t in range(r.shape[-2]):
        kv = k[..., t, :, None] * v[..., t, None, :]
        ys.append((r[..., t, None, :] @ (s + u[..., :, None] * kv))[..., 0, :])
        s = s * torch.exp(logw[..., t, :])[..., None] + kv
    y = torch.stack(ys, dim=-2) if ys else v.new_zeros(v.shape)
    return y, s


# (BH, q, d*) with u (BH, dk): the JAX ``ref.wkv6_chunk_batched``
wkv6_chunk_batched = wkv6_chunk


def wkv6_chunk_factored(r, k, v, logw, u, s0, *,
                        dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's chunk form, op for op (clamps at kernel.py:36, 40,
    41, 53, 54), computed in ``dtype`` (f32, as the TPU kernel; the on-card
    check also takes it in f64 as the kernel's yardstick)."""
    r, k, v, lw, u, s0 = (t.to(dtype) for t in (r, k, v, logw, u, s0))
    q = r.shape[-2]
    cw = torch.cumsum(lw, dim=-2)  # inclusive prefix
    pw = cw - lw  # exclusive prefix
    rp = r * torch.exp(torch.clamp(pw, -CLAMP, 0.0))
    y = rp @ s0  # inter-chunk
    a = rp @ (k * torch.exp(torch.clamp(-cw, -CLAMP, CLAMP))).transpose(-1, -2)
    below = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)
    a = torch.where(below, a, a.new_zeros(()))
    y = y + a @ v  # intra-chunk, strictly lower triangular
    diag = torch.sum(r * u[..., None, :] * k, dim=-1, keepdim=True)
    y = y + diag * v  # diagonal bonus
    tail = torch.exp(torch.clamp(cw[..., -1:, :] - cw, -CLAMP, 0.0))
    s_out = s0 * torch.exp(torch.clamp(cw[..., -1, :], -CLAMP, 0.0))[..., None] + (
        (k * tail).transpose(-1, -2) @ v)
    return y, s_out
