"""Public wrapper of one RWKV-6 (WKV6) chunk.

``wkv6_chunk(r, k, v, logw, u, s0)`` takes r, k, logw (B, H, q, dk) and v
(B, H, q, dv), r/k/v bf16 or f32 (one dtype), logw f32 or bf16, the bonus u
(H, dk) f32, broadcast over the batch, and the state s0 (B, H, dk, dv) f32,
and returns (y (B, H, q, dv) f32, S_out (B, H, dk, dv) f32). It computes the
TPU kernel's chunk form (``ref.wkv6_chunk_factored``: masked intra-chunk
products with the kernel's five clamps), which is what the JAX package
computes on its TPU and in its model. It deliberately differs from the JAX
``ops.wkv6_chunk`` off the TPU, which returns the exact recurrence
(``ref.wkv6_chunk``): the two part once a channel's in-chunk cumulative log
decay passes -80 (ROADMAP, reference caveat (e)).

Tensors on the CPU take the plain version; CUDA tensors launch the
hand-written kernel (``csrc/wkv6_chunk.cu``) or raise. The kernel reads r, k,
v and logw through their batch, head and token strides, so the model's
``(B, S, H, 64)`` projections go in at a chunk offset as
``x[:, c:c + q].transpose(1, 2)`` without a copy; ``out`` (a (B, H, q, dv)
f32 view, last dimension contiguous) receives y in place, so y can land in
the model's (B, S, H, 64) buffer. A head slice ``t[:, h0:h1]`` of such a
view (a model shard's heads, ``models.rwkv6`` under a mesh) goes in through
its strides too, not copied; u and s0 are dense (a shard's own). dk and dv
are at most 64.
``wkv6_chunk.launches`` counts the kernel launches.

The kernel is a forward only: a CUDA input that requires grad under grad
mode is refused (``_checks.forward_only``); ``models.rwkv6.time_mix`` takes
the plain chunk form then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _checks
from .._count import launched
from . import kernel, ref

DTYPES = (torch.bfloat16, torch.float32)
MAX_DIM = kernel.MAX_DIM


def _check(r, k, v, logw, u, s0, out) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D tensor (B, H, q, d)")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be bfloat16 or float32, got {t.dtype}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous (stride 1)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}: one dtype for r, k and v")
    b, h, q, dk = r.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (b, h, q, dk) or tuple(logw.shape) != (b, h, q, dk):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)} and logw "
                         f"{tuple(logw.shape)} must have one shape")
    if tuple(v.shape[:3]) != (b, h, q):
        raise ValueError(f"v {tuple(v.shape)} and r {tuple(r.shape)} differ in (B, H, q)")
    if q < 1 or not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"need q >= 1 and 1 <= dk, dv <= {MAX_DIM}; got q {q}, dk {dk}, "
                         f"dv {dv}")
    _checks.dense_f32(u, "u", (h, dk))
    _checks.dense_f32(s0, "s0", (b, h, dk, dv))
    tensors = dict(k=k, v=v, logw=logw, u=u, s0=s0)
    if out is not None:
        if out.dtype != torch.float32 or tuple(out.shape) != (b, h, q, dv):
            raise ValueError(f"out must be float32 of shape {(b, h, q, dv)}")
        if dv > 1 and out.stride(-1) != 1:
            raise ValueError("out's last dimension must be contiguous (stride 1)")
        tensors["out"] = out
    _checks.same_device(r.device, **tensors)


def wkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk -> (y (B, H, q, dv) f32, S_out (B, H, dk, dv) f32); y is
    ``out`` when given. S_out is a new tensor (never s0)."""
    _check(r, k, v, logw, u, s0, out)
    _checks.forward_only("wkv6_chunk", r, k, v, logw, u, s0)
    if not _checks.kernel_device(r.device, "wkv6_chunk"):
        y, s_out = ref.wkv6_chunk_factored(r, k, v, logw, u, s0)
        if out is None:
            return y, s_out
        out.copy_(y)
        return out, s_out
    b, h, q, _ = r.shape
    dv = v.shape[-1]
    y = torch.empty((b, h, q, dv), dtype=torch.float32, device=r.device) if out is None else out
    s_out = torch.empty_like(s0)
    kernel.wkv6_chunk(r, k, v, logw, u, s0, y, s_out)
    launched(wkv6_chunk, y)
    return y, s_out


wkv6_chunk.launches = 0
