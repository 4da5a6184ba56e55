"""Public wrapper of GQA flash attention (forward).

``flash_attention(q, k, v, scale=..., causal=..., q_offset=0)`` takes the
reference's public layout, q (B, Hq, Sq, Dh) and k, v (B, Hkv, Skv, Dh),
bf16 or f32, one dtype for all three, Hq % Hkv == 0, Dh <= 128, and returns
(B, Hq, Sq, Dh) in q's dtype. The causal mask is top-left aligned (query i
sees kv positions <= i, also when Sq != Skv), as in the TPU kernel, or, with
``q_offset``, sees positions <= q_offset + i: q holds a sequence shard's rows
[q_offset, q_offset + Sq) and k, v the whole sequence's (0 <= q_offset,
and q_offset + Sq <= Skv where it is not 0; the plain version is
``ref.attention(..., q_offset=)``). An offset off the kernels' 128-row tiles puts the diagonal
inside a tile.

Tensors on the CPU take the plain version (``ref.attention``); CUDA tensors
launch one of the two hand-written kernels of ``csrc/flash_attention.cu``
or raise: the wgmma kernel for bf16 with Dh 64 or 128 and strides TMA can
describe (``kernel.wgmma_route``), the generic kernel for the rest (f32,
other head dims). The kernels read q, k and v through their batch, head and
sequence strides, so the head-major view ``x.reshape(b, s, h,
dh).transpose(1, 2)`` goes in without a copy, and so does a head slice
``x[:, h0:h1]`` of it (a model shard's kv heads under a mesh,
``models.layers``); the last dimension must be contiguous (stride 1). Ragged Sq and Skv are masked in the kernel; nothing
is padded. ``flash_attention.launches`` counts the kernel launches, and
``flash_attention.route_launches`` splits them by route ("wgmma",
"generic").

The kernel is a forward only: a CUDA input that requires grad under grad
mode is refused (``_checks.forward_only``), so no caller can lose a
gradient without being told; ``models.layers.attention`` takes its
differentiable path then.
"""
from __future__ import annotations

import torch

from .. import _checks
from .._count import launched
from . import kernel, ref

DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int = 0) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D tensor (B, H, S, Dh)")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be bfloat16 or float32, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}: one dtype for all three")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous (stride 1)")
    b, hq, _, dh = q.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    bk, hkv, _, dk = k.shape
    if bk != b or dk != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or Dh")
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} is outside 1..{MAX_HEAD_DIM}")
    if isinstance(q_offset, bool) or not isinstance(q_offset, int):
        raise TypeError(f"q_offset must be an int, got {type(q_offset).__name__}")
    if q_offset < 0 or (q_offset and q_offset + q.shape[2] > k.shape[2]):
        raise ValueError(f"q_offset {q_offset} with Sq = {q.shape[2]} does not fit in Skv = "
                         f"{k.shape[2]} (0 <= q_offset, and q_offset + Sq <= Skv for an "
                         "offset; at 0 any Sq, top-left aligned)")
    _checks.same_device(q.device, k=k, v=v)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """softmax(Q K^T * scale [causal mask at q_offset]) V with GQA -> (B, Hq,
    Sq, Dh)."""
    _check(q, k, v, q_offset)
    _checks.forward_only("flash_attention", q, k, v)
    if not _checks.kernel_device(q.device, "flash_attention"):
        return ref.attention(q, k, v, scale=scale, causal=causal, q_offset=q_offset)
    b, hq, sq, dh = q.shape
    out = torch.empty((b, hq, sq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    route = "wgmma" if kernel.wgmma_route(q, k, v) else "generic"
    launch = kernel.flash_attention_wgmma if route == "wgmma" else kernel.flash_attention
    launch(q, k, v, out, scale=float(scale), causal=bool(causal), q_offset=q_offset)
    launched(flash_attention, out, route)
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "generic": 0}
