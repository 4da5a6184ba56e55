"""The plain PyTorch version of GQA attention.

``attention`` is the reference's ``ref.attention`` op for op: the two
products run in the storage dtype with f32 accumulation, masked scores are
-1e30, softmax runs in f32 and ``p`` is cast to v's dtype before P.V, so a
bf16 ``p`` is rounded (the kernel keeps it in f32; see ``csrc``).
"""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation, operands in their storage dtype (on the
    CPU a bf16 product is taken in f32 and rounded; upcasting first gives
    the f32-accumulated value the reference's ``preferred_element_type``
    asks for)."""
    if a.dtype == torch.float32:
        return a @ b
    return a.float() @ b.float()


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, Dh)
    k: torch.Tensor,  # (B, Hkv, Skv, Dh)
    v: torch.Tensor,  # (B, Hkv, Skv, Dh)
    *,
    scale: float,
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Dense softmax attention with GQA head-group broadcast, f32 softmax.

    ``q_offset`` positions the query block within the kv timeline (decode:
    q_offset = kv_len - sq); an int, or a 0-d integer tensor on q's device
    (decode's position, never read back to the host)."""
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, dh)
    s = _matmul_f32(qg, k[:, :, None].transpose(-1, -2))  # (b, hkv, g, sq, skv)
    s = s * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = _matmul_f32(p.to(v.dtype), v[:, :, None])
    return out.reshape(b, hq, sq, dh).to(q.dtype)

