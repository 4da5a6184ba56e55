"""Shared transformer layers of the LM zoo: norms, RoPE and M-RoPE, GQA
attention, MLPs. The port's counterpart of ``repro.models.layers``.

Functions take parameter dicts of tensors, in the reference's layout
(weights ``(in, out)``, used as ``x @ w``). The reference's sharding
annotations are no-ops on one device and are dropped; the sequence-sharded
decode (multi-device) is not ported yet.

Attention under autograd: the hand-written flash kernel is a forward only,
as the reference's Pallas kernel is (``jax.grad`` through that kernel fails,
and the reference's training runs the plain XLA paths). So when autograd
records through q, k or v (grad mode on and one of them requires grad),
``attention`` takes the reference's training path on the card too: the
chunked path past ``chunk`` when the length divides, else the dense one,
both differentiable. This is a choice between two exact computations made
by what the caller asks for, not a fallback: without a gradient (prefill,
``extract_features``, serving) a multi-token call launches the kernel, and
the kernel's wrapper refuses a CUDA input that requires grad.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import ops as attn_ops
from ..kernels.flash_attention import ref as attn_ref

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-i / half) for i < half, in f32."""
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a fill, not a copy from the host: capturable into a CUDA graph
    return torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(B, S, head_dim/2) rotation angles for integer positions (B, S)."""
    return positions[..., None].float() * _inv_freq(head_dim // 2, theta, positions.device)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: (B, S, head_dim/2) angles from (B, 3, S) integer
    (temporal, height, width) positions. The half-dim frequency slots are
    split into ``sections`` in order, each rotating by its own position
    stream. The sections come from the config's tuple as slices, so no
    index tensor is copied from the host and the angles are capturable
    into a CUDA graph; each angle is the reference's one product."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim / 2 = {half}")
    inv_freq = _inv_freq(half, theta, positions.device)
    pos = positions.float()
    parts, lo = [], 0
    for stream, n in enumerate(sections):
        parts.append(pos[:, stream, :, None] * inv_freq[lo:lo + n])
        lo += n
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, Dh); angles: (B, S, Dh/2). Split-half rotation; cos and
    sin are cast to x's dtype before the products, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, None].to(x.dtype)
    sin = torch.sin(angles)[:, None].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA). Three execution paths:
#   flash   — the CUDA kernel: every multi-token, offset-0 call on the card
#             that records no gradient
#   chunked — a loop over q chunks, O(chunk * S) live scores (long sequences
#             off the card, or under autograd)
#   dense   — everything else: short sequences, decode against a cache
# ---------------------------------------------------------------------------


def _expand_heads(kv: torch.Tensor, hq: int) -> torch.Tensor:
    """Repeat each KV head hq / Hkv times along the head axis (as
    ``repeat_interleave`` does; an expanded view copied, whose gradient is a
    sum over the group rather than ``repeat_interleave``'s accumulating
    index on the card)."""
    b, hkv, s, dh = kv.shape
    if hkv != hq:
        kv = kv[:, :, None].expand(b, hkv, hq // hkv, s, dh).reshape(b, hq, s, dh)
    return kv


def records_grad(*trees) -> bool:
    """Does autograd record through an op reading these tensors (or dicts
    of them)? Grad mode on, and one of them requires grad."""
    def any_requires(tree) -> bool:
        if isinstance(tree, dict):
            return any(any_requires(t) for t in tree.values())
        return tree.requires_grad
    return torch.is_grad_enabled() and any(any_requires(t) for t in trees)


def _dense_attention(q, k, v, *, scale, causal, q_offset=0):
    hq = q.shape[1]
    return attn_ref.attention(
        q, _expand_heads(k, hq), _expand_heads(v, hq),
        scale=scale, causal=causal, q_offset=q_offset,
    )


def _chunked_attention(q, k, v, *, scale, causal, chunk: int):
    """Query chunks in turn; each sees the full K/V with masking. Live
    scores: O(B * H * chunk * S). Under autograd each chunk is checkpointed
    (non-reentrant), as the reference's scan body is rematerialized."""
    s = q.shape[2]
    k = _expand_heads(k, q.shape[1])
    v = _expand_heads(v, q.shape[1])
    remat = records_grad(q, k, v)

    def one(i):
        fn = partial(attn_ref.attention, scale=scale, causal=causal, q_offset=i)
        qi = q[:, :, i:i + chunk]
        return checkpoint(fn, qi, k, v, use_reentrant=False) if remat else fn(qi, k, v)

    return torch.cat([one(i) for i in range(0, s, chunk)], dim=2)


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, Dh)
    k: torch.Tensor,  # (B, Hkv, Skv, Dh)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool,
    q_offset: int = 0,
    chunk: int = 2048,
) -> torch.Tensor:
    """Dispatch, as the reference's: the flash kernel for a multi-token
    offset-0 call on the accelerator (here: a CUDA tensor) that records no
    gradient, else the chunked path for long sequences that split evenly,
    else dense (the reference's training path; module doc)."""
    sq = q.shape[2]
    if q.device.type == "cuda" and sq > 1 and q_offset == 0 and not records_grad(q, k, v):
        return attn_ops.flash_attention(q, k, v, scale=scale, causal=causal)
    if sq > chunk and sq % chunk == 0 and q_offset == 0:
        return _chunked_attention(q, k, v, scale=scale, causal=causal, chunk=chunk)
    return _dense_attention(q, k, v, scale=scale, causal=causal, q_offset=q_offset)


# ---------------------------------------------------------------------------
# Attention block (QKV proj + rope + attention + out proj)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) draws from ``gen`` (parameter init)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype, device) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    std = d**-0.5
    p = {
        "wq": normal(gen, (d, hq * dh), dtype, device) * std,
        "wk": normal(gen, (d, hkv * dh), dtype, device) * std,
        "wv": normal(gen, (d, hkv * dh), dtype, device) * std,
        "wo": normal(gen, (hq * dh, d), dtype, device) * std,
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w
    return y if bias is None else y + bias


def attention_block(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg,
    *,
    angles: Optional[torch.Tensor],  # rope angles for the current positions
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k, v): (B, Hkv, Smax, Dh)
    cache_pos: Optional[torch.Tensor] = None,  # 0-d int on the device: the write offset
    return_kv: bool = False,  # prefill: emit this layer's (k, v) as the cache
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Without a cache: attention over x's own positions. With a cache and
    one token: the token's k and v are written into the cache IN PLACE at
    ``cache_pos`` (the reference's ``dynamic_update_slice`` returns an
    updated copy), and the token attends to the whole cache masked at
    ``q_offset=cache_pos``, i.e. to positions 0..cache_pos. The position
    stays on the device (``index_copy_`` at it, the mask compares against
    it), so nothing here waits for the card."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    q = _proj(x, p["wq"], p.get("bq"))
    kk = _proj(x, p["wk"], p.get("bk"))
    vv = _proj(x, p["wv"], p.get("bv"))
    # head-major views; the flash kernel reads them through their strides
    q = q.reshape(b, s, hq, dh).transpose(1, 2)
    kk = kk.reshape(b, s, hkv, dh).transpose(1, 2)
    vv = vv.reshape(b, s, hkv, dh).transpose(1, 2)

    if angles is not None:
        q = apply_rope(q, angles)
        kk = apply_rope(kk, angles)

    scale = dh**-0.5
    new_cache = None
    if cache is None:
        out = attention(q, kk, vv, scale=scale, causal=cfg.causal, chunk=cfg.seq_chunk)
        if return_kv:
            new_cache = (kk, vv)
    elif s > 1:
        raise NotImplementedError("chunked prefill-into-cache not needed here")
    else:
        ck, cv = cache
        pos = torch.as_tensor(cache_pos, device=ck.device)
        at = pos.to(torch.int64).reshape(1)
        ck.index_copy_(2, at, kk.to(ck.dtype))
        cv.index_copy_(2, at, vv.to(cv.dtype))
        new_cache = (ck, cv)
        out = _dense_attention(q, ck, cv, scale=scale, causal=True, q_offset=pos)

    out = out.transpose(1, 2).reshape(b, s, hq * dh)
    return out @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, kind: str, dtype: torch.dtype,
             device) -> Params:
    std = d**-0.5
    if kind == "swiglu":
        return {
            "wg": normal(gen, (d, f), dtype, device) * std,
            "wu": normal(gen, (d, f), dtype, device) * std,
            "wd": normal(gen, (f, d), dtype, device) * (f**-0.5),
        }
    return {  # gelu
        "w1": normal(gen, (d, f), dtype, device) * std,
        "w2": normal(gen, (f, d), dtype, device) * (f**-0.5),
    }


def mlp_block(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """SwiGLU, or GELU with the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if kind == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]
