"""Shared transformer layers of the LM zoo: norms, RoPE and M-RoPE, GQA
attention, MLPs. The port's counterpart of ``repro.models.layers``.

Functions take parameter dicts of tensors, in the reference's layout
(weights ``(in, out)``, used as ``x @ w``). Under a mesh (``launch.sharding
.use_mesh``; ``models.parallel``) each worker holds its blocks, and the
reference's layout annotations become explicit collectives
(``comm.spmd``): the q/k/v and gate/up projections are column-parallel (the
FSDP dim gathered over the data axes, then this model shard's heads or MLP
columns), the out and down projections row-parallel (the local product,
then ``psum`` over the model axis). Where the model axis does not divide
the kv heads, every shard computes all kv heads (the weight's columns
gathered) and its q heads read theirs; where it does not divide the q
heads, every shard attends over all heads and keeps its block of the out
projection's rows. The flash and WKV6 kernels run on a shard's heads as
strided views of its projections, as on one device. At batch 1 the decode
cache may be split on its sequence dim (:func:`decode_attention_seq_sharded`).
Under a sequence split (the "sp" and "msp" profiles, ``models.parallel``)
x holds this worker's rows of the sequence: "msp" gathers them before the
column-parallel products and reduce-scatters the row-parallel output back
onto them; "sp" projects its own rows with every head, gathers K and V over
the sequence, and attends with the causal mask at its rows' offset
(``q_offset``), which the flash kernel takes too.
Each layer has one body: without a mesh, or on a mesh of one worker, the
view is the trivial ``parallel.Par``, whose collectives are identities and
whose blocks are the whole leaves, so the same ops give the unsharded bits.

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

from ..comm import spmd
from ..kernels.flash_attention import ops as attn_ops
from ..kernels.flash_attention import ref as attn_ref
from ..launch import sharding
from . import parallel

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
#   flash   — the CUDA kernel: every multi-token call on the card that
#             records no gradient (a sequence shard's at its offset)
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


def _chunked_attention(q, k, v, *, scale, causal, chunk: int, q_offset: int = 0):
    """Query chunks in turn; each sees the full K/V with masking (query
    row i at position ``q_offset`` + i). Live scores: O(B * H * chunk * S).
    Under autograd each chunk is checkpointed (non-reentrant), as the
    reference's scan body is rematerialized."""
    s = q.shape[2]
    k = _expand_heads(k, q.shape[1])
    v = _expand_heads(v, q.shape[1])
    remat = records_grad(q, k, v)

    def one(i):
        fn = partial(attn_ref.attention, scale=scale, causal=causal, q_offset=q_offset + i)
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
    call on the accelerator (here: a CUDA tensor) that records no gradient,
    else the chunked path for long sequences that split evenly, else dense
    (the reference's training path; module doc). ``q_offset``: the position
    of q's first row, an int for a multi-token call (a sequence shard's
    rows, ``attention_block``: the reference sees the whole sequence and
    never meets one), an int or a 0-d device tensor for a decode step."""
    sq = q.shape[2]
    if q.device.type == "cuda" and sq > 1 and not records_grad(q, k, v):
        return attn_ops.flash_attention(q, k, v, scale=scale, causal=causal, q_offset=q_offset)
    if sq > chunk and sq % chunk == 0:
        return _chunked_attention(q, k, v, scale=scale, causal=causal, chunk=chunk,
                                  q_offset=q_offset)
    return _dense_attention(q, k, v, scale=scale, causal=causal, q_offset=q_offset)


def decode_attention_seq_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 scale: float, cache_pos, mesh, axes=None) -> torch.Tensor:
    """Flash-decode against a cache split on its sequence dim: q (B, Hq, 1,
    Dh) the same on every shard, k and v (B, Hkv, S_loc, Dh) this shard's
    positions [i S_loc, (i + 1) S_loc), i its index over ``axes`` (default:
    the "seq" axes), ``cache_pos`` the number of valid positions (0-d). Each
    shard takes a partial softmax (m, l, acc) over its valid positions in
    f32; the combine is one ``pmax`` and two ``psum`` of O(B Hq Dh) over the
    shards, never an S-length gather. Returns (B, Hq, 1, Dh) in q's dtype,
    the same on every shard."""
    axes = sharding.seq_axes() if axes is None else tuple(axes)
    group, idx = mesh.group_of(axes), mesh.index(axes)
    return _flash_decode(q, k, v, scale=scale, cache_pos=cache_pos, group=group, index=idx)


def _flash_decode(q, k, v, *, scale, cache_pos, group, index):
    s_loc, hq = k.shape[2], q.shape[1]
    kpos = index * s_loc + torch.arange(s_loc, device=k.device)
    sres = (q.float() @ _expand_heads(k, hq).float().transpose(-1, -2)) * scale
    sres = torch.where(kpos < torch.as_tensor(cache_pos, device=k.device), sres,
                       torch.full((), -1e30, device=k.device))
    m = sres.amax(dim=-1, keepdim=True)
    p = torch.exp(sres - m)
    lsum = p.sum(dim=-1, keepdim=True)
    acc = p @ _expand_heads(v, hq).float()
    m_g = spmd.pmax(m, group)
    corr = torch.exp(m - m_g)
    l_g = spmd.psum(lsum * corr, group)
    acc_g = spmd.psum(acc * corr, group)
    return (acc_g / torch.clamp_min(l_g, 1e-30)).to(q.dtype)


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


def attention_block(
    p: Params,
    x: torch.Tensor,  # (B, S, D): this worker's rows, the same on every model shard
    cfg,
    *,
    angles: Optional[torch.Tensor],  # rope angles for the current positions
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k, v): (B, Hkv, Smax, Dh)
    cache_pos: Optional[torch.Tensor] = None,  # 0-d int on the device: the write offset
    return_kv: bool = False,  # prefill: emit this layer's (k, v) as the cache
    cache_split: Tuple[str, ...] = (),  # mesh axes splitting the cache's sequence dim
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Without a cache: attention over x's own positions. With a cache and
    one token: the token's k and v are written into the cache IN PLACE at
    ``cache_pos`` (the reference's ``dynamic_update_slice`` returns an
    updated copy), and the token attends to the whole cache masked at
    ``q_offset=cache_pos``, i.e. to positions 0..cache_pos. The position
    stays on the device (``index_copy_`` at it, the mask compares against
    it), so nothing here waits for the card.

    On a worker's blocks (module doc; without a mesh the trivial
    ``parallel.Par``, whose blocks are the leaves): every model-replicated
    input enters through ``spmd.copy`` or ``Par.cols``, so each input's
    gradient is summed over the model shards, and the result is the
    row-parallel product's ``psum``. Under a sequence split x holds this
    worker's rows and so does the result (module doc; ``Par.enter``,
    ``Par.leave``): under "sp" ``angles`` cover the whole sequence and the
    rows' are taken here. A prefill's (k, v) are the shard's kv heads
    (``head_ranges``), all positions. A decode cache split on its
    sequence dim over the mesh axes ``cache_split`` (as
    ``launch.steps.cache_pspecs`` lays it out) holds this worker's
    positions, and the shards' partial softmaxes are combined."""
    par = parallel.current()
    b, s, d = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    g = hq // hkv
    q0, q1, k0, k1 = head_ranges(cfg, par)
    xc = par.enter(x)
    # "sp": this worker's rows as queries against the whole sequence's keys
    own_rows = cache is None and par.seq is not None and par.tp is None
    if own_rows and angles is not None:
        angles = par.rows(angles)
    s = xc.shape[1]

    def proj(wname, bname, full, lo, hi):
        w = par.cols(par.fsdp(p[wname], 0, d), 1, full * dh, lo * dh, hi * dh)
        y = xc @ w
        if bname in p:
            y = y + par.cols(p[bname], 0, full * dh, lo * dh, hi * dh)
        # head-major views; the flash kernel reads them through their strides
        return y.reshape(b, s, hi - lo, dh).transpose(1, 2)

    q = proj("wq", "bq", hq, q0, q1)
    kk = proj("wk", "bk", hkv, k0, k1)
    vv = proj("wv", "bv", hkv, k0, k1)
    if angles is not None:
        q = apply_rope(q, angles)
        kk = apply_rope(kk, angles)
    q_offset = 0
    if own_rows:
        kk, vv = spmd.gather(kk, 2, par.seq), spmd.gather(vv, 2, par.seq)
        q_offset = par.s_index * s

    def for_q(t):  # the kv heads of the q heads [q0, q1), from those held
        a0, a1 = q0 // g, (q1 - 1) // g + 1
        return t if (a0, a1) == (k0, k1) else t[:, a0 - k0:a1 - k0]

    scale = dh**-0.5
    new_cache = None
    if cache is None:
        out = attention(q, for_q(kk), for_q(vv), scale=scale, causal=cfg.causal,
                        q_offset=q_offset, chunk=cfg.seq_chunk)
        if return_kv:
            new_cache = (kk, vv)
    elif s > 1:
        raise NotImplementedError("chunked prefill-into-cache not needed here")
    else:
        ck, cv = cache
        pos = torch.as_tensor(cache_pos, device=ck.device)
        group, _, index = par.split(cache_split)
        _write_at(ck, kk, pos, group, index)
        _write_at(cv, vv, pos, group, index)
        new_cache = (ck, cv)
        if group is None:
            out = _dense_attention(q, for_q(ck), for_q(cv), scale=scale, causal=True,
                                   q_offset=pos)
        else:
            if set(cache_split) & set(sharding.model_axes()) and (q0, q1) != (0, hq):
                # split over the model axis (the cache holds every kv head):
                # all q heads on every shard, against its positions
                q, q0, q1 = par.tp.all_gather(q, 1), 0, hq
            out = _flash_decode(q, for_q(ck), for_q(cv), scale=scale, cache_pos=pos + 1,
                                group=group, index=index)

    out = out.transpose(1, 2).reshape(b, s, -1)
    r0, r1 = par.model_block(hq * dh)
    if (r0, r1) != (q0 * dh, q1 * dh):
        out = out[..., r0 - q0 * dh:r1 - q0 * dh]
    wo = par.cols(par.fsdp(p["wo"], 1, d), 0, hq * dh, r0, r1)
    return par.leave(out @ wo), new_cache


def head_ranges(cfg, par):
    """(q0, q1, k0, k1): the q heads this model shard attends with and the
    kv heads it computes. The model axis splits the q heads where it
    divides them and each shard's q heads share whole kv heads or one kv
    head; else every shard takes all q heads. The kv heads are the shard's
    block where the axis divides them, else all of them."""
    hq, hkv, m = cfg.num_heads, cfg.num_kv_heads, par.t_size
    g = hq // hkv
    split = hq % m == 0 and (hkv % m == 0 or g % (hq // m) == 0)
    q0, q1 = par.model_block(hq) if split else (0, hq)
    k0, k1 = par.model_block(hkv) if hkv % m == 0 else (0, hkv)
    return q0, q1, k0, k1


def _write_at(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor, group, index: int):
    """Write the token's k or v (B, H, 1, Dh) into the cache c at position
    ``pos``, in place. Where c holds positions [index S_loc, (index + 1)
    S_loc) of a split cache (``group`` not None), only the shard holding
    ``pos`` changes (the others write back what they hold)."""
    new = new.to(c.dtype)
    if group is None:
        c.index_copy_(2, pos.to(torch.int64).reshape(1), new)
        return
    s_loc = c.shape[2]
    rel = pos.to(torch.int64) - index * s_loc
    at = rel.clamp(0, s_loc - 1).reshape(1)
    mine = (rel >= 0) & (rel < s_loc)
    c.index_copy_(2, at, torch.where(mine, new, c.index_select(2, at)))


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
    default). On a worker's blocks the gate/up columns and the down rows
    are this model shard's block of the hidden width (which the model axis
    divides: ``parallel.check_mesh``), and the result is the ``psum`` of the
    partial products (under a sequence split ``Par.enter`` and
    ``Par.leave``)."""
    par = parallel.current()
    d = x.shape[-1]
    f = p["wg" if kind == "swiglu" else "w1"].shape[1] * par.t_size
    lo, hi = par.model_block(f)
    xc = par.enter(x)

    def col(name):
        return par.cols(par.fsdp(p[name], 0, d), 1, f, lo, hi)

    def row(name):
        return par.cols(par.fsdp(p[name], 1, d), 0, f, lo, hi)

    if kind == "swiglu":
        h = F.silu(xc @ col("wg")) * (xc @ col("wu"))
        return par.leave(h @ row("wd"))
    return par.leave(F.gelu(xc @ col("w1"), approximate="tanh") @ row("w2"))
