"""Mamba-2 (SSD) block, used by zamba2-2.7b: the port's counterpart of
``repro.models.mamba2``.

Chunked state-space duality: within a chunk the recurrence is evaluated as
masked, decay-weighted attention-like products; across chunks a small state
(heads, head_dim, N) is carried, here by a Python loop over the chunks in
place of the reference's ``lax.scan``. Per-head scalar decay (the SSD
restriction) with one group of shared B/C, per-head dt, conv width
``cfg.d_conv``. The chunk step is plain PyTorch in f32, as the reference's
is plain jnp: the reference has no kernel for it.

Decode is the exact recurrence: h <- exp(dt A) h + dt x (x) B, y = h C + D x.

Under a mesh (``models.parallel``) the heads go over the model axis: a
model shard runs heads [h0, h1), their z, x and dt columns of the fused
input projection and the shared B and C columns. The leaves keep the
reference's specs, which cut the fused widths into contiguous blocks that
do not line up with the heads (``w_in`` [z | x | B | C | dt] and the conv's
[x | B | C] over the model axis), so a shard takes its columns out of
the leaf gathered over the model axis (``Par.pieces``; ``w_in`` gathered
once, for its heads' columns and its cache block's; the gradient the sum
of the shards'). The depthwise conv runs on the shard's channels, B and
C's on every shard. The gated RMSNorm over d_inner sums its squares over
the model shards (``psum``), and ``w_out`` is row-parallel (``psum`` of the
partial outputs). ``a_log``, ``dt_bias``, ``d_skip`` and ``norm`` are
replicated, their gradients summed over the model shards (``spmd.copy``).
A cache holds the shard's heads of ``h`` and its block of the conv
channels (``launch.steps.cache_pspecs``: the spec's contiguous block of
[x | B | C], whatever heads it holds). On one device every span is the
whole leaf and the body is the unsharded one.

Under a sequence split (the "sp" and "msp" profiles) x holds this worker's
rows: the conv's d_conv - 1 rows of history and the chunk scan's state
cross the rows' edge, so the block gathers the whole sequence over the
model axis, runs on it (under "msp" on the shard's heads) and keeps its
rows at the end (``Par.leave``), as RWKV-6's time mix does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..comm import spmd
from . import parallel
from .layers import normal

Params = Dict[str, torch.Tensor]


class MambaCache(NamedTuple):
    h: torch.Tensor  # (B, nh, hd, N) SSM state, f32
    conv: torch.Tensor  # (B, d_conv - 1, conv_dim) the last conv inputs


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state size N)."""
    d_inner = 2 * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    return d_inner, nh, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg, dtype: torch.dtype, device) -> Params:
    """The reference's names, shapes, dtypes and scales (``a_log``,
    ``dt_bias`` and ``d_skip`` stay f32 in a bf16 model)."""
    d = cfg.d_model
    d_inner, nh, hd, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z (d_inner), xBC (d_inner + 2N), dt (nh)]
        "w_in": normal(gen, (d, 2 * d_inner + 2 * n + nh), dtype, device) * d**-0.5,
        "conv_w": normal(gen, (cfg.d_conv, conv_dim), dtype, device) * 0.1,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_out": normal(gen, (d_inner, d), dtype, device) * d_inner**-0.5,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence. x: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + s, :] * w[i] for i in range(k)) + b


def _split(cfg, proj: torch.Tensor, nh: int = 0):
    """(z, xBC, dt) of the input projection of ``nh`` heads' columns (all
    heads by default; a model shard's under a mesh)."""
    _, heads, hd, n = dims(cfg)
    nh = nh or heads
    return torch.split(proj, [nh * hd, nh * hd + 2 * n, nh], dim=-1)


class _Shard(NamedTuple):
    """A model shard's view of one Mamba-2 layer (``_shard``)."""

    h0: int
    h1: int  # this shard's heads [h0, h1)
    w_all: torch.Tensor  # (D, 2 d_inner + 2N + nh): the whole fused projection
    w_in: torch.Tensor  # (D, 2 d_loc + 2N + heads): [z | x | B | C | dt] of its heads
    conv_w: torch.Tensor  # (K, d_loc + 2N)
    conv_b: torch.Tensor
    a_log: torch.Tensor  # (heads,)
    dt_bias: torch.Tensor
    d_skip: torch.Tensor
    norm: torch.Tensor  # (d_loc,)
    w_out: torch.Tensor  # (d_loc, D)


def _shard(p: Params, cfg, par) -> _Shard:
    """This model shard's heads and its columns of every leaf (module doc):
    the whole leaves on one device."""
    d = cfg.d_model
    d_inner, nh, hd, n = dims(cfg)
    h0, h1 = par.model_block(nh)
    x_cols = (h0 * hd, h1 * hd)  # within d_inner: z's in w_in, x's in the conv channels
    bc = (d_inner, d_inner + 2 * n)  # B and C within the conv channels [x | B | C]
    conv_dim, dt0 = d_inner + 2 * n, 2 * d_inner + 2 * n
    in_spans = (x_cols, *((d_inner + lo, d_inner + hi) for lo, hi in (x_cols, bc)),
                (dt0 + h0, dt0 + h1))  # z, x, B and C, dt of w_in [z | x | B | C | dt]
    width = _in_width(cfg)
    w_all = par.cols(par.fsdp(p["w_in"], 0, d), 1, width, 0, width)
    return _Shard(
        h0, h1, w_all=w_all, w_in=parallel.take(w_all, 1, in_spans),
        conv_w=par.pieces(p["conv_w"], 1, conv_dim, (x_cols, bc)),
        conv_b=par.pieces(p["conv_b"], 0, conv_dim, (x_cols, bc)),
        a_log=par.cols(p["a_log"], 0, nh, h0, h1),
        dt_bias=par.cols(p["dt_bias"], 0, nh, h0, h1),
        d_skip=par.cols(p["d_skip"], 0, nh, h0, h1),
        norm=par.cols(p["norm"], 0, d_inner, *x_cols),
        w_out=par.cols(par.fsdp(p["w_out"], 1, d), 0, d_inner, *x_cols))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, cfg, par) -> torch.Tensor:
    """rms_norm(y * silu(z)) over d_inner, on a model shard's columns: the
    mean square from the shards' partial sums of squares (``psum``; its
    gradient, partial on each shard, summed by ``spmd.copy``)."""
    gf = (y * F.silu(z)).float()
    ss = spmd.copy(spmd.psum(torch.sum(gf * gf, dim=-1, keepdim=True), par.tp), par.tp)
    var = ss / dims(cfg)[0]
    return (gf * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(y.dtype)


def _conv_block(cfg, par) -> Tuple[int, int]:
    """[c0, c1): the conv channels of this model shard's cache block (the
    spec's contiguous block of [x | B | C])."""
    d_inner, _, _, n = dims(cfg)
    return par.model_block(d_inner + 2 * n)


def _chunk_step(h, xq, bq, cq, dtq, laq):
    """One chunk of q positions: (B, q, ...) inputs, state h (B, nh, hd, N)
    in f32. Returns (h after the chunk, y (B, q, nh, hd))."""
    q = xq.shape[1]
    cum = torch.cumsum(laq, dim=1)  # (B, q, nh) inclusive
    bq, cq = bq.float(), cq.float()
    # intra-chunk: y[i] += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
    g = torch.einsum("bin,bjn->bij", cq, bq)
    decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B, i, j, nh)
    mask = torch.ones((q, q), dtype=torch.bool, device=xq.device).tril()
    # mask BEFORE exp: the upper triangle's arguments are positive and would
    # overflow to inf
    decay = torch.where(mask[None, :, :, None], decay, -1e9)
    w_ij = g[..., None] * torch.exp(decay)  # (B, i, j, nh)
    dx = dtq[..., None] * xq.float()  # (B, q, nh, hd)
    y = torch.einsum("bijh,bjhp->bihp", w_ij, dx)
    # inter-chunk: y[i] += exp(cum_i) C_i . h_in
    y = y + torch.einsum("bin,bhpn->bihp", cq, h) * torch.exp(cum)[..., None]
    # h_out = exp(cum_last) h_in + sum_j exp(cum_last - cum_j) dx_j (x) B_j
    tail = torch.exp(cum[:, -1:, :] - cum)  # (B, q, nh)
    h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum(
        "bjhp,bjn,bjh->bhpn", dx, bq, tail)
    return h, y


def mamba_block(p: Params, x: torch.Tensor, cfg, *, return_state: bool = False):
    """Full-sequence (train / prefill) chunked SSD. x: (B, S, D) -> (B, S, D),
    and the final ``MambaCache`` when ``return_state`` (prefill keeps O(1)
    state instead of a KV cache). S must be a multiple of the chunk,
    min(cfg.ssm_chunk, S). Under a sequence split x and the output are this
    worker's rows, S the whole sequence's length (module doc)."""
    par = parallel.current()
    x = par.gather_seq(x)
    b, s, _ = x.shape
    _, _, hd, n = dims(cfg)
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {q}")
    sh = _shard(p, cfg, par)
    nh = sh.h1 - sh.h0
    d_inner = nh * hd  # this shard's heads' width

    xc = par.copy_in(x)
    proj = xc @ sh.w_in
    z, xbc, dt = _split(cfg, proj, nh)
    xbc_preconv = xbc
    xbc = F.silu(_causal_conv(xbc, sh.conv_w, sh.conv_b))
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(b, s, nh, hd)
    dt = F.softplus(dt.float() + sh.dt_bias)  # (B, S, nh)
    loga = dt * -torch.exp(sh.a_log)  # (B, S, nh) log decay, <= 0

    h = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, s, q):
        h, y = _chunk_step(h, xs[:, lo:lo + q], bmat[:, lo:lo + q], cmat[:, lo:lo + q],
                           dt[:, lo:lo + q], loga[:, lo:lo + q])
        ys.append(y)
    y = torch.cat(ys, dim=1) + sh.d_skip[None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = _gated_norm(y, z, sh.norm, cfg, par)
    out = par.leave(y @ sh.w_out, whole=True)
    if return_state:
        tail = s - cfg.d_conv + 1
        if par.tp is None:
            conv = xbc_preconv[:, tail:, :]
        else:  # the pre-conv inputs of this shard's cache block of channels
            c0, c1 = _conv_block(cfg, par)
            d_full = dims(cfg)[0]
            conv = xc[:, tail:] @ sh.w_all[:, d_full + c0:d_full + c1]
        return out, MambaCache(h=h, conv=conv)
    return out


def _in_width(cfg) -> int:
    """The fused input projection's width, 2 d_inner + 2N + nh."""
    d_inner, nh, _, n = dims(cfg)
    return 2 * d_inner + 2 * n + nh


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype = torch.float32,
                     device=None) -> MambaCache:
    d_inner, nh, hd, n = dims(cfg)
    return MambaCache(
        h=torch.zeros((batch, nh, hd, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, d_inner + 2 * n), dtype=dtype, device=device),
    )


def mamba_decode_step(p: Params, x: torch.Tensor, cache: MambaCache,
                      cfg) -> Tuple[torch.Tensor, MambaCache]:
    """One-token recurrence. x: (B, 1, D). Returns (y (B, 1, D), the new
    cache); the cache passed in is not written. The new conv window is a
    view of a fresh buffer (the old window and the new input), so a caller
    may copy it over the old window without the two overlapping. Under a
    mesh ``cache`` holds this model shard's heads of h and its block of the
    conv channels (module doc), and so does the new cache; the window's
    other channels come from the other shards (an all-gather)."""
    b = x.shape[0]
    _, _, hd, n = dims(cfg)
    par = parallel.current()
    sh = _shard(p, cfg, par)
    nh = sh.h1 - sh.h0
    d_inner, d_full = nh * hd, dims(cfg)[0]

    xc = par.copy_in(x[:, 0])
    proj = xc @ sh.w_in
    z, xbc, dt = _split(cfg, proj, nh)
    if par.tp is None:
        conv_in = torch.cat([cache.conv, xbc[:, None, :]], dim=1)  # (B, K, C)
        new_conv = conv_in[:, 1:, :]
    else:  # the window holds the spec's block of channels, not this shard's
        c0, c1 = _conv_block(cfg, par)
        window = spmd.gather(cache.conv, -1, par.tp)  # (B, K - 1, conv_dim)
        mine = torch.cat([window[..., sh.h0 * hd:sh.h1 * hd], window[..., d_full:]], dim=-1)
        conv_in = torch.cat([mine, xbc[:, None, :]], dim=1)
        own = xc @ sh.w_all[:, d_full + c0:d_full + c1]
        new_conv = torch.cat([cache.conv, own[:, None, :]], dim=1)[:, 1:, :]
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in, sh.conv_w) + sh.conv_b)

    xs, bvec, cvec = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(b, nh, hd)
    dt = F.softplus(dt.float() + sh.dt_bias)  # (B, nh)
    da = torch.exp(dt * -torch.exp(sh.a_log))  # (B, nh)

    dx = dt[..., None] * xs.float()  # (B, nh, hd)
    h = cache.h * da[..., None, None] + torch.einsum("bhp,bn->bhpn", dx, bvec.float())
    y = torch.einsum("bhpn,bn->bhp", h, cvec.float())
    y = y + sh.d_skip[None, :, None] * xs.float()
    y = y.reshape(b, d_inner).to(x.dtype)
    y = _gated_norm(y, z, sh.norm, cfg, par)
    return par.leave(y @ sh.w_out)[:, None, :], MambaCache(h=h, conv=new_conv)
