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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import normal, rms_norm

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


def _split(cfg, proj: torch.Tensor):
    """(z, xBC, dt) of the input projection."""
    d_inner, nh, _, n = dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * n, nh], dim=-1)


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
    min(cfg.ssm_chunk, S)."""
    b, s, _ = x.shape
    d_inner, nh, hd, n = dims(cfg)
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {q}")

    proj = x @ p["w_in"]
    z, xbc, dt = _split(cfg, proj)
    xbc_preconv = xbc
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(b, s, nh, hd)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, nh)
    loga = dt * -torch.exp(p["a_log"])  # (B, S, nh) log decay, <= 0

    h = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, s, q):
        h, y = _chunk_step(h, xs[:, lo:lo + q], bmat[:, lo:lo + q], cmat[:, lo:lo + q],
                           dt[:, lo:lo + q], loga[:, lo:lo + q])
        ys.append(y)
    y = torch.cat(ys, dim=1) + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if return_state:
        return out, MambaCache(h=h, conv=xbc_preconv[:, s - cfg.d_conv + 1:, :])
    return out


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
    may copy it over the old window without the two overlapping."""
    b = x.shape[0]
    d_inner, nh, hd, n = dims(cfg)

    proj = x[:, 0] @ p["w_in"]
    z, xbc, dt = _split(cfg, proj)
    conv_in = torch.cat([cache.conv, xbc[:, None, :]], dim=1)  # (B, K, C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"]) + p["conv_b"])
    new_conv = conv_in[:, 1:, :]

    xs, bvec, cvec = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(b, nh, hd)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, nh)
    da = torch.exp(dt * -torch.exp(p["a_log"]))  # (B, nh)

    dx = dt[..., None] * xs.float()  # (B, nh, hd)
    h = cache.h * da[..., None, None] + torch.einsum("bhp,bn->bhpn", dx, bvec.float())
    y = torch.einsum("bhpn,bn->bhp", h, cvec.float())
    y = y + p["d_skip"][None, :, None] * xs.float()
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return (y @ p["w_out"])[:, None, :], MambaCache(h=h, conv=new_conv)
