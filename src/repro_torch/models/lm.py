"""The LM zoo's dense, moe, ssm (RWKV-6), audio, vlm and hybrid (Mamba-2
with a shared attention block) families: init / forward / decode. The
port's counterpart of ``repro.models.lm``.

Parameters are a dict of tensors with the reference's names and layouts,
except that the reference's stacked ``(L, ...)`` layer leaves are a list of
per-layer dicts here (``params["layers"][i]``), run by a Python loop in
place of ``lax.scan``; the hybrid family's ``shared`` block is one dict,
applied after every ``hybrid_block`` Mamba-2 layers. ``convert.lm_params``
carries a JAX parameter dict across. A moe layer swaps the MLP for
``moe.moe_block`` (capacity-bounded top-k routing over the experts; arctic
adds a dense residual MLP on the same input), and its forward sums the
layers' Switch losses into ``aux_loss`` (under a mesh its experts are
split over the model axis, below). The audio family (hubert) is encoder-only: a
bidirectional forward through the frame-embedding frontend, with no cache
and no decode.

Training: ``loss_fn`` is the reference's objective, differentiated by
autograd, for every family (``TRAINED_FAMILIES``): vlm's cross entropy runs
over the text positions only, audio's over one label a frame, and a moe
model adds 0.01 times its layers' Switch losses, whose gradient reaches the
router (``moe``: the dispatch and the combine differentiate by gathers,
with no float atomics). The hybrid family's shared block, one set of
weights applied after every ``hybrid_block`` Mamba-2 layers, gets the sum
of its applications' gradients.
While autograd records through a layer (``torch.is_grad_enabled()``
and a tensor it reads requires grad), ``cfg.remat == "full"`` checkpoints
each layer (``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint`` of the scanned block does, and the layers take their
differentiable paths: ``layers.attention`` the reference's own training
path (dense or chunked), ``rwkv6.time_mix`` the plain chunk form; neither
hand-written forward kernel has a backward (see those modules). ``"none"``
checkpoints nothing; ``"dots"`` (no configuration uses it) is not ported.

Under a mesh (``launch.sharding.use_mesh`` over a ``launch.mesh.Mesh`` of
processes; ``models.parallel``) every worker holds its blocks of the
parameters (``launch.params.shard_params``) and of a decode cache
(``launch.steps.cache_pspecs``), and takes the GLOBAL batch, of which it
runs its data shard's rows (``data.pipeline.shard_rows``; a batch the data
axes do not divide runs whole on every data shard, as the reference
replicates it). Logits come back for those rows, all of the vocabulary; a
prefill's cache holds the shard's rows and kv heads (its sequence dim split
as ``cache_pspecs`` says). The embedding is vocab-parallel (the masked local
lookup, then a ``psum`` over the model axis), ``loss_fn``'s cross entropy
too (the log-sum-exp from a ``pmax`` and a ``psum`` of the shards' parts,
the gold logit a masked pick and a ``psum``), its mean over the global
B x S positions; ``value_and_grad`` sums over the data axes the gradients
of the leaves replicated there, so each worker's gradient is its block of
the full one. The dense, moe and ssm families run and train under a
mesh (moe's capacity and Switch loss per data shard, as the reference's); the
reference's sequence-sharded loss (its ``seq_act`` branch, profiles
``sp``/``msp``) and the other families raise ``NotYetPorted`` there
(``parallel.check_mesh``). A decode step at global batch 1 splits the
cache's sequence dim over the data axes (``layers.decode_attention_seq_
sharded``; not for ssm, whose state has no sequence dim).

The embedding lookup is ``F.embedding``, whose gradient sums each row's
tokens in a fixed order on the card (no atomics), so a training step
repeats its bits.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, resolve_device
from ..comm import spmd
from ..launch import sharding
from ..specs import NotYetPorted
from . import layers as L
from . import mamba2, moe, parallel, rwkv6
from .config import ModelConfig

Params = Dict[str, Any]

#: Families whose forward, prefill and decode the port runs.
PORTED_FAMILIES = ("dense", "moe", "ssm", "audio", "vlm", "hybrid")
#: Families the port also trains (``loss_fn`` and everything built on it).
TRAINED_FAMILIES = ("dense", "moe", "ssm", "audio", "vlm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotYetPorted`` unless the port runs ``cfg``'s family."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotYetPorted(
            f"{cfg.name}: family {cfg.family!r} is not yet ported to PyTorch; the port runs "
            f"{PORTED_FAMILIES}"
        )


def check_trains(cfg: ModelConfig) -> None:
    """Raise ``NotYetPorted`` unless the port trains ``cfg``'s family and
    its ``remat`` policy, before any device work."""
    check_family(cfg)
    if cfg.family not in TRAINED_FAMILIES:
        raise NotYetPorted(
            f"{cfg.name}: training of family {cfg.family!r} is not yet ported to PyTorch (it "
            f"serves); the port trains {TRAINED_FAMILIES}"
        )
    _check_remat(cfg)


def _check_remat(cfg: ModelConfig) -> None:
    if cfg.remat == "dots":
        raise NotYetPorted(f"{cfg.name}: remat='dots' (checkpoint_dots_with_no_batch_dims) is "
                           "not yet ported; 'none' and 'full' are")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0, *,
                device: DeviceLike = None, keep=None) -> Params:
    """Random parameters with the reference's names, shapes and scales:
    N(0, 1) weights times d^-0.5 (the down projections f^-0.5), zero QKV
    biases, unit norms; for the moe family each layer's ``moe`` experts of
    ``moe.init_moe`` (and ``mlp`` of width ``moe_dense_ff or d_ff`` where
    ``moe_dense_residual`` is set), for the ssm family the RWKV-6 blocks of
    ``rwkv6.init_rwkv``, for the hybrid family the Mamba-2 layers of
    ``mamba2.init_mamba`` and one ``shared`` attention + MLP block, for the
    audio family the ``frame_proj`` frontend (frontend_dim^-0.5). ``key``
    is a seed or a ``torch.Generator`` on the target device (free runs draw
    different numbers from the reference's ``jax.random`` stream;
    ``convert.lm_params`` carries those across). ``device="meta"`` gives the
    shapes and dtypes alone. ``keep(tree, path)``, when given, replaces each
    top-level leaf and each layer's dict as soon as it is drawn (a sharded
    run keeps its blocks: ``launch.params.init_local_params``), so the
    whole model is never held (a moe layer's expert tensors are kept one by
    one); the draws, and so the values kept, are the same."""
    cfg.validate()
    check_family(cfg)
    if isinstance(key, torch.Generator):
        gen = key
        dev = gen.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev)
        if gen is not None:
            gen.manual_seed(int(key))
    keep = keep or (lambda tree, names: tree)
    dt, d = cfg.torch_dtype, cfg.d_model
    p: Params = {}
    if cfg.family == "audio":
        p["frame_proj"] = (L.normal(gen, (cfg.frontend_dim, d), dt, dev)
                           * cfg.frontend_dim**-0.5)
    p["embed"] = keep(L.normal(gen, (cfg.vocab_size, d), dt, dev) * d**-0.5, ("embed",))

    def ones():
        return torch.ones((d,), dtype=dt, device=dev)

    def attn_mlp():
        attn = L.init_attention(gen, cfg, dt, dev)  # drawn before the MLP
        return {"ln1": ones(), "attn": attn, "ln2": ones(),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dt, dev)}

    def attn_moe():  # kept part by part: an expert tensor is GBs at full width
        lp = keep({"ln1": ones(), "attn": L.init_attention(gen, cfg, dt, dev), "ln2": ones()},
                  ("layers",))
        lp["moe"] = moe.init_moe(gen, cfg, dt, dev,
                                 keep=lambda t, name: keep(t, ("layers", "moe", name)))
        if cfg.moe_dense_residual:
            lp["mlp"] = keep(L.init_mlp(gen, d, cfg.moe_dense_ff or cfg.d_ff, cfg.mlp_type, dt,
                                        dev), ("layers", "mlp"))
        return lp

    def layer():
        if cfg.family == "moe":
            return attn_moe()
        return keep({"ln1": ones(), "ln2": ones(), "tm_cm": rwkv6.init_rwkv(gen, cfg, dt, dev)}
                    if cfg.family == "ssm" else
                    {"ln": ones(), "mamba": mamba2.init_mamba(gen, cfg, dt, dev)}
                    if cfg.family == "hybrid" else attn_mlp(), ("layers",))

    p["layers"] = [layer() for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        p["shared"] = keep(attn_mlp(), ("shared",))
    p["final_norm"] = ones()
    if not cfg.tie_embeddings:
        p["unembed"] = keep(L.normal(gen, (d, cfg.vocab_size), dt, dev) * d**-0.5, ("unembed",))
    return p


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Returns (h (B, S, D), rope angles (B, S, Dh/2); None for the
    attention-free ssm family and for audio, whose stub position code is
    added to h). audio: ``frames`` (B, S, frontend_dim) cast to the model
    dtype times ``frame_proj``, plus a sinusoidal code computed in f32 and
    cast to h's dtype. vlm: the ``vision_embeds`` (cast to the token dtype)
    ahead of the token embeddings, M-RoPE angles from ``positions`` (B, 3,
    S)."""
    if cfg.family == "audio":
        h = batch["frames"].to(cfg.torch_dtype) @ params["frame_proj"]
        s, d = h.shape[1], h.shape[2]
        # stub positional encoding (the real model uses a conv pos-embed)
        half = d // 2
        inv = torch.pow(torch.full((), 10000.0, device=h.device),
                        -torch.arange(half, dtype=torch.float32, device=h.device) / half)
        pos = torch.arange(s, dtype=torch.float32, device=h.device)[:, None] * inv
        return h + torch.cat([torch.sin(pos), torch.cos(pos)], -1).to(h.dtype), None
    tokens = batch["tokens"]
    h = _embed_tokens(params, tokens, cfg)
    if cfg.family == "ssm":
        return h, None
    if cfg.family == "vlm":
        h = torch.cat([batch["vision_embeds"].to(h.dtype), h], dim=1)
        return h, L.mrope_angles(batch["positions"], cfg.head_dim_, cfg.rope_theta,
                                 cfg.mrope_sections)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    return h, L.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings (B, S, D): the table's D gathered over the data
    axes where it is split there, then, where its vocab is split over the
    model axis, the masked lookup of this shard's rows and the ``psum``."""
    par = parallel.current()
    table = par.fsdp(params["embed"], 1, cfg.d_model)
    if table.shape[0] == cfg.vocab_size:
        return F.embedding(tokens.long(), table)
    n = table.shape[0]
    idx = tokens.long() - par.m_index * n
    mine = (idx >= 0) & (idx < n)
    rows = F.embedding(idx.clamp(0, n - 1), table)
    return spmd.psum(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                     device=rows.device)),
                     par.model)


def _head(params: Params, cfg: ModelConfig, par) -> torch.Tensor:
    """The (D, V or V_loc) head: ``embed.T`` when tied, else ``unembed``,
    its D gathered over the data axes where it is split there."""
    if cfg.tie_embeddings:
        return par.fsdp(params["embed"], 1, cfg.d_model).T
    return par.fsdp(params["unembed"], 0, cfg.d_model)


def _unembed(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    par = parallel.current()
    w = _head(params, cfg, par)
    if w.shape[1] == cfg.vocab_size:
        return h @ w.to(h.dtype)
    logits = spmd.copy(h, par.model) @ w.to(h.dtype)
    return spmd.gather_replicated(logits, -1, par.model)


# ---------------------------------------------------------------------------
# Forward (train / prefill / hidden)
# ---------------------------------------------------------------------------


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            mode: str = "train") -> Dict[str, Any]:
    """All positions at once. ``mode``: "train" (hidden + logits), "prefill"
    (+ the cache: dense and vlm ``k``/``v`` of shape (L, B, Hkv, S, Dh); ssm
    ``s`` (L, B, H, 64, 64), ``x_tm`` and ``x_cm`` (L, B, D), all f32; hybrid
    ``k``/``v`` (nb, B, Hkv, S, Dh) of the nb shared-block applications,
    ``mamba_h`` (L, B, nh, hd, N) f32 and ``mamba_conv`` (L, B, d_conv - 1,
    conv_dim); audio's encoder gives its ``k``/``v`` too, as the reference's
    does, though nothing decodes from them) or "hidden" (no logits).
    ``aux_loss`` (f32) is the sum over the layers of the moe family's Switch
    losses, in layer order; 0 for every other family. Under a mesh: the
    rows of this data shard (module doc)."""
    check_family(cfg)
    parallel.check_mesh(cfg)
    par = parallel.current()
    batch, b_global = local_batch(batch, par)
    return _forward(_gather_tied(params, cfg, par), batch, cfg, mode, par, b_global)


def _gather_tied(params: Params, cfg: ModelConfig, par) -> Params:
    """``params`` with a tied embedding's D gathered over the data axes
    once, for both its uses (the lookup and the head): one all-gather and
    one reduce-scatter a step, not two."""
    if not cfg.tie_embeddings:
        return params
    return {**params, "embed": par.fsdp(params["embed"], 1, cfg.d_model)}


def _forward(params: Params, batch, cfg: ModelConfig, mode: str, par, b_global: int):
    h, angles = _embed_inputs(params, batch, cfg)
    prefill = mode == "prefill"
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        h, cache = _ssm_layers(params, h, cfg, prefill)
    elif cfg.family == "hybrid":
        h, cache = _hybrid_layers(params, h, angles, cfg, prefill)
    else:
        h, cache, aux = _dense_layers(params, h, angles, cfg, prefill, aux)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    out = {"hidden": h, "aux_loss": aux}
    if mode != "hidden":
        out["logits"] = _unembed(params, h, cfg)
    if prefill:
        out["cache"] = _split_prefill_cache(cache, cfg, par, b_global)
    return out


def local_batch(batch: Dict[str, Any], par) -> Tuple[Dict[str, Any], int]:
    """(this data shard's rows of a global batch, the global batch size).
    On one data shard, or where the data axes do not divide the batch
    (which then runs whole on every data shard, as the reference
    replicates it), the batch itself."""
    from ..data.pipeline import shard_rows

    key = "tokens" if "tokens" in batch else "frames"
    b = batch[key].shape[0]
    if par.d_size == 1 or b % par.d_size:
        return batch, b
    return shard_rows(batch, par.d_index, par.d_size), b


def cache_split(cfg: ModelConfig, par, b_global: int) -> Tuple[str, ...]:
    """The mesh axes over which a kv cache of global batch ``b_global`` is
    split on its sequence dim: those of ``launch.steps.cache_pspecs``' spec
    of ``k`` (the seq axes at batch 1; the model axis where it does not
    divide the kv heads); () on one worker or without a kv cache."""
    from ..launch.steps import cache_pspecs
    from .config import ShapeSpec

    if par.mesh is None or cfg.family == "ssm":
        return ()
    return sharding.spec_axes(cache_pspecs(cfg, ShapeSpec("decode", "decode", 1, b_global))
                              ["k"][3])


def _split_prefill_cache(cache, cfg: ModelConfig, par, b_global: int):
    """A prefill's kv cache cut on its sequence dim as a decode cache of its
    global batch is laid out (``cache_split``)."""
    _, count, index = par.split(cache_split(cfg, par, b_global))
    if count == 1:
        return cache
    n = next(iter(cache.values())).shape[3] // count
    return {k: v.narrow(3, index * n, n).contiguous() for k, v in cache.items()}


def _maybe_remat(fn, cfg: ModelConfig, h, lp):
    """``fn(h, lp)``, checkpointed as the reference's ``jax.checkpoint`` of
    a layer when ``cfg.remat == "full"`` and autograd records through it;
    the recomputation runs under the mesh of the forward
    (``sharding.in_context``)."""
    _check_remat(cfg)
    if cfg.remat == "full" and L.records_grad(h, lp):
        return checkpoint(sharding.in_context(fn), h, lp, use_reentrant=False)
    return fn(h, lp)


def _attn_mlp_block(hh, lp, angles, cfg: ModelConfig, **attn_kw):
    """Pre-norm attention then the feed-forward, each added to the
    residual: a dense or moe layer, or the hybrid family's shared block. A
    moe layer's feed-forward is ``moe.moe_block`` plus, with
    ``moe_dense_residual``, the dense MLP on the same input. Returns (h, the
    attention's (k, v) or None, the layer's Switch loss or None)."""
    a_in = L.rms_norm(hh, lp["ln1"], cfg.norm_eps)
    attn_out, kv = L.attention_block(lp["attn"], a_in, cfg, angles=angles, **attn_kw)
    hh = hh + attn_out
    m_in = L.rms_norm(hh, lp["ln2"], cfg.norm_eps)
    if cfg.family != "moe":
        return hh + L.mlp_block(lp["mlp"], m_in, cfg.mlp_type), kv, None
    mo, aux = moe.moe_block(lp["moe"], m_in, cfg)
    if cfg.moe_dense_residual:
        mo = mo + L.mlp_block(lp["mlp"], m_in, cfg.mlp_type)
    return hh + mo, kv, aux


def _dense_layers(params: Params, h, angles, cfg: ModelConfig, prefill: bool, aux):
    """The dense, moe, vlm and audio layers. Returns (h, the cache or None,
    ``aux`` plus each moe layer's Switch loss in layer order)."""
    def block(hh, lp):
        return _attn_mlp_block(hh, lp, angles, cfg, return_kv=prefill)

    ks, vs = [], []
    for lp in params["layers"]:
        h, kv, al = _maybe_remat(block, cfg, h, lp)
        if al is not None:
            aux = aux + al
        if prefill:
            ks.append(kv[0])
            vs.append(kv[1])
    return h, ({"k": torch.stack(ks), "v": torch.stack(vs)} if prefill else None), aux


def _hybrid_layers(params: Params, h, angles, cfg: ModelConfig, prefill: bool):
    """nb = num_layers / hybrid_block groups: each group's Mamba-2 layers,
    then the one shared attention + MLP block (the same weights at every
    application)."""
    hb, shared = cfg.hybrid_block, params["shared"]

    def mblock(hh, lp):
        out = mamba2.mamba_block(lp["mamba"], L.rms_norm(hh, lp["ln"], cfg.norm_eps), cfg,
                                 return_state=prefill)
        if prefill:
            return hh + out[0], out[1]
        return hh + out, None

    def sblock(hh, sp):
        return _attn_mlp_block(hh, sp, angles, cfg, return_kv=prefill)[:2]

    ks, vs, m_h, m_conv = [], [], [], []
    for i in range(cfg.num_layers // hb):
        for lp in params["layers"][i * hb:(i + 1) * hb]:
            h, mcache = _maybe_remat(mblock, cfg, h, lp)
            if prefill:
                m_h.append(mcache.h)
                m_conv.append(mcache.conv)
        h, kv = _maybe_remat(sblock, cfg, h, shared)
        if prefill:
            ks.append(kv[0])
            vs.append(kv[1])
    if not prefill:
        return h, None
    return h, {"k": torch.stack(ks), "v": torch.stack(vs), "mamba_h": torch.stack(m_h),
               "mamba_conv": torch.stack(m_conv).to(cfg.torch_dtype)}


def _ssm_layers(params: Params, h, cfg: ModelConfig, prefill: bool):
    """RWKV-6 blocks from a zero token shift and a zero state (of this model
    shard's heads under a mesh)."""
    b = h.shape[0]
    zeros_x = torch.zeros((b, cfg.d_model), dtype=h.dtype, device=h.device)
    s0 = torch.zeros((b, ssm_heads(cfg), rwkv6.HEAD, rwkv6.HEAD),
                     dtype=torch.float32, device=h.device)

    def block(hh, lp):
        y, s_n, x_tm = rwkv6.time_mix(lp["tm_cm"], L.rms_norm(hh, lp["ln1"], cfg.norm_eps), cfg,
                                      zeros_x, s0)
        hh = hh + y
        cm, x_cm = rwkv6.channel_mix(lp["tm_cm"], L.rms_norm(hh, lp["ln2"], cfg.norm_eps),
                                     zeros_x)
        return hh + cm, (s_n, x_tm, x_cm)

    ss, xtm, xcm = [], [], []
    for lp in params["layers"]:
        h, (s_n, x_tm, x_cm) = _maybe_remat(block, cfg, h, lp)
        if prefill:
            ss.append(s_n)
            xtm.append(x_tm.float())
            xcm.append(x_cm.float())
    if not prefill:
        return h, None
    return h, {"s": torch.stack(ss), "x_tm": torch.stack(xtm), "x_cm": torch.stack(xcm)}


def ssm_heads(cfg: ModelConfig) -> int:
    """RWKV-6 heads this worker runs: all, or its model shard's block where
    the model axis divides them."""
    nh = cfg.d_model // rwkv6.HEAD
    m = parallel.current().m_size
    return nh if nh % m else nh // m


# ---------------------------------------------------------------------------
# Loss / train objective
# ---------------------------------------------------------------------------


def _ce_chunk(hi: torch.Tensor, li: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over one chunk's positions of logsumexp - gold logit, in f32."""
    logits = (hi @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    # one gold position a row: on the card the gather's gradient adds one
    # value onto zero at distinct places, so its order cannot change a bit
    gold = torch.gather(logits, -1, li.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def _ce_chunk_vocab_parallel(hi: torch.Tensor, li: torch.Tensor, w: torch.Tensor, v0: int,
                             group) -> torch.Tensor:
    """``_ce_chunk`` with the vocab split over ``group``: w holds columns
    [v0, v0 + V_loc); lse = m + log(psum(sum(exp(l - m)))) with m the
    ``pmax`` of the shards' maxima, the gold logit a masked pick and a
    ``psum``."""
    logits = (hi @ w).float()
    m = spmd.pmax(logits.amax(dim=-1), group)
    lse = m + torch.log(spmd.psum(torch.exp(logits - m[..., None]).sum(dim=-1), group))
    idx = li.long() - v0
    mine = (idx >= 0) & (idx < logits.shape[-1])
    gold = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = spmd.psum(torch.where(mine, gold, torch.zeros((), device=gold.device)), group)
    return torch.sum(lse - gold)


def _chunked_ce(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, chunk: int, par,
                n_global: int, vocab: int) -> torch.Tensor:
    """Cross entropy without the full-sequence f32 logits: the sequence in
    chunks of ``chunk`` positions (one chunk when S does not divide), each
    chunk's logits ``(h @ w).float()`` recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``), so one (B, chunk, V) f32 slab is live. The chunk
    sums add up in f32 in chunk order. h holds this data shard's rows; the
    vocab is split over the model axis where the head's is (w holds V_loc <
    ``vocab`` columns: ``_ce_chunk_vocab_parallel``). The shards' sums are
    ``psum``-ed over the data axes and divided by the global B S
    (``n_global``)."""
    s = h.shape[1]
    if s % chunk:
        chunk = s
    v0 = par.m_index * w.shape[1]
    vocab_split = w.shape[1] != vocab
    hc = spmd.copy(h, par.model) if vocab_split else h
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        hi, li = hc[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if vocab_split:
            fn = partial(_ce_chunk_vocab_parallel, v0=v0, group=par.model)
        else:
            fn = _ce_chunk
        part = checkpoint(fn, hi, li, w, use_reentrant=False) if L.records_grad(hi, w) \
            else fn(hi, li, w)
        total = total + part
    return spmd.psum(total, par.data) / n_global


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            loss_chunk: int = 512) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training objective: ``(ce + 0.01 aux, {"ce", "aux"})``, the mean
    next-token cross entropy over B x S positions from the final hidden
    states and the head (``embed.T`` when tied, else ``unembed``) in
    ``loss_chunk`` chunks (``_chunked_ce``; one chunk where it does not
    divide S, as audio's 1,500 frames); ``aux`` is the moe layers' summed
    Switch loss, 0 for the other families. vlm: over the last
    ``tokens.shape[1]`` positions (the text; the vision embeddings come
    first) and their labels, the mean's divisor B x the text length.
    Differentiate with autograd (``launch.steps.make_train_step``). Under a
    mesh the batch is the global one, split over the data axes (which must
    divide it), and the cross entropy vocab-parallel (module doc)."""
    check_trains(cfg)
    parallel.check_mesh(cfg)
    par = parallel.current()
    batch, b_global = local_batch(batch, par)
    if par.d_size > 1 and b_global % par.d_size:
        raise ValueError(f"a train batch of {b_global} does not split over the "
                         f"{par.d_size} data shards")
    params = _gather_tied(params, cfg, par)
    out = _forward(params, batch, cfg, "hidden", par, b_global)
    h, labels = out["hidden"], batch["labels"]
    if cfg.family == "vlm":  # the loss over the text positions only
        ntext = batch["tokens"].shape[1]
        h, labels = h[:, -ntext:], labels[:, -ntext:]
    w = _head(params, cfg, par).to(h.dtype)
    ce = _chunked_ce(h, labels, w, loss_chunk, par, b_global * h.shape[1], cfg.vocab_size)
    total = ce + 0.01 * out["aux_loss"]
    return total, {"ce": ce, "aux": out["aux_loss"]}


def value_and_grad(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, **kw
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]], Params]:
    """``((loss, metrics), grads)`` of :func:`loss_fn` by autograd, the
    counterpart of ``jax.value_and_grad(loss_fn, has_aux=True)``: every
    parameter leaf requires grad for the forward and backward only, and
    ``grads`` mirrors ``params`` (a tied embedding's gradient sums both
    uses; a leaf the loss does not read, zeros). Nothing is read back to
    the host. Under a mesh ``params`` are
    this worker's blocks and so are the gradients: those of the leaves
    replicated over a data axis are summed over it (one all-reduce a group
    and dtype), so each is the block of the full gradient."""
    from ..optim.compression import tree_leaves, tree_map

    check_trains(cfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch, cfg, **kw)
        # a leaf the loss does not read (audio's token embedding: the frames
        # come in through frame_proj) gets zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    finally:
        for p in leaves:
            p.requires_grad_(False)
    if parallel.current().mesh is not None:
        _sum_replicated_grads(grads, cfg)
    metrics = {k: v.detach() for k, v in metrics.items()}
    it = iter(grads)
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def param_specs(cfg: ModelConfig):
    """The spec tree of ``cfg``'s parameters under the active mesh and rules
    (``launch.params.param_pspecs`` of the meta-device shapes), computed
    once a (config, layout, rules): a train step reads it after every
    backward. Shared: not to be changed."""
    return _param_specs(cfg, sharding.context_key())


@lru_cache(maxsize=16)
def _param_specs(cfg: ModelConfig, key):
    from ..launch.mesh import Mesh
    from ..launch.params import param_pspecs

    layout, rules = key
    with sharding.use_mesh(None if layout is None else Mesh(*layout), dict(rules)):
        return param_pspecs(init_params(cfg, device="meta"))


def _sum_replicated_grads(grads, cfg: ModelConfig) -> None:
    """Sum over the data axes, in place, the gradients of the leaves that
    the data axes do not shard, flattened into one buffer a (group, dtype)."""
    from ..launch.params import unsharded_axes
    from ..launch.sharding import data_axes

    par = parallel.current()
    def spec_leaves(tree):  # tree_leaves' order, a spec tuple a leaf
        if isinstance(tree, dict):
            return [leaf for k in sorted(tree) for leaf in spec_leaves(tree[k])]
        if isinstance(tree, list):
            return [leaf for sub in tree for leaf in spec_leaves(sub)]
        return [tree]

    specs = spec_leaves(param_specs(cfg))
    buckets: Dict[tuple, list] = {}
    for g, spec in zip(grads, specs, strict=True):
        axes = unsharded_axes(spec, par.mesh, data_axes())
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        par.mesh.group_of(axes).all_reduce(flat, "sum")
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def _decoder_only(cfg: ModelConfig) -> None:
    check_family(cfg)
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only ({cfg.family}): no decode cache")


def cache_specs(cfg: ModelConfig, batch: int,
                max_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """name -> (shape, dtype) of the decode cache. The ssm family's does not
    grow with ``max_len``: the wkv state and the two token-shift inputs. The
    hybrid family's holds the shared block's k and v at each of its nb
    applications and every Mamba-2 layer's state (f32) and conv window. An
    encoder-only config has none (``ValueError``)."""
    _decoder_only(cfg)
    dt, nl = cfg.torch_dtype, cfg.num_layers
    if cfg.family == "ssm":
        d, hd = cfg.d_model, rwkv6.HEAD
        return {"s": ((nl, batch, d // hd, hd, hd), torch.float32),
                "x_tm": ((nl, batch, d), torch.float32),
                "x_cm": ((nl, batch, d), torch.float32)}
    kv = (cfg.num_kv_heads, max_len, cfg.head_dim_)
    if cfg.family == "hybrid":
        nb = nl // cfg.hybrid_block
        d_inner, nh, hd, n = mamba2.dims(cfg)
        return {"k": ((nb, batch, *kv), dt), "v": ((nb, batch, *kv), dt),
                "mamba_h": ((nl, batch, nh, hd, n), torch.float32),
                "mamba_conv": ((nl, batch, cfg.d_conv - 1, d_inner + 2 * n), dt)}
    return {"k": ((nl, batch, *kv), dt), "v": ((nl, batch, *kv), dt)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache, the allocation of ``cache_specs``."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_specs(cfg, batch, max_len).items()}


def decode_step(params: Params, cache: Dict[str, torch.Tensor], batch: Dict[str, Any],
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence in the batch: tokens (B, 1) at position
    ``cache_pos``, a 0-d integer tensor on the tokens' device, as the
    reference's traced ``jnp.int32(t)`` (a Python int is turned into one; the
    ssm family ignores it); the vlm family's rotation comes from
    ``positions`` (B, 3, 1) instead, as in the reference. Nothing here reads
    the position back to the host, so the step can be captured into a CUDA
    graph and replayed with the position advanced on the device. Returns
    logits (B, 1, V) and the cache, which is updated IN PLACE: each
    attention layer writes the token's k and v at cache_pos, each ssm layer
    its new state and token-shift inputs, each Mamba-2 layer its new state
    and conv window (the reference returns a new cache instead), so the
    returned dict is the one passed in. A moe layer routes the B tokens of
    the step alone (capacity ``moe._capacity(B, ...)``, so no token is
    dropped, where a prefill of the same positions may drop some: moe
    decode after a prefill is not the forward) and discards its aux loss.

    Under a mesh: the global batch's tokens, this worker's block of the
    cache (``launch.steps.cache_pspecs`` of the decode shape), the logits of
    its data shard's rows. Where the cache's sequence dim is split
    (``cache_split``: over the seq axes at global batch 1, over the model
    axis where it does not divide the kv heads), each attention layer
    combines the shards' partial softmaxes (``layers.decode_attention_seq_
    sharded``)."""
    _decoder_only(cfg)
    parallel.check_mesh(cfg)
    par = parallel.current()
    batch, b_global = local_batch(batch, par)
    tokens = batch["tokens"]
    pos = torch.as_tensor(batch["cache_pos"], device=tokens.device)
    if pos.dim() != 0 or pos.dtype.is_floating_point or pos.dtype == torch.bool:
        raise TypeError(f"cache_pos must be a 0-d integer tensor or an int, got {pos.dtype} "
                        f"of shape {tuple(pos.shape)}")
    b = tokens.shape[0]
    params = _gather_tied(params, cfg, par)
    h = _embed_tokens(params, tokens, cfg)
    if cfg.family == "ssm":
        h2 = h[:, 0, :]
        for i, lp in enumerate(params["layers"]):
            y, s_n, x_tm = rwkv6.time_mix_decode(
                lp["tm_cm"], L.rms_norm(h2, lp["ln1"], cfg.norm_eps), cfg, cache["x_tm"][i],
                cache["s"][i])
            h2 = h2 + y
            cm, x_cm = rwkv6.channel_mix_decode(
                lp["tm_cm"], L.rms_norm(h2, lp["ln2"], cfg.norm_eps), cache["x_cm"][i])
            h2 = h2 + cm
            cache["s"][i].copy_(s_n)
            cache["x_tm"][i].copy_(x_tm)
            cache["x_cm"][i].copy_(x_cm)
        h = L.rms_norm(h2[:, None, :], params["final_norm"], cfg.norm_eps)
        return _unembed(params, h, cfg), cache
    if cfg.family == "vlm":
        angles = L.mrope_angles(torch.as_tensor(batch["positions"], device=tokens.device),
                                cfg.head_dim_, cfg.rope_theta, cfg.mrope_sections)
    else:
        positions = pos.to(torch.int64).reshape(1, 1).expand(b, 1)
        angles = L.rope_angles(positions, cfg.head_dim_, cfg.rope_theta)

    split = cache_split(cfg, par, b_global)

    def attend(hh, lp, i):
        return _attn_mlp_block(hh, lp, angles, cfg, cache=(cache["k"][i], cache["v"][i]),
                               cache_pos=pos, cache_split=split)[0]

    if cfg.family == "hybrid":
        hb = cfg.hybrid_block
        for i in range(cfg.num_layers // hb):
            for li in range(i * hb, (i + 1) * hb):
                lp = params["layers"][li]
                y, new = mamba2.mamba_decode_step(
                    lp["mamba"], L.rms_norm(h, lp["ln"], cfg.norm_eps),
                    mamba2.MambaCache(h=cache["mamba_h"][li], conv=cache["mamba_conv"][li]), cfg)
                h = h + y
                cache["mamba_h"][li].copy_(new.h)
                # new.conv is a view of a fresh buffer: no overlap with the window
                cache["mamba_conv"][li].copy_(new.conv)
            h = attend(h, params["shared"], i)
    else:
        for i, lp in enumerate(params["layers"]):
            h = attend(h, lp, i)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(params, h, cfg), cache


def param_count(params: Params) -> int:
    """Number of parameters (a tied embedding counts once)."""
    def count(tree: Optional[Any]) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return sum(count(v) for v in tree)
    return count(params)
