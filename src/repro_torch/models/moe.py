"""Mixture-of-experts layer (arctic-480b, llama4-scout): capacity-bounded
top-k routing, the batched expert MLP and the Switch load-balance loss. The
port's counterpart of ``repro.models.moe``.

Each expert takes at most C tokens (``_capacity``): the tokens routed to it
with the largest gates, the rest dropped (Switch/GShard semantics). Shapes
are static, as in the reference: every expert runs its MLP on C slots, some
of them empty (gate 0), so nothing here reads a count back to the host and
the decode step can be captured into a CUDA graph.

The router, the selection and the combine are plain PyTorch, and the
expert products are ``torch.bmm``: the reference computes them in plain jnp
too, with no Pallas kernel.

Training: the layer is differentiated by autograd, as ``jax.grad`` takes
the reference's. The dispatch (the slots' tokens) and the combine (the
slots' outputs back to their tokens) are ``torch.autograd.Function``s
whose backward is also a gather, through the token -> slot map
(``_slots``): the k picks' gradients added in pick order, an empty slot's
dropped. The gathers' own backward would be ``index_add_``, whose float
atomics give other bits from run to run on the card.

Under a mesh (expert parallelism, the reference's ``shard_map`` body): each
model shard holds E / |model| experts, their dim 1 split over the data
axes; it gathers that dim (ZeRO-3), routes its data shard's tokens (the
same on every model shard) to its own experts with a capacity from the
data shard's token count, and the ``psum`` over the model axis adds the
shards' outputs; the aux loss is the mean over the data shards. A token
routed to an expert of another shard adds nothing here, so the capacity
and the drops are per data shard, as in the reference, and differ from one
device's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..comm import spmd
from . import parallel
from .layers import normal

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype, device, keep=None) -> Params:
    """The reference's leaves and scales: ``router`` (D, E), always f32,
    ``wg`` and ``wu`` (E, D, F) times D^-0.5, ``wd`` (E, F, D) times
    F^-0.5. The scales are applied in place: an arctic layer's three expert
    tensors are 8.9 GB each in bf16. ``keep(tensor, name)``, when given,
    replaces each leaf as soon as it is drawn (a sharded run's block)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    std = d**-0.5
    keep = keep or (lambda t, name: t)
    out = {}
    for name, shape, dt, scale in (("router", (d, e), torch.float32, std),
                                   ("wg", (e, d, f), dtype, std), ("wu", (e, d, f), dtype, std),
                                   ("wd", (e, f, d), dtype, f**-0.5)):
        out[name] = keep(normal(gen, shape, dt, device).mul_(scale), name)
    return out


def _capacity(n_loc: int, k: int, e: int, factor: float) -> int:
    """Slots per expert: ceil(n k / E * factor), raised to a multiple of 8
    (at least 8) and capped at n, exactly as the reference: which tokens
    are dropped depends on it."""
    c = int(math.ceil(n_loc * k / e * factor))
    c = max(8, ((c + 7) // 8) * 8)
    return min(c, n_loc)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (the first k of a stable sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """The router: f32 logits ``x.float() @ router``, their softmax and its
    top k. Returns (probs (n, E), gate (n, k), eidx (n, k))."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    gate, eidx = top_k(probs, k)
    return probs, gate, eidx


def select(gate: torch.Tensor, eidx: torch.Tensor, e_loc: int, expert_offset: int,
           capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each local expert's tokens: ``score[e, t]`` is token t's gate if t
    was routed to expert ``expert_offset + e``, else -1; the top
    ``capacity`` of each row. Returns (sel_gate, sel_idx), both (E_loc, C);
    a slot is valid where ``sel_gate > -0.5``."""
    eid = expert_offset + torch.arange(e_loc, device=eidx.device)
    routed = eidx[None, :, :] == eid[:, None, None]  # (E_loc, n, k)
    score = torch.where(routed, gate[None], -1.0).amax(dim=-1)  # (E_loc, n)
    return top_k(score, capacity)


def _slots(sel_idx: torch.Tensor, valid: torch.Tensor, eidx: torch.Tensor,
           expert_offset: int) -> torch.Tensor:
    """The inverse of the selection: ``at[t, j]``, the flat slot (e C + c)
    of token t's j-th pick among the local experts, or E_loc C (the zero
    row) where the pick is another shard's expert or its expert dropped the
    token. Each valid slot is named by exactly one (t, j); no empty one is."""
    e_loc, cap = sel_idx.shape
    n = eidx.shape[0]
    empty = e_loc * cap
    flat = torch.arange(empty, device=sel_idx.device).view(e_loc, cap)
    # slot_of[e, t]: the flat slot of token t in expert e, or the zero row
    slot_of = torch.full((e_loc, n), empty, dtype=torch.int64, device=sel_idx.device)
    slot_of.scatter_(1, sel_idx, torch.where(valid, flat, empty))
    local = eidx - expert_offset  # (n, k)
    mine = (local >= 0) & (local < e_loc)
    at = torch.gather(slot_of, 0, local.clamp(0, e_loc - 1).T).T  # (n, k)
    return torch.where(mine, at, empty)


def _pick_sum(rows: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """out[t] = the sum over j, in pick order, of ``rows`` (S, D) at row
    ``at[t, j]``; row S reads zeros. A gather: no two threads add into one
    place, so the bits do not depend on the device's schedule."""
    n, k = at.shape
    d = rows.shape[-1]
    picked = torch.cat([rows, rows.new_zeros((1, d))]).index_select(0, at.reshape(-1))
    picked = picked.view(n, k, d)
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """xg = x[sel_idx] (the slots' tokens, empty slots included). Backward:
    token t's gradient is the sum of its valid slots' gradients in pick
    order (``_pick_sum`` through ``_slots``' map), where ``index_select``'s
    own backward is an ``index_add_`` (float atomics on the card, and a
    token in k = 2 slots). An empty slot's gradient is dropped: its expert
    output is multiplied by the gate 0, so its gradient is an exact +-0
    (for finite values), which adds nothing to the reference's sum."""

    @staticmethod
    def forward(ctx, x, sel_flat, at):
        ctx.save_for_backward(at)
        return x.index_select(0, sel_flat)

    @staticmethod
    def backward(ctx, g):
        (at,) = ctx.saved_tensors
        return _pick_sum(g, at), None, None


class _Combine(torch.autograd.Function):
    """out = ``_pick_sum(ye, at)``. Backward: a valid slot's gradient is its
    token's (the one (t, j) that names it), an empty slot's zero: a gather
    through the selection, where the gather's own backward would pile every
    empty pick's addend onto the zero row with atomics."""

    @staticmethod
    def forward(ctx, ye, at, sel_flat, valid_flat):
        ctx.save_for_backward(sel_flat, valid_flat)
        return _pick_sum(ye, at)

    @staticmethod
    def backward(ctx, g):
        sel_flat, valid_flat = ctx.saved_tensors
        gy = torch.where(valid_flat[:, None], g.index_select(0, sel_flat),
                         torch.zeros((), dtype=g.dtype, device=g.device))
        return gy, None, None, None


def _combine(ye: torch.Tensor, sel_idx: torch.Tensor, valid: torch.Tensor,
             eidx: torch.Tensor, expert_offset: int, at=None) -> torch.Tensor:
    """out[t] = the sum of ye over the valid slots that hold token t, the
    reference's scatter-add into zeros of the storage dtype, as a gather
    with no atomics. A token sits in at most one slot of each expert (each
    row of ``sel_idx`` is distinct) and in valid slots only of its k picks,
    so its row has at most k nonzero addends; every other addend of the
    reference's scatter is an exact +-0 (an invalid slot's ye times gate 0).
    Adding +-0 to a value or to +0 leaves it, and two values commute, so for
    k <= 2 the reference's sum equals this one in any order: ye's rows
    gathered at each pick's slot (``_slots``; an empty pick reads a zero
    row), added in pick order. Its backward is a gather too
    (``_Combine``). ``at``: ``_slots``' map, when the caller has it."""
    e_loc, cap, d = ye.shape
    if at is None:
        at = _slots(sel_idx, valid, eidx, expert_offset)
    return _Combine.apply(ye.reshape(e_loc * cap, d), at, sel_idx.reshape(-1),
                          valid.reshape(-1))


def _moe_math(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, *, k: int, num_experts: int, expert_offset: int,
              capacity: int, model=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's dispatch, expert MLP and combine, step by step as the
    reference's: x (n, D) tokens, ``router`` (D, E) f32, the local experts'
    ``wg``/``wu`` (E_loc, D, F) and ``wd`` (E_loc, F, D). The expert
    products are batched in the storage dtype; the gated outputs are cast
    to x's dtype and combined there. Returns (out (n, D), the Switch loss
    E * sum_e frac_e * mean_p_e ()).

    Under autograd the gates carry gradient (through the selection's
    values; its indices carry none) and so does the Switch loss (through
    the mean probabilities), and the dispatch and the combine take their
    gradients by gathers (``_Dispatch``, ``_Combine``): no float atomics,
    so a train step repeats its bits on the card. ``model``: the model
    axis's group where the experts are split over it: the gates and the
    dispatched tokens then enter the shard's own experts through
    ``spmd.copy`` (their gradients, partial on each shard, summed), while
    the router and the Switch loss, computed alike on every shard, are not."""
    n, d = x.shape
    e_loc = wg.shape[0]
    probs, gate, eidx = route(x, router, k)
    sel_gate, sel_idx = select(spmd.copy(gate, model), eidx, e_loc, expert_offset, capacity)
    valid = sel_gate > -0.5
    at = _slots(sel_idx, valid, eidx, expert_offset)

    xg = _Dispatch.apply(spmd.copy(x, model), sel_idx.reshape(-1), at).view(e_loc, capacity, d)
    h = F.silu(torch.bmm(xg, wg)) * torch.bmm(xg, wu)
    ye = torch.bmm(h, wd)
    ye = (ye * (sel_gate * valid).to(ye.dtype)[..., None]).to(x.dtype)
    out = _combine(ye, sel_idx, valid, eidx, expert_offset, at=at)

    # the share of tokens with e among their picks (each row's picks distinct)
    picked = torch.zeros((n, num_experts), dtype=torch.float32, device=x.device)
    picked.scatter_(1, eidx, 1.0)
    aux = num_experts * torch.sum(picked.mean(dim=0) * probs.mean(dim=0))
    return out, aux


def moe_block(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux ()). x is this data shard's rows
    (all of them without a mesh) and the expert-parallel path runs (module
    doc): capacity from the shard's B S tokens, expert offset model index
    x E / |model|. Differentiable, with or without a mesh (``_moe_math``):
    under a mesh the ``psum`` of the shards' outputs passes the gradient
    to every shard, the expert weights' data-axis gather sums their
    gradients over the data shards, and the Switch loss's mean over the
    data shards gives each its share."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(b * s, k, e, cfg.moe_capacity_factor)
    par = parallel.current()
    f = p["wg"].shape[2]  # never sharded
    wg, wu, wd = (par.fsdp(p[n], 1, full) for n, full in (("wg", d), ("wu", d), ("wd", f)))
    out, aux = _moe_math(x.reshape(b * s, d), p["router"], wg, wu, wd, k=k, num_experts=e,
                         expert_offset=par.m_index * wg.shape[0], capacity=cap,
                         model=par.model)
    out = spmd.psum(out, par.model)
    aux = spmd.psum(aux, par.data) / par.d_size
    return out.reshape(b, s, d).to(x.dtype), aux
