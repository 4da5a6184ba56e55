"""The local view of the active mesh for the LM layers: which block of each
tensor this worker holds, and the collectives between blocks
(``comm.spmd``).

Layout (the "tp" profile): the batch is split over the data axes (when it
divides; else every data shard holds all of it), activations between the
layers are replicated over the model axis, weights are sharded as
``launch.params`` says: a dim of a leaf is sharded where its local size is
smaller than the full one. Column-parallel weights give each model shard
its heads or MLP columns, row-parallel ones partial sums that
``spmd.psum`` adds up; the FSDP dim of a weight is gathered over the data
axes before use (``spmd.gather``, whose backward sums the data shards'
gradients). A leaf replicated over a data axis gets its data shards'
gradients summed after the backward (``launch.steps``).

Each layer has one body, written for the blocks. Without a mesh, and on a
mesh of one worker, :func:`current` is the trivial ``Par`` (every axis of
one worker, no group): each collective is then the identity and each
block the whole leaf, so the layers run the unsharded ops with the
unsharded bits. A collective runs only along axes of more than one worker.
"""
from __future__ import annotations

import torch

from ..comm import spmd
from ..launch import sharding
from ..specs import NotYetPorted


class Par:
    """The active mesh seen from this worker: ``model`` and ``data`` are the
    groups over the model and data axes (None for an axis of one worker),
    with their sizes and this worker's indices. ``mesh`` None: the trivial
    view (no mesh, or one worker)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.model, self.m_size, self.m_index = self.split(mesh and sharding.model_axes())
        self.data, self.d_size, self.d_index = self.split(mesh and sharding.data_axes())

    def split(self, axes):
        """(group, size, this worker's index) over the mesh axes ``axes``:
        (None, 1, 0) where they hold one worker."""
        if self.mesh is None or not axes:
            return None, 1, 0
        return self.mesh.group_of(axes), self.mesh.axes_size(axes), self.mesh.index(axes)

    def fsdp(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """``w`` with its dim ``dim`` gathered over the data axes where it is
        sharded there (local size below ``full``)."""
        if w.shape[dim] == full:
            return w
        return spmd.gather(w, dim, self.data)

    def cols(self, w: torch.Tensor, dim: int, full: int, lo: int, hi: int) -> torch.Tensor:
        """The [lo, hi) block along ``dim`` of a leaf of full size ``full``
        there, for use sharded over the model axis (``pieces``)."""
        return self.pieces(w, dim, full, ((lo, hi),))

    def pieces(self, w: torch.Tensor, dim: int, full: int, spans) -> torch.Tensor:
        """The [lo, hi) blocks ``spans`` along ``dim`` of a leaf of full size
        ``full`` there, concatenated in order (``take``), for use sharded
        over the model axis. A leaf replicated over it is copied in
        (``spmd.copy``: its gradient summed over the model shards); a
        sharded leaf is this worker's block where the spans are exactly that
        block, or else gathered first (``spmd.gather``: a block a model shard
        uses gets the sum of their gradients). Whether the gather runs
        depends on this worker's block, so the caller must make the same
        choice on every model shard: each asks for its own block, or none
        does (else the shards' collectives part). A Mamba-2 shard's heads
        take columns of several blocks of its fused leaves this way."""
        merged = _merge(spans)
        n, base = w.shape[dim], 0
        if n == full:
            w = spmd.copy(w, self.model)
        elif merged == [(self.m_index * n, (self.m_index + 1) * n)]:
            base = self.m_index * n
        else:
            w = spmd.gather(w, dim, self.model)
        return take(w, dim, [(lo - base, hi - base) for lo, hi in merged])

    def model_block(self, full: int):
        """(lo, hi) of this model shard's block of ``full`` equal parts."""
        n = full // self.m_size
        return self.m_index * n, (self.m_index + 1) * n


def _merge(spans):
    """``spans`` in order with adjacent ones joined."""
    merged = []
    for lo, hi in spans:
        if merged and merged[-1][1] == lo:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def take(w: torch.Tensor, dim: int, spans) -> torch.Tensor:
    """The [lo, hi) blocks ``spans`` of ``w`` along ``dim``, concatenated in
    order: ``w`` itself where they cover it whole, a view where they are
    one block (adjacent spans joined first)."""
    merged = _merge(spans)
    if merged == [(0, w.shape[dim])]:
        return w
    parts = [w.narrow(dim, lo, hi - lo) for lo, hi in merged]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def current() -> Par:
    """The active mesh as a :class:`Par`; the trivial one without a mesh or
    on one worker."""
    mesh = sharding.active_mesh()
    return Par(mesh if mesh is not None and mesh.size > 1 else None)


def check_mesh(cfg) -> None:
    """Raise ``NotYetPorted`` before any device work where the active mesh
    asks for what the port does not run: a sequence-sharded activation
    profile (``sp``, ``msp``), or a width that the model axis does not
    divide (the q columns, the MLP's hidden width, the experts; RWKV-6's D
    and hidden width; Mamba-2's heads, conv channels and fused input
    projection). Attention head counts need not divide it
    (``layers.head_ranges``). Every family runs under a mesh."""
    mesh = sharding.active_mesh()
    if mesh is None or mesh.size <= 1:
        return
    if sharding.axes_size("seq_act") > 1:
        raise NotYetPorted(
            f"{cfg.name}: a sequence-sharded activation profile (seq_act over "
            f"{sharding.axes_size('seq_act')} workers; 'sp'/'msp') is not yet ported to "
            "PyTorch (ROADMAP section 1, Sharded LM paths)")
    m = sharding.axes_size("heads")
    if cfg.family == "ssm":
        dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff}
    else:
        dims = {"q columns": cfg.num_heads * cfg.head_dim_}
        if cfg.family == "moe":
            dims["experts"] = cfg.num_experts
            if cfg.moe_dense_residual:
                dims["d_ff"] = cfg.moe_dense_ff or cfg.d_ff
        else:
            dims["d_ff"] = cfg.d_ff
        if cfg.family == "hybrid":
            from .mamba2 import dims as mamba_dims  # mamba2 imports this module

            d_inner, nh, _, n = mamba_dims(cfg)
            dims.update({"Mamba-2 heads": nh, "conv channels": d_inner + 2 * n,
                         "w_in columns": 2 * d_inner + 2 * n + nh})
    bad = {k: v for k, v in dims.items() if v % m}
    if bad:
        raise NotYetPorted(f"{cfg.name}: {bad} not divisible by the model axis ({m}) under "
                           "a mesh is not yet ported to PyTorch")
