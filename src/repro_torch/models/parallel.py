"""The local view of the active mesh for the LM layers: which block of each
tensor this worker holds, and the collectives between blocks
(``comm.spmd``).

Layout (the "tp" profile): the batch is split over the data axes (when it
divides; else every data shard holds all of it), activations between the
layers are replicated over the model axis, weights are sharded as
``launch.params`` says: a dim of a leaf is sharded where its local size is
smaller than the full one. Column-parallel weights give each model shard
its heads or MLP columns, row-parallel ones partial sums that
``spmd.psum`` adds up; the FSDP dim of a weight is gathered over the axes
that shard it before use (``spmd.gather``, whose backward sums the shards'
gradients). A leaf replicated over a data axis gets its data shards'
gradients summed after the backward (``models.lm``).

The sequence-parallel profiles split the activations' sequence dim over
the "seq_act" axes (the model axis), a block of S / m rows a worker:

- "msp" (Megatron's sequence parallelism): the heads and MLP columns stay
  split as in "tp"; a layer gathers its input's rows over the model axis
  where "tp" enters through ``spmd.copy`` (:meth:`Par.enter`), and
  reduce-scatters the row-parallel output onto its rows where "tp" runs
  ``spmd.psum`` (:meth:`Par.leave`).
- "sp": no head or MLP split; every weight's FSDP dim goes over the data
  and model axes. A layer runs on its own rows; attention gathers K and V
  over the sequence and masks at the rows' offset (``layers``).

The recurrent blocks (RWKV-6, Mamba-2) run on the whole sequence, gathered
over the model axis, and keep their rows at the end (:meth:`Par.leave` with
``whole``). Under a sequence split every tensor computed from a gathered
one carries, on each worker, a part of its gradient (its rows', or its
heads'), and a leaf that the model axis does not shard gets the sum of the
workers' parts after the backward, over the data and "seq_act" axes alike
(``models.lm``); so a replicated leaf enters a column-parallel product
without ``spmd.copy`` there (:meth:`Par.cols`).

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
    groups over the model (the experts', the vocabulary's) and data axes,
    ``tp`` over the axes splitting the heads and MLP columns (the model
    axis; none under "sp"), ``seq`` over the "seq_act" axes (the model axis
    under "sp" and "msp"), each None for an axis of one worker, with their
    sizes and this worker's indices. ``mesh`` None: the trivial view (no
    mesh, or one worker)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.model, self.m_size, self.m_index = self.split(mesh and sharding.model_axes())
        self.data, self.d_size, self.d_index = self.split(mesh and sharding.data_axes())
        self.tp, self.t_size, self.t_index = self.split(mesh and sharding.head_axes())
        self.seq, self.s_size, self.s_index = self.split(mesh and sharding.seq_act_axes())
        self._fsdp, self._f_size, _ = self.split(mesh and sharding.fsdp_axes())
        # the group a replicated leaf's gradient is summed over where it
        # enters a column-parallel product; under a sequence split the sum
        # after the backward covers it (module doc)
        self._leaf = self.tp if self.seq is None else None

    def split(self, axes):
        """(group, size, this worker's index) over the mesh axes ``axes``:
        (None, 1, 0) where they hold one worker."""
        if self.mesh is None or not axes:
            return None, 1, 0
        return self.mesh.group_of(axes), self.mesh.axes_size(axes), self.mesh.index(axes)

    def fsdp(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """``w`` with its dim ``dim`` gathered over the axes that shard it
        there (local size below ``full``): the data axes, or every FSDP axis
        (under "sp" the data and model axes; a moe expert tensor, whose
        expert dim holds the model axis, the data axes alone)."""
        n = w.shape[dim]
        if n == full:
            return w
        if n * self.d_size == full:
            return spmd.gather(w, dim, self.data)
        if n * self._f_size != full:
            raise ValueError(f"a dim of {full} held as {n}: no FSDP axes of this mesh give it")
        return spmd.gather(w, dim, self._fsdp)

    def cols(self, w: torch.Tensor, dim: int, full: int, lo: int, hi: int) -> torch.Tensor:
        """The [lo, hi) block along ``dim`` of a leaf of full size ``full``
        there, for use split like the heads (``pieces``)."""
        return self.pieces(w, dim, full, ((lo, hi),))

    def pieces(self, w: torch.Tensor, dim: int, full: int, spans) -> torch.Tensor:
        """The [lo, hi) blocks ``spans`` along ``dim`` of a leaf of full size
        ``full`` there, concatenated in order (``take``), for use split like
        the heads (over ``tp``). A leaf replicated there is copied in
        (``spmd.copy``: its gradient summed over the head shards; under a
        sequence split the sum after the backward does that); a sharded
        leaf is this worker's block where the spans are exactly that block,
        or else gathered first (``spmd.gather``: a block a shard uses gets
        the sum of their gradients). Whether the gather runs depends on
        this worker's block, so the caller must make the same choice on
        every shard: each asks for its own block, or none does (else the
        shards' collectives part). A Mamba-2 shard's heads take columns of
        several blocks of its fused leaves this way."""
        merged = _merge(spans)
        n, base = w.shape[dim], 0
        if n == full:
            w = spmd.copy(w, self._leaf)
        elif merged == [(self.t_index * n, (self.t_index + 1) * n)]:
            base = self.t_index * n
        else:
            w = spmd.gather(w, dim, self.tp)
        return take(w, dim, [(lo - base, hi - base) for lo, hi in merged])

    def model_block(self, full: int):
        """(lo, hi) of this worker's block of ``full`` equal parts split like
        the heads (the whole of it where nothing splits them)."""
        n = full // self.t_size
        return self.t_index * n, (self.t_index + 1) * n

    # -- the sequence split (module doc) -----------------------------------

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence (dim 1) from every worker's rows
        (``spmd.gather``: each worker's use of it a part of its gradient);
        ``x`` itself off a sequence split."""
        return spmd.gather(x, 1, self.seq)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A whole-sequence ``x`` entering a product split like the heads:
        ``spmd.copy`` over them, or, where ``x`` was gathered over the
        sequence (whose backward sums the parts), ``x`` itself."""
        return spmd.copy(x, self.tp) if self.seq is None else x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a position-wise layer from ``x`` in the residual
        layout (this worker's rows under a sequence split): "tp" copies it
        in, "msp" gathers the sequence, "sp" keeps the rows."""
        if self.seq is not None and self.tp is None:
            return x
        return self.copy_in(self.gather_seq(x))

    def leave(self, y: torch.Tensor, *, whole: bool = False) -> torch.Tensor:
        """A layer's output back to the residual layout: the ``psum`` of the
        partial outputs ("tp"), their sum scattered onto this worker's rows
        ("msp"), or, under "sp", the rows themselves (``whole``: y covers
        the whole sequence, and this worker's rows are kept)."""
        if self.seq is None:
            return spmd.psum(y, self.tp)
        if self.tp is not None:
            return spmd.scatter(y, 1, self.seq)
        return self.rows(y) if whole else y

    def rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This worker's block of the sequence along ``dim`` of a tensor
        that every worker holds whole (a view; its gradient this worker's
        part); ``t`` itself off a sequence split."""
        if self.seq is None:
            return t
        n = t.shape[dim] // self.s_size
        return t.narrow(dim, self.s_index * n, n)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence from every worker's rows, for computation that
        every worker then runs alike (``spmd.gather_replicated``); ``x``
        itself off a sequence split."""
        return spmd.gather_replicated(x, 1, self.seq)


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


def check_mesh(cfg, seq_len: int = None) -> None:
    """Raise ``NotYetPorted`` before any device work where the active mesh
    asks for what the port does not run: a sequence of ``seq_len`` > 1
    positions that the "seq_act" axes do not divide (profiles "sp", "msp";
    one token is held whole), a "seq_act" split over other axes than the
    heads' and the vocabulary's, or a width that the axes splitting the
    heads do not divide (the q columns, the MLP's hidden width, the experts
    over the model axis; RWKV-6's D and hidden width; Mamba-2's heads, conv
    channels and fused input projection). Attention head counts need not
    divide it (``layers.head_ranges``). Every family runs under a mesh, in
    every profile."""
    mesh = sharding.active_mesh()
    if mesh is None or mesh.size <= 1:
        return
    s_act = sharding.axes_size("seq_act")
    if s_act > 1:
        axes = sharding.seq_act_axes()
        if sharding.head_axes() not in ((), axes) or sharding.model_axes() != axes:
            raise NotYetPorted(f"{cfg.name}: 'seq_act' over {axes} beside heads over "
                               f"{sharding.head_axes()} and experts over "
                               f"{sharding.model_axes()} is not yet ported to PyTorch")
        if seq_len is not None and seq_len > 1 and seq_len % s_act:
            raise NotYetPorted(f"{cfg.name}: a sequence of {seq_len} positions does not split "
                               f"over the {s_act} workers of the 'seq_act' axes {axes}; a "
                               "sequence the axis does not divide is not yet ported to PyTorch")
    m = sharding.axes_size("heads")
    e = sharding.axes_size("expert")
    if cfg.family == "ssm":
        dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff}
    else:
        dims = {"q columns": cfg.num_heads * cfg.head_dim_}
        if cfg.family == "moe":
            if cfg.num_experts % e:
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
    bad = {k: v for k, v in dims.items() if k == "experts" or v % m}
    if bad:
        raise NotYetPorted(f"{cfg.name}: {bad} not divisible by the model axis ({max(m, e)}) "
                           "under a mesh is not yet ported to PyTorch")
