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

#: Families whose layers run under a mesh; the others raise NotYetPorted.
MESH_FAMILIES = ("dense", "moe", "ssm")


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
        there, for use sharded over the model axis. A leaf replicated over
        it is copied in (``spmd.copy``: its gradient summed over the model
        shards); a sharded leaf is this worker's block itself, or else
        gathered first (``spmd.gather``)."""
        n = w.shape[dim]
        if n == full:
            w = spmd.copy(w, self.model)
            return w if (lo, hi) == (0, full) else w.narrow(dim, lo, hi - lo)
        own = self.m_index * n
        if (lo, hi) == (own, own + n):
            return w
        return spmd.gather(w, dim, self.model).narrow(dim, lo, hi - lo)

    def model_block(self, full: int):
        """(lo, hi) of this model shard's block of ``full`` equal parts."""
        n = full // self.m_size
        return self.m_index * n, (self.m_index + 1) * n


def current() -> Par:
    """The active mesh as a :class:`Par`; the trivial one without a mesh or
    on one worker."""
    mesh = sharding.active_mesh()
    return Par(mesh if mesh is not None and mesh.size > 1 else None)


def check_mesh(cfg) -> None:
    """Raise ``NotYetPorted`` before any device work where the active mesh
    asks for what the port does not run: a family outside
    ``MESH_FAMILIES``, a sequence-sharded activation profile (``sp``,
    ``msp``), or a width that the model axis does not divide (the q
    columns, the MLP's hidden width, the experts; RWKV-6's D and hidden
    width). Head counts need not divide it (``layers.head_ranges``)."""
    mesh = sharding.active_mesh()
    if mesh is None or mesh.size <= 1:
        return
    if cfg.family not in MESH_FAMILIES:
        raise NotYetPorted(
            f"{cfg.name}: family {cfg.family!r} under a mesh is not yet ported to PyTorch "
            f"(ROADMAP section 1, Sharded LM paths); the port shards {MESH_FAMILIES}")
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
    bad = {k: v for k, v in dims.items() if v % m}
    if bad:
        raise NotYetPorted(f"{cfg.name}: {bad} not divisible by the model axis ({m}) under "
                           "a mesh is not yet ported to PyTorch")
