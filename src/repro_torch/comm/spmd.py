"""Autograd-aware collectives over a mesh's axis groups: the explicit
counterparts of the layout changes that the reference's GSPMD inserts
(Megatron's f/g pairs and the ZeRO-3 gather).

Each process holds local blocks; a tensor is *replicated* over a group when
every worker of the group holds the same values, *partial* when the workers'
values are addends of the true one, and *sharded* when each holds a block.
The rule the model code keeps: a tensor replicated over a group carries the
same, full gradient on every worker of it. So

- :func:`copy` (forward identity, backward all-reduce) sits where a
  replicated tensor enters computation sharded over the group (a
  column-parallel product, a slice of local heads): each worker's gradient
  is a part, and the all-reduce makes it whole;
- :func:`psum` (forward all-reduce, backward identity) turns the partial
  outputs of a row-parallel product into the replicated sum;
- :func:`gather` (forward all-gather, backward reduce-scatter of the sum)
  assembles a sharded tensor whose uses are partial on each worker: the
  FSDP weight gather over the data axes (each data shard's gradient covers
  its rows of the batch) and blocks taken from a gathered tensor;
- :func:`gather_replicated` (forward all-gather, backward the local block)
  assembles a sharded tensor for computation replicated over the group;
- :func:`scatter` (forward reduce-scatter of the sum along a dim, backward
  all-gather) is Megatron's sequence-parallel exit, the counterpart of
  ``psum`` where the result is split along that dim (the sequence): the
  partial outputs of a row-parallel product land summed on each worker's
  block of rows;
- :func:`split` (forward this worker's block of a replicated tensor along a
  dim, backward all-gather) turns a replicated tensor whose gradient is
  whole on every worker into blocks: each worker's gradient of its block
  gathered back is the whole gradient again;
- :func:`pmax` (forward all-reduce max) carries no gradient.

Under a sequence split (``models.parallel``) :func:`gather` along the
sequence is the entry that :func:`copy` is for a replicated tensor, and
:func:`scatter` the exit that :func:`psum` is.

``group`` is a ``comm.WorkerGroup`` or None; None (an axis of one worker)
is the identity, with no collective. Every collective goes through the
group, so its ``tally`` counts it, backward passes included.
"""
from __future__ import annotations

import torch


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone(), "sum"), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return ctx.group.reduce_scatter(g, ctx.dim), None, None, None
        n = g.shape[ctx.dim] // ctx.group.size
        return g.narrow(ctx.dim, ctx.group.rank * n, n).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return group.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced (sum) over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (a new tensor); the gradient passes unchanged."""
    return x if group is None else _Psum.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather along ``dim`` in rank order; the gradient is
    reduce-scattered (summed over ``group``, this worker's block kept)."""
    return x if group is None else _Gather.apply(x, dim % x.dim(), group, True)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather along ``dim`` for computation replicated over
    ``group``: the gradient, the same on every worker, is cut to this
    worker's block."""
    return x if group is None else _Gather.apply(x, dim % x.dim(), group, False)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, cut along ``dim`` into one block a
    worker in rank order: this worker's (a new tensor); the gradient is
    all-gathered."""
    return x if group is None else _Scatter.apply(x, dim % x.dim(), group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This worker's block along ``dim`` (rank order) of ``x``, replicated
    over ``group`` (a new tensor); the gradient is all-gathered."""
    return x if group is None else _Split.apply(x, dim % x.dim(), group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Max over ``group`` of ``x`` (detached: no gradient)."""
    x = x.detach()
    return x if group is None else group.all_reduce(x.clone(), "max")

