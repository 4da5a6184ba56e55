"""PowerSGD low-rank gradient compression with error feedback, the port's
own copy of ``repro.optim.compression``.

It reuses the paper's insight: DFW-Trace sends rank-1 factors (O(d + m))
where a d x m gradient would go; PowerSGD sends rank-r factors of each
large 2-D gradient of a data-parallel sync. Each step is one warm-started
block power step (``core.power_method.block_power_step``, the block:k
solver's primitive) with the aggregate the group mean through the comm
chokepoint: r (d + m) floats on the wire in place of d m. With no group
the mean is the identity (tests, the serial reference).

A gradient tree is a tensor, or dicts (keys in sorted order), lists and
tuples of them; the state's ``q`` and ``error`` trees have the gradients'
structure, with None at each leaf that is not compressed (fewer than 2
dimensions, or fewer than ``min_size`` entries).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..comm.base import WorkerGroup, psum
from ..core.power_method import block_power_step

PyTree = Any


class PowerSGDState(NamedTuple):
    q: PyTree  # per compressed leaf: (m, r) warm-start factors
    error: PyTree  # per compressed leaf: (d, m) error feedback


def tree_leaves(tree: PyTree) -> List[Any]:
    """The leaves of ``tree`` in order (dicts by sorted key); None is a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` of each leaf of ``tree`` (and the leaves at the same place in
    ``rest``, which share its structure), in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def _compressible(leaf: torch.Tensor, min_size: int) -> bool:
    return leaf.dim() >= 2 and leaf.numel() >= min_size


def _as2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) if x.dim() != 2 else x


def init(params: PyTree, *, rank: int = 4, min_size: int = 4096,
         gen: Optional[torch.Generator] = None) -> PowerSGDState:
    """q ~ N(0, 1) (m, rank) and a zero (d, m) error for each compressed
    leaf, drawn from ``gen`` leaf by leaf in order (default: a generator on
    the first leaf's device seeded 0). The reference draws each leaf's q
    from ``fold_in(key, i)``; ``convert.powersgd_state`` carries its draws
    across."""
    leaves = tree_leaves(params)
    if gen is None:
        gen = torch.Generator(device=leaves[0].device if leaves else "cpu")
        gen.manual_seed(0)

    def q_of(p):
        if not _compressible(p, min_size):
            return None
        return torch.randn((_as2d(p).shape[1], rank), generator=gen, device=gen.device,
                           dtype=torch.float32).to(p.device)

    def error_of(p):
        if not _compressible(p, min_size):
            return None
        return torch.zeros(_as2d(p).shape, dtype=torch.float32, device=p.device)

    return PowerSGDState(q=tree_map(q_of, params), error=tree_map(error_of, params))


def compress_and_sync(grads: PyTree, state: PowerSGDState, *, min_size: int = 4096,
                      group: Optional[WorkerGroup] = None) -> Tuple[PyTree, PowerSGDState]:
    """Each large 2-D gradient replaced by its rank-r approximation, averaged
    over the workers of ``group`` (None: one process); the small leaves are
    averaged exactly. Returns ``(synced_grads, new_state)``.

    A compressed leaf runs one warm-started block power step on G + e (the
    error feedback): p = orth(mean(G q)), q' = mean(G^T p), approximation p
    q'^T, new error G + e - p q'^T. The two (d, r) and (m, r) means are the
    leaf's only wire traffic. The products are plain ``torch.matmul``, as
    the reference's are plain XLA."""

    def mean(x: torch.Tensor) -> torch.Tensor:
        if group is None:
            return x
        return psum(x, group) / group.size

    def one(g, q, e):
        if q is None:
            return (g if group is None else mean(g.clone())), None, None
        g2 = _as2d(g).to(torch.float32) + e
        p, q_new = block_power_step(lambda qq: g2 @ qq, lambda pp: g2.T @ pp, q, reduce=mean)
        approx = p @ q_new.T
        return approx.reshape(g.shape).to(g.dtype), q_new, g2 - approx

    outs = [one(g, q, e) for g, q, e in zip(tree_leaves(grads), tree_leaves(state.q),
                                           tree_leaves(state.error))]

    def part(i):
        it = iter([o[i] for o in outs])
        return tree_map(lambda _: next(it), grads)

    return part(0), PowerSGDState(q=part(1), error=part(2))


def wire_bytes(params: PyTree, *, rank: int = 4, min_size: int = 4096) -> Dict[str, int]:
    """Bytes on the wire a sync: dense against compressed (the paper's
    Table-1 analogue)."""
    dense = compressed = 0
    for p in tree_leaves(params):
        nbytes = p.numel() * 4
        if _compressible(p, min_size):
            d, m = _as2d(p).shape
            compressed += 4 * rank * (d + m)
        else:
            compressed += nbytes
        dense += nbytes
    return {"dense": dense, "compressed": compressed}
