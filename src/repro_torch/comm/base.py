"""The collective chokepoint of the port.

Every vector and scalar aggregate of an epoch goes through :func:`psum` /
:func:`pmax` or a reducer's ``exchange`` here, as in the JAX package, so the
places where workers exchange data stay in one module. The workers are the
processes of a ``torch.distributed`` process group, one per data shard,
wrapped in a :class:`WorkerGroup`; ``group=None`` means one process, where
every aggregate is the identity (the "sum" over one worker) and no
collective runs.

A reducer encodes the power method's two vector exchanges per iteration:
:class:`DenseReducer` is the exact f32 sum (``comm="dense"``) and
``comm.int8.Int8Reducer`` the stochastic-rounding int8 sum (``comm="int8"``;
a one-worker run still applies the encoding, as the JAX package's serial
run does). ``exchange(x, state, slot=..., noise=...)`` takes ``noise``, a
function ``noise(dim, device)`` that returns this exchange's uniform [0, 1)
draws for this worker (see ``repro_torch.NoiseStream``); encodings without
randomness ignore it. Every reducer counts its exchanges, so a run can show
that an epoch with K power iterations made exactly 2K of them.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..specs import NotYetPorted, parse_comm

Noise = Optional[Callable[[int, torch.device], torch.Tensor]]


class WorkerGroup:
    """This process's place among the workers: a thin wrapper of a
    ``torch.distributed`` process group (default: the world group, which
    must be initialized).

    ``rank``/``size`` are this worker's index and the worker count;
    ``all_reduces`` counts the all-reduces it ran. Collectives run on
    whatever device the caller's tensor lies on, and enqueue without waiting
    for the host (NCCL on the card; gloo stages CUDA tensors through the
    host inside ``torch.distributed``).
    """

    def __init__(self, process_group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialized: call init_process_group first "
                "(launch.dfw.run_workers does), or pass group=None for one process"
            )
        self._dist = dist
        self.process_group = process_group if process_group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.process_group)
        self.size = dist.get_world_size(self.process_group)
        self.all_reduces = 0

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (``op="sum"``) or maxed (``"max"``) over the workers,
        in place; returns ``x``."""
        ops = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX}
        self.all_reduces += 1
        self._dist.all_reduce(x, op=ops[op], group=self.process_group)
        return x

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's ``x`` (the same shape on each) stacked along dim 0
        in rank order: the row blocks of a sharded array, reassembled."""
        parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x.contiguous(), group=self.process_group)
        return torch.cat(parts)


def psum(x: torch.Tensor, group: Optional[WorkerGroup] = None) -> torch.Tensor:
    """Sum of ``x`` over the workers (``group=None``: ``x`` itself). The sum
    is taken in place: every caller hands in a fresh local contribution."""
    return x if group is None else group.all_reduce(x, "sum")


def pmax(x: torch.Tensor, group: Optional[WorkerGroup] = None) -> torch.Tensor:
    """Max of ``x`` over the workers (``group=None``: ``x`` itself), in place."""
    return x if group is None else group.all_reduce(x, "max")


class DenseReducer:
    """Exact f32 sum, the paper's master aggregate; its state is ``()``."""

    spec = "dense"

    def __init__(self, group: Optional[WorkerGroup] = None):
        self.group = group
        self.exchanges = 0

    def init_state(self, d: int, m: int):
        return ()

    def exchange(self, x: torch.Tensor, state, *, slot: str, noise: Noise = None):
        """(sum over workers of ``x``, new state); ``slot`` is "u" or "v"."""
        self.exchanges += 1
        return psum(x, self.group), state

    def wire_bytes(self, dim: int, num_workers: int) -> int:
        return 2 * 4 * dim  # ring all-reduce: 2x the f32 vector


def make_reducer(spec: str, *, num_workers: int = 1, group: Optional[WorkerGroup] = None):
    """``"dense"`` -> :class:`DenseReducer`, ``"int8"`` -> ``Int8Reducer``
    sized for ``num_workers``, both summing over ``group``; other valid
    specs are not ported."""
    c = parse_comm(spec)
    if group is not None and group.size != num_workers:
        raise ValueError(f"num_workers={num_workers} but the group has {group.size} workers")
    if c.kind == "dense":
        return DenseReducer(group)
    if c.kind == "int8":
        from .int8 import Int8Reducer

        return Int8Reducer(num_workers=num_workers, group=group)
    raise NotYetPorted(f"comm {c.spec!r} is not yet ported to PyTorch")
