"""The collective chokepoint of the port.

Every vector and scalar aggregate of an epoch goes through :func:`psum` /
:func:`pmax`, a reducer's ``exchange`` or a topology's here, as in the JAX
package, so the places where workers exchange data stay in one module. The
workers are the processes of a ``torch.distributed`` process group, one per
data shard, wrapped in a :class:`WorkerGroup`; ``group=None`` means one
process, where every aggregate is the identity (the "sum" over one worker)
and no collective runs.

A reducer encodes the power method's two vector exchanges per iteration:
:class:`DenseReducer` is the exact f32 sum (``comm="dense"``),
``comm.int8.Int8Reducer`` the stochastic-rounding int8 sum (``comm="int8"``;
a one-worker run still applies the encoding, as the JAX package's serial
run does) and ``comm.topk.TopKReducer`` the top-r sparsification with
error feedback (``comm="topk:r"``). ``exchange(x, state, slot=...,
noise=..., weight=...)`` takes ``noise``, a function ``noise(dim, device)``
that returns this exchange's uniform [0, 1) draws for this worker (see
``repro_torch.NoiseStream``), and ``weight``, this worker's straggler weight
(None: full participation); encodings without randomness or state ignore
them. Every reducer counts its exchanges, so a run can show that an epoch
with K power iterations made exactly 2K of them. ``comm.topology`` builds
the graph the exchanges run over (flat, gossip, hier).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..specs import parse_comm

Noise = Optional[Callable[[int, torch.device], torch.Tensor]]

#: The collective kinds a ``WorkerGroup`` counts, with their byte
#: conventions (``benchmarks/comm_cost.py``'s): an all-reduce moves twice its
#: payload (ring), an all-gather its gathered output, a send or a broadcast
#: its payload.
KINDS = ("all_reduce", "all_gather", "send", "broadcast")


class Tally:
    """Calls and bytes by collective kind, shared by a group and the
    subgroups split from it."""

    def __init__(self):
        self.calls: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.bytes: Dict[str, int] = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += int(nbytes)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


# Subgroups made in this process, by (world group, global ranks). torch names
# a locally synchronised group by its ranks alone, so a second group of the
# same ranks would meet the first one's rendezvous keys in the store and hang
# or connect to stale peers: each rank set's group is made once a process.
_SUBGROUPS: Dict[tuple, object] = {}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class WorkerGroup:
    """This process's place among the workers: a thin wrapper of a
    ``torch.distributed`` process group (default: the world group, which
    must be initialized).

    ``rank``/``size`` are this worker's index and the worker count.
    ``tally`` counts the collectives this process ran, by kind, and their
    bytes (``KINDS``); ``all_reduces`` is its all-reduce count. Collectives
    run on whatever device the caller's tensor lies on, and enqueue without
    waiting for the host (NCCL on the card; gloo stages CUDA tensors of its
    collectives through the host inside ``torch.distributed``, and this class
    stages those of its point-to-point sends, which gloo takes only on the
    host).
    """

    def __init__(self, process_group=None, *, tally: Optional[Tally] = None):
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
        self.tally = tally if tally is not None else Tally()
        self._host_p2p = dist.get_backend(self.process_group) == "gloo"

    @property
    def all_reduces(self) -> int:
        return self.tally.calls["all_reduce"]

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (``op="sum"``) or maxed (``"max"``) over the workers,
        in place; returns ``x``."""
        ops = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX}
        self.tally.add("all_reduce", 2 * _nbytes(x))
        self._dist.all_reduce(x, op=ops[op], group=self.process_group)
        return x

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's ``x`` (the same shape on each) stacked along dim 0
        in rank order: the row blocks of a sharded array, reassembled."""
        parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(self.size)]
        self.tally.add("all_gather", self.size * _nbytes(x))
        self._dist.all_gather(parts, x.contiguous(), group=self.process_group)
        return torch.cat(parts)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` of worker ``src`` on every worker, in place; returns ``x``."""
        self.tally.add("broadcast", _nbytes(x))
        self._dist.broadcast(x, self._global(src), group=self.process_group)
        return x

    def _global(self, rank: int) -> int:
        if self.process_group == self._dist.group.WORLD:
            return rank
        return self._dist.get_global_rank(self.process_group, rank)

    def shift(self, x: torch.Tensor, offsets: Sequence[int]) -> List[torch.Tensor]:
        """For each offset o: send ``x`` to worker (rank + o) mod N and
        receive worker (rank - o) mod N's ``x``, all in one batch of
        point-to-point ops (``batch_isend_irecv``); returns the received
        vectors in offset order. No two offsets may name the same peer."""
        peers = [(self.rank + o) % self.size for o in offsets]
        if len(set(peers)) != len(peers) or self.rank in peers:
            raise ValueError(f"offsets {list(offsets)} name a peer twice (or this worker) "
                             f"among {self.size} workers")
        host = self._host_p2p and x.is_cuda
        wire = x.to("cpu", copy=True).contiguous() if host else x.contiguous()
        got = [torch.empty_like(wire) for _ in offsets]
        ops = []
        for o, buf in zip(offsets, got):
            ops.append(self._dist.P2POp(self._dist.isend, wire, self._global((self.rank + o) % self.size),
                                        group=self.process_group))
            ops.append(self._dist.P2POp(self._dist.irecv, buf, self._global((self.rank - o) % self.size),
                                        group=self.process_group))
            self.tally.add("send", _nbytes(wire))
        for req in self._dist.batch_isend_irecv(ops):
            req.wait()
        return [buf.to(x.device) for buf in got] if host else got

    def split(self, parts: Sequence[Sequence[int]]) -> "WorkerGroup":
        """The subgroup of the partition ``parts`` (lists of this group's
        ranks) that holds this worker. Every worker calls ``split`` with the
        same ``parts``: each part's process group is made in ``parts``'
        order (``new_group`` with group-local synchronization, so workers
        outside this group need not take part), once a process (later
        splits into the same ranks reuse it). The subgroup shares this
        group's ``tally``."""
        mine = None
        for part in parts:
            key = (id(self._dist.group.WORLD), tuple(self._global(r) for r in part))
            if key not in _SUBGROUPS:
                _SUBGROUPS[key] = self._dist.new_group(list(key[1]), use_local_synchronization=True)
            if self.rank in part:
                mine = _SUBGROUPS[key]
        if mine is None:
            raise ValueError(f"worker {self.rank} is in no part of {parts}")
        return WorkerGroup(mine, tally=self.tally)


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
    stochastic = False

    def __init__(self, group: Optional[WorkerGroup] = None):
        self.group = group
        self.exchanges = 0

    def init_state(self, d: int, m: int, device=None):
        return ()

    def exchange(self, x: torch.Tensor, state, *, slot: str, noise: Noise = None, weight=None):
        """(sum over workers of ``x``, new state); ``slot`` is "u" or "v"."""
        self.exchanges += 1
        return psum(x, self.group), state

    def wire_bytes(self, dim: int, num_workers: int) -> int:
        return 2 * 4 * dim  # ring all-reduce: 2x the f32 vector


def make_reducer(spec: str, *, num_workers: int = 1, group: Optional[WorkerGroup] = None):
    """``"dense"`` -> :class:`DenseReducer`, ``"int8"`` -> ``Int8Reducer``
    sized for ``num_workers``, ``"topk:r"`` -> ``TopKReducer(r)``, each
    exchanging over ``group`` (None: one process)."""
    c = parse_comm(spec)
    if group is not None and group.size != num_workers:
        raise ValueError(f"num_workers={num_workers} but the group has {group.size} workers")
    if c.kind == "dense":
        return DenseReducer(group)
    if c.kind == "int8":
        from .int8 import Int8Reducer

        return Int8Reducer(num_workers=num_workers, group=group)
    from .topk import TopKReducer

    return TopKReducer(k=c.k, group=group)
