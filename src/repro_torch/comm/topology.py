"""Exchange graphs for the distributed power method: the *where* of comm,
the port's copy of the JAX package's ``comm/topology.py``.

A reducer (``comm.base``) decides how one exchange's bytes are encoded; a
topology decides what graph they flow over. Every topology routes its
expensive hop through a reducer, so ``topology="hier:2", comm="int8"`` is
an exact f32 sum inside each group and an int8 exchange across groups.

``flat``
    One global all-reduce domain: :class:`FlatTopology` delegates to its
    reducer, and the drivers hand the bare reducer to the engine, so the
    flat path is the one without a topology, bit for bit.
``ring`` / ``gossip:k``
    Master-less neighbour averaging: each of R mixing rounds replaces every
    worker's value with the mean of itself and its k ring neighbours
    (offsets ±1..±k/2), moved point to point (``WorkerGroup.shift``); the
    neighbour terms are added in the reference's offset order. After R
    rounds worker i holds ``(W^R x)_i`` for the doubly stochastic circulant
    W, and ``N (W^R x)_i`` is its own estimate of the sum (per-node: the
    drivers carry per-node iterates and certify with the workers' largest
    gap). R defaults to the smallest with ``λ₂^R <= CONSENSUS_TARGET``.
``hier:g``
    An exact sum inside each of g contiguous groups, then the reducer,
    built for g participants (int8's budget 127 // g), across the groups
    only: worker j + g·s exchanges with j + g'·s for every group g'.

One process (``group=None``, or a group of one worker): gossip is the
identity and hier still encodes at group width, the serial baselines of
the reference's tests.
``exchange`` has the reducer's signature, so a topology stands in the
power method's reducer slot. ``hop_wire_bytes`` splits an exchange's
analytic bytes by hop; ``collective_counts`` gives the collectives one
exchange issues (the reference's ``collective_contract`` reads XLA HLO and
waits for a contracts recorder).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..specs import SpecError, parse_comm, parse_topology
from .base import DenseReducer, Noise, WorkerGroup, make_reducer, psum

#: Target per-node consensus error (relative to the true mean) that the
#: auto-sized gossip round count R aims for: R = ceil(log target / log λ₂).
CONSENSUS_TARGET = 1e-2


def _reducer_collective_counts(reducer) -> Dict[str, float]:
    """Collectives issued by ONE ``reducer.exchange``."""
    spec = reducer.spec
    if spec == "dense":
        return {"all-reduce": 1.0}
    if spec == "int8":
        return {"all-reduce": 2.0}  # f32 scale max + int8 sum
    if spec.startswith("topk:"):
        return {"all-gather": 2.0}  # int32 indices + f32 values
    raise ValueError(f"no collective profile for reducer spec {spec!r}")


class Topology:
    """Interface of an exchange graph. ``reducer`` is the encoding on the
    expensive hop; ``per_node`` says that ``exchange`` returns per-worker
    estimates (gossip) rather than one sum; ``replicated`` that every
    worker ends an exchange with the same bits."""

    spec = "base"
    per_node = False
    reducer = None
    num_workers = 1

    @property
    def replicated(self) -> bool:
        return True

    @property
    def rounds_per_exchange(self) -> int:
        raise NotImplementedError

    def init_state(self, d: int, m: int, device=None):
        return self.reducer.init_state(d, m, device=device)

    def exchange(self, x: torch.Tensor, state, *, slot: str, noise: Noise = None, weight=None):
        raise NotImplementedError

    def collective_counts(self, num_exchanges: int = 1) -> Dict[str, float]:
        raise NotImplementedError

    def hop_wire_bytes(self, dim: int) -> Dict[str, int]:
        raise NotImplementedError

    def wire_bytes(self, dim: int, num_workers: int) -> int:
        return sum(self.hop_wire_bytes(dim).values())


class FlatTopology(Topology):
    """One global all-reduce domain: pure delegation to the reducer."""

    def __init__(self, reducer, num_workers: int = 1, spec: str = "flat"):
        self.reducer, self.num_workers, self.spec = reducer, int(num_workers), spec

    @property
    def rounds_per_exchange(self) -> int:
        return 1

    def exchange(self, x, state, *, slot, noise=None, weight=None):
        return self.reducer.exchange(x, state, slot=slot, noise=noise, weight=weight)

    def collective_counts(self, num_exchanges: int = 1) -> Dict[str, float]:
        return {k: v * num_exchanges for k, v in _reducer_collective_counts(self.reducer).items()}

    def hop_wire_bytes(self, dim: int) -> Dict[str, int]:
        return {"global": self.reducer.wire_bytes(dim, self.num_workers)}


def gossip_lambda2(num_workers: int, degree: int) -> float:
    """Second-largest |eigenvalue| of the uniform gossip mixing matrix
    ``W = (I + Σ_o S_o) / (degree + 1)`` over ring offsets ±1..±degree/2
    (circulant: closed form). The per-round consensus contraction."""
    half = degree // 2
    lam2 = 0.0
    for j in range(1, num_workers):
        lam = (1.0 + sum(2.0 * math.cos(2.0 * math.pi * o * j / num_workers)
                         for o in range(1, half + 1))) / (degree + 1)
        lam2 = max(lam2, abs(lam))
    return lam2


def default_gossip_rounds(num_workers: int, degree: int) -> int:
    """Rounds R with λ₂^R <= CONSENSUS_TARGET (at least 1; 1 when one round
    already averages everything)."""
    if num_workers <= 1:
        return 1
    lam2 = gossip_lambda2(num_workers, degree)
    if lam2 <= 0.0:
        return 1
    return max(1, math.ceil(math.log(CONSENSUS_TARGET) / math.log(lam2)))


class GossipTopology(Topology):
    """Master-less k-regular gossip over point-to-point neighbour exchange.
    ``exchange`` returns this worker's estimate ``N (W^R x)_i`` of the sum;
    with ``group=None`` it is the identity."""

    per_node = True

    def __init__(self, *, num_workers: int = 1, degree: int = 2, rounds: int = 1,
                 spec: str = "ring", group: Optional[WorkerGroup] = None):
        self.num_workers, self.degree, self.rounds = int(num_workers), int(degree), int(rounds)
        self.spec, self.group = spec, group
        self.reducer = DenseReducer()  # the encoding its bytes are counted in
        # f32(1 / (k + 1)), as the reference multiplies by it
        self._inv = float(np.float32(1.0 / (len(self.offsets()) + 1)))

    @property
    def replicated(self) -> bool:
        return self.group is None

    @property
    def rounds_per_exchange(self) -> int:
        return self.rounds

    def offsets(self) -> List[int]:
        half = self.degree // 2
        return [o for i in range(1, half + 1) for o in (i, -i)]

    def exchange(self, x, state, *, slot, noise=None, weight=None):
        # weight is already in x: mixing is linear, so the estimate stays an
        # unbiased image of the masked sum
        if self.group is None:
            return x, state
        offsets = self.offsets()
        for _ in range(self.rounds):
            acc = x
            for got in self.group.shift(x, offsets):
                acc = acc + got
            x = acc * self._inv
        return float(self.num_workers) * x, state

    def collective_counts(self, num_exchanges: int = 1) -> Dict[str, float]:
        return {"collective-permute": float(num_exchanges * self.rounds * self.degree)}

    def hop_wire_bytes(self, dim: int) -> Dict[str, int]:
        return {"neighbor": self.rounds * self.degree * 4 * dim}


class HierTopology(Topology):
    """Two-level reduce: an exact sum inside each of ``groups`` contiguous
    groups (over ``intra``), then ``reducer``, built for ``groups``
    participants, over the cross groups (its own subgroup)."""

    def __init__(self, *, num_workers: int = 2, groups: int = 2, reducer=None,
                 spec: str = "hier:2", intra: Optional[WorkerGroup] = None):
        self.num_workers, self.groups, self.spec = int(num_workers), int(groups), spec
        self.reducer = reducer if reducer is not None else DenseReducer()
        self.intra = intra

    @property
    def group_size(self) -> int:
        return max(1, self.num_workers // self.groups)

    def intra_groups(self) -> List[List[int]]:
        s = self.group_size
        return [[g * s + j for j in range(s)] for g in range(self.groups)]

    def cross_groups(self) -> List[List[int]]:
        s = self.group_size
        return [[j + g * s for g in range(self.groups)] for j in range(s)]

    @property
    def replicated(self) -> bool:
        # every cross group sums the same group partials; only a stochastic
        # encoding (each worker's own noise) makes them part
        return (self.reducer.group is None or self.group_size == 1
                or not self.reducer.stochastic)

    @property
    def rounds_per_exchange(self) -> int:
        return 2 if self.group_size > 1 else 1

    def exchange(self, x, state, *, slot, noise=None, weight=None):
        if self.intra is not None:
            x = psum(x, self.intra)
        return self.reducer.exchange(x, state, slot=slot, noise=noise, weight=weight)

    def collective_counts(self, num_exchanges: int = 1) -> Dict[str, float]:
        per = dict(_reducer_collective_counts(self.reducer))
        if self.group_size > 1:
            per["all-reduce"] = per.get("all-reduce", 0.0) + 1.0
        return {k: v * num_exchanges for k, v in per.items()}

    def hop_wire_bytes(self, dim: int) -> Dict[str, int]:
        hops = {"inter": self.reducer.wire_bytes(dim, self.groups)}
        if self.group_size > 1:
            hops["intra"] = 2 * 4 * dim  # ring all-reduce inside the group
        return hops


def make_topology(spec, *, num_workers: int = 1, comm: str = "dense",
                  rounds: Optional[int] = None, group: Optional[WorkerGroup] = None) -> Topology:
    """Parse a ``topology=`` spec and build the graph for ``num_workers``
    workers, exchanging over ``group`` (None: one process). ``comm`` is the
    encoding of the expensive hop (for ``hier`` sized to the group count);
    ``rounds`` overrides the auto-sized gossip round count. The worker-count
    rules (degree < N, N divisible by g) raise ``SpecError`` here, with the
    reference's messages. With a group, ``hier`` splits it into its intra
    and cross subgroups (every worker must make the same call)."""
    t = parse_topology(spec)
    if group is not None and group.size != num_workers:
        raise ValueError(f"num_workers={num_workers} but the group has {group.size} workers")
    if t.kind == "flat":
        reducer = make_reducer(comm, num_workers=num_workers, group=group)
        return FlatTopology(reducer, num_workers=num_workers, spec=t.spec)
    if t.kind == "gossip":
        if num_workers > 1 and t.degree >= num_workers:
            raise SpecError(
                f"topology {t.spec!r}: gossip degree {t.degree} needs more "
                f"than {t.degree} workers, got num_workers={num_workers}"
            )
        if parse_comm(comm).kind != "dense":
            raise SpecError(
                f"topology {t.spec!r} requires comm 'dense' (gossip "
                f"exchanges are neighbor averages, not compressible "
                f"collectives), got comm {comm!r}"
            )
        r = rounds if rounds is not None else default_gossip_rounds(num_workers, t.degree)
        if r < 1:
            raise SpecError(f"topology {t.spec!r}: rounds must be >= 1, got {r}")
        # a world of one has no neighbours: the serial graph (fit_serial's bits)
        return GossipTopology(num_workers=num_workers, degree=t.degree, rounds=r, spec=t.spec,
                              group=group if num_workers > 1 else None)
    if num_workers > 1 and num_workers % t.groups != 0:
        raise SpecError(
            f"topology {t.spec!r}: num_workers={num_workers} is not "
            f"divisible into {t.groups} equal groups"
        )
    topo = HierTopology(num_workers=num_workers, groups=t.groups, spec=t.spec)
    intra = cross = None
    if group is not None and num_workers > 1:  # a world of one: the serial graph
        if topo.group_size > 1:
            intra = group.split(topo.intra_groups())
        cross = group.split(topo.cross_groups()) if topo.group_size > 1 else group
    topo.reducer = make_reducer(comm, num_workers=t.groups, group=cross)
    topo.intra = intra
    return topo
