"""An op recorder: what a program asked the dispatcher to run, the port's
counterpart of reading a compiled module with the JAX package's
``analysis/hlo.py``.

:class:`OpRecorder` is a ``TorchDispatchMode``: inside ``with OpRecorder()
as rec:`` every ATen and ``c10d`` op that reaches the dispatcher is logged
with its output shapes, and :meth:`OpRecorder.analyze` gives a dict shaped
like ``hlo.analyze``'s: collectives by kind (the reference's HLO names) and
their payload bytes, the output shapes, and the device reads.

- **Collectives.** ``c10d.allreduce_`` is an ``all-reduce``,
  ``c10d.allgather_``/``_allgather_base_`` an ``all-gather``, a
  ``c10d.send`` a ``collective-permute`` (each permute a worker joins is one
  send and one receive; the ``recv_`` is its other half and is not counted
  again), ``broadcast_`` a ``broadcast``. A collective's bytes are those of
  its first operand (the tensors reduced, sent or broadcast; the gathered
  output of an all-gather).
- **Captured programs.** A program captured into a CUDA graph dispatches
  its ops once, at capture, and a replay dispatches nothing: the log of
  the capture is the replay's op list, each IF node's body included (its
  ops carry ``conditional``, as do those a host branch ran). Uncaptured
  (the CPU, a gloo group, ``engine="legacy"``) the log is the eager run.
- **Device reads.** ``_local_scalar_dense`` (``float(t)``, ``.item()``),
  ``nonzero`` and the other ops whose result depends on the data
  (``equal``, ``masked_select``, ``unique``), and a copy from a CUDA tensor
  into a CPU one. A read inside ``analysis.contracts.explicit_sync`` is
  explicit, and ``explicit_syncs`` counts the outermost counted blocks
  (the engine's fetches, which it counts in ``stats["host_syncs"]``) in
  which the dispatcher saw such a read: a block that reads nothing is not
  one. On the CPU a fetch copies nothing (its rows are host memory), so
  there only a block that calls ``float(t)`` or the like counts. The
  predicate read of a host branch (``power_method.host_when``, the
  uncaptured form of an IF node, which the engine does not count) is a
  branch read; any other is implicit.
- **What it cannot see.** A hand-written kernel launched through
  ``ctypes`` never passes the dispatcher: the log holds its wrapper's
  tensor allocations, not the launch. Launch counts stay with
  ``kernels.Executed`` and the wrappers' ``launches``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: The recorders open in this process, innermost last.
ACTIVE: List["OpRecorder"] = []

# c10d op name -> the reference's HLO collective kind
_COLLECTIVES = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
    "send": "collective-permute",
    "barrier": "barrier",
}

# ops whose result the host can only have after the device has run them
_READS = frozenset(("_local_scalar_dense", "nonzero", "equal", "masked_select", "_unique2",
                    "unique_dim", "unique_consecutive"))


class OpRecord(NamedTuple):
    """One dispatched op."""

    name: str  # e.g. "aten.mm.default", "c10d.allreduce_.default"
    shapes: Tuple[Tuple[int, ...], ...]  # its tensor outputs' shapes
    collective: Optional[str]  # the HLO kind of a collective, else None
    nbytes: int  # a collective's payload bytes
    read: bool  # a device read
    explicit: bool  # inside an explicit_sync block
    conditional: bool  # under an IF node or a host branch
    branch: bool  # a host branch's predicate


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _shapes(out) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(n) for n in t.shape) for t in _tensors(out))


class OpRecorder(TorchDispatchMode):
    """Log every op dispatched inside ``with OpRecorder() as rec:`` (see the
    module doc). ``log`` holds the :class:`OpRecord` s in order;
    ``explicit_blocks`` counts the outermost counted ``explicit_sync``
    blocks, opened while it was open, that read the device."""

    def __init__(self):
        super().__init__()
        self.log: List[OpRecord] = []
        self.explicit_blocks = 0
        self._explicit = 0
        self._conditional = 0
        self._branch = 0
        self._names: Dict[object, tuple] = {}

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # Leave __torch_dispatch__ unwrapped: PyTorch's wrapping imports
        # torch._dynamo at the first op a recorder sees (seconds, once a
        # process: an enabled handle's first capture), and the port
        # compiles nothing with dynamo.
        return False

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ACTIVE.remove(self)

    def _describe(self, func) -> tuple:
        """(name, collective kind, is a read) of an op, cached."""
        got = self._names.get(func)
        if got is None:
            name = str(func)
            ns, _, rest = name.partition(".")
            base = rest.split(".")[0]
            got = (name, _COLLECTIVES.get(base) if ns == "c10d" else None,
                   ns == "aten" and base in _READS)
            self._names[func] = got
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name, kind, read = self._describe(func)
        nbytes = 0
        if kind is not None and args:
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(args[0]))
        elif not read and name in ("aten._to_copy.default", "aten.copy_.default"):
            # a copy from the card into host memory
            src = args[1] if name == "aten.copy_.default" else args[0]
            dst = args[0] if name == "aten.copy_.default" else out
            read = (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                    and src.is_cuda and dst.device.type == "cpu")
        self.log.append(OpRecord(name, _shapes(out), kind, nbytes, read, self._explicit > 0,
                                 self._conditional > 0, self._branch > 0))
        return out

    def analyze(self) -> Dict:
        """The log's summary, keyed like ``hlo.analyze``'s where the two
        meet: ``collective_count`` ({kind: float}), ``collective_bytes``,
        ``collective_bytes_total``; and ``conditional_collective_count``
        (those under an IF node or host branch), ``ops`` (op count),
        ``op_count`` ({name: n}), ``shapes`` ({output shape: sorted op
        names}), ``implicit_syncs``, ``branch_reads`` and ``explicit_syncs``
        (the outermost counted ``explicit_sync`` blocks that read the
        device)."""
        return analyze(self.log, self.explicit_blocks)


def analyze(log: List[OpRecord], explicit_blocks: int = 0) -> Dict:
    """:meth:`OpRecorder.analyze` of a log."""
    counts: Dict[str, float] = {}
    nbytes: Dict[str, float] = {}
    conditional: Dict[str, float] = {}
    op_count: Dict[str, int] = {}
    shapes: Dict[Tuple[int, ...], set] = {}
    implicit = branch = 0
    for rec in log:
        op_count[rec.name] = op_count.get(rec.name, 0) + 1
        for shape in rec.shapes:
            shapes.setdefault(shape, set()).add(rec.name)
        if rec.collective is not None:
            counts[rec.collective] = counts.get(rec.collective, 0.0) + 1.0
            nbytes[rec.collective] = nbytes.get(rec.collective, 0.0) + rec.nbytes
            if rec.conditional:
                conditional[rec.collective] = conditional.get(rec.collective, 0.0) + 1.0
        if rec.read and not rec.explicit:
            if rec.branch:
                branch += 1
            else:
                implicit += 1
    return {
        "ops": len(log),
        "collective_count": counts,
        "collective_bytes": nbytes,
        "collective_bytes_total": float(sum(nbytes.values())),
        "conditional_collective_count": conditional,
        "op_count": op_count,
        "shapes": {shape: sorted(names) for shape, names in shapes.items()},
        "implicit_syncs": implicit,
        "branch_reads": branch,
        "explicit_syncs": explicit_blocks,
    }


class _Scope:
    """Marks the ops of its body on every open recorder. ``counted``: an
    outermost explicit block adds one to a recorder's ``explicit_blocks``
    if the recorder logged a device read inside it."""

    __slots__ = ("_attr", "_counted", "_open")

    def __init__(self, attr: str, counted: bool = False):
        self._attr = attr
        self._counted = counted
        self._open = ()

    def __enter__(self):
        # each open recorder, with where its log stood if this block counts
        self._open = tuple((rec, len(rec.log) if self._counted and rec._explicit == 0 else None)
                           for rec in ACTIVE)
        for rec, _ in self._open:
            setattr(rec, self._attr, getattr(rec, self._attr) + 1)
        return self

    def __exit__(self, *exc):
        for rec, start in self._open:
            setattr(rec, self._attr, getattr(rec, self._attr) - 1)
            if start is not None and any(op.read for op in rec.log[start:]):
                rec.explicit_blocks += 1
        return False


_NONE_OPEN = contextlib.nullcontext()


def explicit(counted: bool = True):
    """The body's device reads are explicit (``contracts.explicit_sync``);
    ``counted``: the block is one of the engine's counted fetches. A
    shared no-op when no recorder is open, as are the two below."""
    return _Scope("_explicit", counted) if ACTIVE else _NONE_OPEN


def conditional():
    """The body runs under an IF node or a host branch."""
    return _Scope("_conditional") if ACTIVE else _NONE_OPEN


def branch():
    """The body reads a host branch's predicate."""
    return _Scope("_branch") if ACTIVE else _NONE_OPEN
