"""Epoch engine: the K(t) schedule cut into constant-K segments, each one
dispatch.

``plan_segments`` partitions the schedule into maximal constant-K runs
(optionally capped at ``block_epochs``), as in the JAX package. A segment
runs as one *segment program*: ``length`` epochs from the run's static carry
(the tensors every epoch reads and writes back in place) and the segment's
input tables (each epoch's counter, straggler weight, start vector or
block, int8 noise; ``EpochInputs``), writing each epoch's aux row into a
(length, 5) block. Segments of one (K, length) signature share a program.

``mode="scan"`` (the default) is the reference's compiled scan:

- **On a CUDA device, with no group or an NCCL group**, each program is
  captured once into a CUDA graph (``core.cuda_graph``) and every segment
  of its signature is one graph replay; the host only fills the input
  tables (the draws stay outside the graph: a captured generator would
  replay with an advanced offset instead of its (seed, t) seed) and
  launches the replay.
- **On the CPU, or with a gloo group** (gloo's collectives run on the host
  and cannot be captured), the same program runs uncaptured.

A program holds at most ``MAX_PROGRAM_EPOCHS`` epochs: a longer segment
runs as consecutive pieces of that many (the last one shorter), each a
program of its own signature, replayed back to back with no host read
between them. So a graph's nodes, its capture time and its input tables
stay bounded however long a ``const`` segment is, and a long segment
costs at most two graphs (three under ``gap_tol``) where the reference
compiles one scan.

``gap_tol`` rides a device ``done`` flag, ``done |= gap <= gap_tol`` after
every epoch (the workers' largest gap where their gaps may part: an int8
exchange across ``hier`` groups rounds with each worker's own noise), and
every epoch after a segment's first runs under ``when(~done, ...)`` (a
later piece's first epoch too); the block solver's ``:adapt`` stop is
``when(~stopped, ...)`` around each iteration after the first
(``power_method.block_power_iterations``). In a graph ``when`` is an IF
conditional node, the counterpart of ``lax.cond``; uncaptured it is a
host branch. Epochs after the certificate leave NaN rows and are cut from
the history; ``epochs_run`` is a device counter. The host reads the flag
at segment boundaries only.

``mode="legacy"`` is the reference's oracle: one epoch a segment, always
uncaptured, and four blocking scalar pulls (loss, gap, sigma, gamma) an
epoch, plus one of ``done`` under ``gap_tol`` and one of ``piters`` under
``:adapt``. It runs the same program, so its bits are ``scan``'s.

``checkpointer`` (a ``repro_torch.checkpoint.RunCheckpointer``) makes the
run durable: at each segment boundary it ``want``s, the engine fetches the
aux rows not yet on the host with the counters, and hands the carry to
``save_segment``, which copies it to the host before the next replay
writes it; boundaries it does not want cost nothing.

``stats`` counts the reference's logical points, the same on every device:
``segments_planned``/``segments_run``, ``dispatches`` (one a segment, plus
the final loss in ``fit``), ``compilations`` (segment programs built, one a
signature), ``host_syncs`` (a boundary fetch for ``gap_tol`` or a callback,
a wanted checkpoint, the final fetch, the final loss in ``fit``; legacy's
pulls; a host branch is not counted) and ``graph_replays`` (the programs
launched as a graph replay, one a piece: 0 off the card). ``dispatch_contract``
declares the scan mode's bounds. ``stats`` also holds the analytic comm
cost of the epochs run, as the reference derives it for its telemetry:
``comm_rounds`` (2K exchanges an epoch, times a topology's rounds per
exchange), ``comm_logical_bytes`` (the f32 vectors, 8 (d + m) K an epoch),
``comm_wire_bytes`` (the reducer's or graph's ``wire_bytes``) and, for a
graph, ``comm_hop_bytes_<hop>`` (``hop_wire_bytes``: global, neighbor,
intra, inter). The block solver "block:k" exchanges flattened (d k,) and
(m k,) blocks, so its costs are those of vectors k times as wide; K counts
the iterations that ran (the fetched ``piters`` column), fewer than K(t)
when ``:adapt`` stopped an epoch early. The block solver's warm-start probe
rides in the carry, replicated, from ``probe`` (default: ``init_probe``).

A replay calls no Python, so the host-side counters count calls, not what
the device ran: a kernel wrapper's ``launches`` (``kernels.launches()``),
a group's collective tally and a reducer's ``exchanges`` count a captured
call once, when it is captured, and a replay adds nothing. What a replay
ran is counted on the device (``kernels.Executed``: a counter add beside
each launch, in the graph with it). ``timings`` keeps the host microseconds of each program
launch's draws, and for each program built its capture milliseconds (its
instantiation's among them), the pool bytes its capture took and the
bytes of its input tables and aux block.

With ``group`` (a ``comm.WorkerGroup``) the engine runs one worker of a
multi-worker run: every worker runs this same program on its own rows, and
every aggregate of an epoch is an all-reduce over the group. ``masks`` is
the run's (num_epochs, N) straggler-weight table on the host; worker j
takes column j of row t as its weight in epoch t.

``telemetry`` (an ``obs.Telemetry``; the inert no-op when None) records
what the reference's engine records, under its names: ``engine.compile``
(a program's build and capture, with ``capture_ms``/``instantiate_ms``),
``engine.dispatch`` (the host time of each piece's launch),
``engine.segment`` and ``comm.exchange`` (from a segment's first launch
until its rows land on the host: at the boundary fetch that serves a
callback, ``gap_tol`` or a checkpoint, else at the final fetch, which
stamps every segment still pending), ``comm.topology`` and the
``comm.hop_bytes.<hop>`` counters for a graph, ``engine.fetch`` spans by
kind, ``dfw.loss/gap/sigma/gamma`` samples and gauges (one an epoch run,
none for the NaN rows past an early stop), the ``engine.epochs``,
``comm.rounds/logical_bytes/wire_bytes`` and ``dfw.block.power_iters``
counters and the ``dfw.block.k`` gauge (the comm counters over each
segment's K(t) and length, as the reference's), the
``engine.alive_workers`` histogram and ``engine.straggler_masks`` event
from the host mask table, and ``engine.early_stop``. Every record is made
on the host around a launch and the fetches the engine makes anyway, from
host values: telemetry adds no fetch, no dispatch, no launch and no graph,
and never sits inside a captured body (whose Python runs once, at
capture). With ``telemetry.wants_hlo`` each program is recorded once by
``analysis.recorder.OpRecorder`` (its capture; uncaptured, its first
launch) and its op log's collectives go out as a ``comm.executable`` event.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import NoiseStream, as_v0_stream
from ..analysis.contracts import Contract, explicit_sync
from ..analysis.recorder import OpRecorder
from ..comm.base import DenseReducer, WorkerGroup, pmax
from ..obs import Telemetry
from ..specs import validate
from . import low_rank
from .frank_wolfe import (EpochAux, EpochCarry, EpochInputs, init_carry, init_probe, k_schedule,
                          make_epoch_step)
from .power_method import host_when

MODES = ("scan", "legacy")

#: The most epochs one segment program (one graph) holds; see the module doc.
MAX_PROGRAM_EPOCHS = 16


class Segment(NamedTuple):
    """A maximal run of epochs sharing one power-iteration count."""

    start: int  # first epoch index
    length: int  # number of epochs
    k: int  # K(t) throughout the segment


def plan_segments(
    schedule: str,
    num_epochs: int,
    block_epochs: Optional[int] = None,
    *,
    start: int = 0,
) -> List[Segment]:
    """Partition ``[start, num_epochs)`` into maximal constant-K segments,
    each at most ``block_epochs`` long. Planning from a boundary of a full
    plan reproduces that plan's remaining segments (the resume case)."""
    if num_epochs < 1:
        raise ValueError(f"num_epochs={num_epochs}: need at least one epoch")
    if block_epochs is not None and block_epochs < 1:
        raise ValueError(f"block_epochs={block_epochs}: must be >= 1")
    if not 0 <= start < num_epochs:
        raise ValueError(f"start={start}: must lie in [0, num_epochs={num_epochs})")
    sched = k_schedule(schedule)
    segments: List[Segment] = []
    t = start
    while t < num_epochs:
        k = sched(t)
        end = t + 1
        while (
            end < num_epochs
            and sched(end) == k
            and (block_epochs is None or end - t < block_epochs)
        ):
            end += 1
        segments.append(Segment(start=t, length=end - t, k=k))
        t = end
    return segments


def resolve_max_rank(
    max_rank: Optional[int], num_epochs: int, atoms_per_epoch: int = 1
) -> int:
    """Factored-iterate capacity: every epoch appends ``atoms_per_epoch``
    factors, so a smaller store would overflow; reject it up front."""
    need = num_epochs * atoms_per_epoch
    if max_rank is None:
        return need
    if max_rank < need:
        raise ValueError(
            f"max_rank={max_rank} < num_epochs*atoms={need}: every "
            f"epoch appends {atoms_per_epoch} factor(s), so the iterate "
            "store would overflow"
        )
    return max_rank


def dispatch_contract(*, segments: int = 1, max_compilations: Optional[int] = 2,
                      name: Optional[str] = None) -> Contract:
    """The scan engine's reason to exist, as a checkable contract (the
    reference's ``engine.dispatch_contract``): a run over ``segments``
    planned segments costs at most ``segments + 1`` dispatches (one a
    segment, plus ``fit``'s final loss), at most 2 host syncs (the final
    fetch and the final loss) and, under ``contract.guard()``, no implicit
    device read. ``max_compilations`` defaults to 2, the reference's count
    for one ``const:K`` segment; None for schedules whose distinct (K,
    length) signatures are not pinned."""
    return Contract(
        name=name or f"engine.dispatch[segments={segments}]",
        max_dispatches=segments + 1,
        max_compilations=max_compilations,
        max_host_syncs=2,
        no_host_transfers=True,
    )


@dataclasses.dataclass
class EngineResult:
    carry: EpochCarry
    history: Dict[str, list]
    epochs_run: int
    stats: Dict[str, int]
    masks: Optional[torch.Tensor] = None  # (epochs_run, N) weights, if given
    timings: Dict[str, list] = dataclasses.field(default_factory=dict)


_HISTORY_KEYS = ("loss", "gap", "sigma", "gamma")


def _comm_cost_per_k(reducer, d: int, m: int, workers: int) -> Dict[str, int]:
    """The analytic comm cost of one epoch per power iteration (the
    reference engine's ``_comm_cost``/``_hop_cost``) for exchanged vectors
    of d and m floats (d k and m k for the block solver): ``stats`` keys to
    amounts, multiplied by the iterations of each epoch run."""
    rpe = int(getattr(reducer, "rounds_per_exchange", 1))
    cost = {"comm_rounds": 2 * rpe, "comm_logical_bytes": 8 * (d + m),
            "comm_wire_bytes": reducer.wire_bytes(d, workers) + reducer.wire_bytes(m, workers)}
    hop_fn = getattr(reducer, "hop_wire_bytes", None)
    if hop_fn is not None:
        for dim in (d, m):
            for hop, nbytes in hop_fn(dim).items():
                key = f"comm_hop_bytes_{hop}"
                cost[key] = cost.get(key, 0) + nbytes
    return cost


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a carry field (named tuples, tuples, dicts by key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    return []


def _write_back(static: EpochCarry, new: EpochCarry) -> None:
    """Copy every tensor of ``new`` that an epoch made afresh into the
    run's static carry (the ones updated in place are the static ones)."""
    for field in ("state", "iterate", "comm_state", "probe"):
        for old, fresh in zip(_leaves(getattr(static, field)), _leaves(getattr(new, field))):
            if fresh is not old:
                old.copy_(fresh)


def _own(tree):
    """A copy of a caller's carry field, which the run then writes in place."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {key: _own(val) for key, val in tree.items()}
    if isinstance(tree, tuple) and tree:
        return type(tree)(*(_own(x) for x in tree))
    return tree


def _stochastic(reducer) -> bool:
    """Does the reducer (or a graph's reducer) draw noise?"""
    if hasattr(reducer, "stochastic"):
        return bool(reducer.stochastic)
    return bool(getattr(getattr(reducer, "reducer", None), "stochastic", False))


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """One explicit device read of a few f32 tensors (flattened)."""
    with explicit_sync():
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()])
        lo += t.numel()
    return out


class _Run(NamedTuple):
    """What every segment program of a run shares."""

    task: object
    carry: EpochCarry  # the static carry: every program reads and writes these tensors
    device: torch.device
    key: object  # V0Stream
    noise: Optional[NoiseStream]  # None: the reducer draws no noise
    masks: Optional[torch.Tensor]  # (num_epochs,) this worker's weights on the device
    done: torch.Tensor  # () bool: the gap certificate fired
    nrun: torch.Tensor  # () int32: epochs run
    tol: Optional[torch.Tensor]  # () f32 gap_tol
    agree: Optional[WorkerGroup]  # the group whose largest gap decides, where gaps may part
    k_block: int  # block width (1 for rank1)
    block_solver: bool  # start blocks, not vectors


class _Program:
    """One (K, length) segment program: its input tables, its (length, 5)
    aux block and, when captured, its graph. ``gated``: its first epoch too
    runs under ``when(~done)`` (a later piece of a long segment)."""

    def __init__(self, run: _Run, k: int, length: int, gated: bool, make_epoch: Callable):
        self.run, self.k, self.length, self.gated = run, k, length, gated
        dev, task, kb = run.device, run.task, run.k_block
        # the epoch's :adapt seam, set while the program runs; a list, not
        # self, so that no reference cycle keeps a program and its graph's
        # pool memory alive after the run
        seam = self._seam = [host_when]
        self.epoch = make_epoch(k, lambda pred, body: seam[0](pred, body))
        self.t_tab = torch.empty(length, dtype=torch.float32, device=dev)
        self.w_tab = None if run.masks is None else torch.empty(length, device=dev)
        self.v0_tab = torch.empty((length, task.m, kb) if run.block_solver else (length, task.m),
                                  dtype=torch.float32, device=dev)
        self.noise_tabs = None
        if run.noise is not None:
            self.noise_tabs = tuple(torch.empty((length, k, dim * kb), device=dev)
                                    for dim in (task.d, task.m))
        self.aux = torch.empty((length, 5), dtype=torch.float32, device=dev)
        self.table_bytes = sum(t.numel() * t.element_size() for t in (
            self.t_tab, self.w_tab, self.v0_tab, *(self.noise_tabs or ()), self.aux)
            if t is not None)
        self.graph = None
        self.capture_ms = self.pool_bytes = 0

    def fill(self, start: int) -> float:
        """Write the inputs of epochs [start, start + length) into the
        tables; the draws' host us."""
        run = self.run
        t0 = time.perf_counter()
        torch.arange(start, start + self.length, dtype=torch.float32, device=run.device,
                     out=self.t_tab)
        if self.w_tab is not None:
            self.w_tab.copy_(run.masks[start:start + self.length])
        m = run.task.m
        if run.block_solver:
            run.key.block_segment(start, self.length, m, run.k_block, run.device, out=self.v0_tab)
        else:
            run.key.segment(start, self.length, m, run.device, out=self.v0_tab)
        if self.noise_tabs is not None:
            kb = run.k_block
            run.noise.segment(start, self.length, self.k, run.task.d * kb, m * kb, run.device,
                              out=self.noise_tabs)
        return 1e6 * (time.perf_counter() - t0)

    def _epoch(self, j: int) -> None:
        run = self.run
        inputs = EpochInputs(
            t=self.t_tab[j], weight=None if self.w_tab is None else self.w_tab[j],
            v0=self.v0_tab[j],
            noise=None if self.noise_tabs is None else tuple(t[j] for t in self.noise_tabs))
        new, aux = self.epoch(run.carry, inputs=inputs)
        _write_back(run.carry, new)
        self.aux[j].copy_(torch.stack(list(aux)))
        run.nrun.add_(1)
        if run.tol is not None:
            # every worker reads the same verdict: the gap comes from
            # all-reduced values, or is the workers' largest where they part
            gap = aux.gap if run.agree is None else pmax(aux.gap.clone(), run.agree)
            run.done.logical_or_(gap <= run.tol)

    def program(self, when: Callable) -> None:
        """The program: a segment's first epoch always runs (a boundary
        never passes a set flag), every other one, a later piece's first
        among them, under ``when(~done)`` where ``gap_tol`` is set."""
        self._seam[0] = when
        try:
            self.aux.fill_(float("nan"))
            for j in range(self.length):
                if self.run.tol is None or (j == 0 and not self.gated):
                    self._epoch(j)
                else:
                    when(~self.run.done, lambda j=j: self._epoch(j))
        finally:
            self._seam[0] = host_when

    def capture(self, pool, stream) -> None:
        """Capture the program into a graph."""
        from .cuda_graph import CondGraph

        dev = self.run.device
        reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
        t0 = time.perf_counter()
        self.graph = CondGraph(self.program, pool=pool, stream=stream)
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        # a private pool takes fresh device segments: what the capture reserved
        self.pool_bytes = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"] - reserved

    def launch(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.program(host_when)


def _record_executable(tel: Telemetry, prog: _Program, rec: OpRecorder) -> None:
    """``comm.executable``: a program's collectives from its op log (its
    capture, which every replay runs; uncaptured, its first launch), once
    a program. The reference's ``hlo_`` names are kept."""
    info = rec.analyze()
    tel.event("comm.executable", "comm", k=prog.k, length=prog.length,
              captured=prog.graph is not None, ops=info["ops"],
              hlo_collective_bytes=info["collective_bytes_total"],
              hlo_collective_count=info["collective_count"],
              conditional_collective_count=info["conditional_collective_count"])


def _record_segment(tel: Telemetry, seg: Segment, t0: float, t_end: float, rows: np.ndarray,
                    per_k: Dict[str, int], spec, workers: int, k_block: Optional[int]) -> None:
    """The telemetry of one segment whose host rows (``rows[:seg.length]``)
    have landed: its span from its first launch to ``t_end``, the
    comm-exchange span with the analytic costs of K(t) iterations over its
    length (the reference's accounting), and each epoch's scalars, stamped
    evenly across the span; NaN rows (past an early stop) are skipped."""
    dur = max(t_end - t0, 0.0)
    tel.complete("engine.segment", "engine", t0, dur,
                 start=seg.start, length=seg.length, k=seg.k)
    iters = seg.k * seg.length
    cost = {"rounds": per_k["comm_rounds"] * iters,
            "logical_bytes": float(per_k["comm_logical_bytes"] * iters),
            "wire_bytes": float(per_k["comm_wire_bytes"] * iters)}
    tel.complete("comm.exchange", "comm", t0, dur, spec=spec, num_workers=workers, **cost)
    reg = tel.registry
    for name, val in cost.items():
        reg.counter(f"comm.{name}").inc(val)
    hops = {key[len("comm_hop_bytes_"):]: float(val * iters) for key, val in per_k.items()
            if key.startswith("comm_hop_bytes_")}
    if hops:
        tel.complete("comm.topology", "comm", t0, dur, topology=spec,
                     rounds_per_exchange=per_k["comm_rounds"] // 2,
                     **{f"bytes_{h}": b for h, b in sorted(hops.items())})
        for h, b in hops.items():
            reg.counter(f"comm.hop_bytes.{h}").inc(b)
    if k_block is not None:
        reg.gauge("dfw.block.k").set(k_block)
    for j in range(seg.length):
        vals = [float(v) for v in rows[j]]
        if math.isnan(vals[0]):
            continue
        ts = t0 + dur * (j + 1) / seg.length
        for name, val in zip(_HISTORY_KEYS, vals):
            tel.counter_sample(f"dfw.{name}", val, ts_us=ts)
            reg.gauge(f"dfw.{name}").set(val)
        if k_block is not None:
            reg.counter("dfw.block.power_iters").inc(vals[4])
        reg.counter("engine.epochs").inc()


def _capturable(device: torch.device, mode: str, group: Optional[WorkerGroup],
                needs_if: bool) -> bool:
    """Does this run capture its programs? On a CUDA device in scan mode,
    with no group or an NCCL one, and, where a program needs IF nodes
    (``gap_tol``, ``:adapt``), a CUDA runtime that has them (12.4)."""
    if device.type != "cuda" or mode != "scan":
        return False
    if group is not None and torch.distributed.get_backend(group.process_group) != "nccl":
        return False
    if needs_if:
        from .cuda_graph import runtime_version

        return runtime_version() >= 12040
    return True


def _process_groups(group: Optional[WorkerGroup], reducer) -> list:
    """The process groups a run's collectives use: the group's, a hier
    graph's intra and cross groups."""
    if group is None:
        return []
    found = (group, getattr(reducer, "intra", None),
             getattr(getattr(reducer, "reducer", None), "group", None))
    return list({id(g.process_group): g.process_group for g in found if g is not None}.values())


def _warm_up(device: torch.device, stream, groups) -> None:
    """Before a run's first capture, on its capture stream: one block
    orthonormalization (cuBLAS, cuSOLVER) and one all-reduce a process group
    (NCCL communicators), none touching the run's tensors, so that no
    handle or communicator is made inside a capture."""
    from .power_method import orthonormalize_block

    with torch.cuda.stream(stream):
        orthonormalize_block(torch.ones((4, 2), device=device))
        for pg in groups:
            torch.distributed.all_reduce(torch.zeros(1, device=device), group=pg)
    with explicit_sync(counted=False):  # set-up, not one of the run's fetches
        torch.cuda.synchronize(device)


def run_epochs(
    task,
    state,
    *,
    mu: float,
    num_epochs: int,
    key,
    device: torch.device,
    schedule: str = "const:2",
    step_size: str = "default",
    reducer=None,
    iterate: Optional[low_rank.FactoredIterate] = None,
    comm_state=None,
    max_rank: Optional[int] = None,
    gap_tol: Optional[float] = None,
    block_epochs: Optional[int] = None,
    callback: Optional[Callable[[int, EpochAux], None]] = None,
    start_t: int = 0,
    initial_history: Optional[Dict[str, list]] = None,
    solver="rank1",
    noise: Optional[NoiseStream] = None,
    checkpointer=None,
    group: Optional[WorkerGroup] = None,
    masks=None,
    probe=None,
    mode: str = "scan",
    telemetry: Optional[Telemetry] = None,
) -> EngineResult:
    """Run up to ``num_epochs`` DFW-Trace epochs of one worker on ``device``
    (``group``: one worker of that group; ``masks``: the (num_epochs, N)
    straggler weights; ``mode``: "scan" or "legacy"; ``telemetry``: an
    ``obs.Telemetry``; see the module doc).

    ``iterate`` defaults to a fresh store of ``max_rank`` capacity (validated
    >= num_epochs times the atoms an epoch appends), ``comm_state`` to
    ``reducer.init_state`` on ``device`` (at d k and m k for "block:k"),
    ``probe`` (block solver) to ``init_probe``; the run works on copies of
    the ones given. ``start_t``/``initial_history``/``iterate``/``state``
    resume a run at epoch ``start_t``; the plan is recomputed from there.
    ``noise`` feeds stochastic encodings; it defaults to a ``NoiseStream``
    with the seed of ``key``. ``state`` is consumed: the run writes it in
    place.
    """
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: expected 'scan' or 'legacy'")
    if not 0 <= start_t < num_epochs:
        raise ValueError(
            f"start_t={start_t}: must lie in [0, num_epochs={num_epochs}) — "
            "a run checkpointed at or past num_epochs has nothing left to do"
        )
    if initial_history is not None:
        for name, vals in initial_history.items():
            if len(vals) != start_t:
                raise ValueError(
                    f"initial_history[{name!r}] has {len(vals)} entries for "
                    f"start_t={start_t}; pass the restored prefix unmodified"
                )
    sspec, _, _ = validate(solver=solver)
    if sspec.kind == "block" and sspec.k > min(task.d, task.m):
        raise ValueError(
            f"solver block:{sspec.k}: block width exceeds min(d={task.d}, m={task.m})"
        )
    k_block = sspec.k if sspec.kind == "block" else 1
    adapt = sspec.kind == "block" and sspec.adaptive
    workers, rank = (1, 0) if group is None else (group.size, group.rank)
    if masks is not None:
        masks = torch.as_tensor(masks, dtype=torch.float32).cpu()
        if tuple(masks.shape) != (num_epochs, workers):
            raise ValueError(
                f"masks has shape {tuple(masks.shape)}; want (num_epochs, workers) = "
                f"({num_epochs}, {workers})"
            )
    if reducer is None:
        reducer = DenseReducer(group)
    key = as_v0_stream(key)
    if noise is None:
        noise = NoiseStream(key.seed)
    if iterate is None:
        iterate = low_rank.init(
            resolve_max_rank(max_rank, num_epochs, k_block), task.d, task.m, device=device
        )
    else:
        iterate = _own(iterate)
    if sspec.kind == "block":
        if probe is None:
            probe = init_probe(sspec, task.m, device)
        elif isinstance(probe, torch.Tensor):
            probe = probe.to(device=device, dtype=torch.float32).clone()
        else:  # a host array (the reference's init_probe, a checkpoint's leaf)
            probe = torch.tensor(probe, dtype=torch.float32, device=device)
        if tuple(probe.shape) != (task.m, sspec.k):
            raise ValueError(f"probe has shape {tuple(probe.shape)}; the solver carries "
                             f"({task.m}, {sspec.k})")
    else:
        probe = ()
    segments = plan_segments(schedule, num_epochs, 1 if mode == "legacy" else block_epochs,
                             start=start_t)
    stats = {
        "segments_planned": len(segments),
        "segments_run": 0,
        "dispatches": 0,
        "compilations": 0,
        "graph_replays": 0,
        "host_syncs": 0,
        "comm_rounds": 0,
        "comm_logical_bytes": 0,
        "comm_wire_bytes": 0,
    }
    epoch_cost = _comm_cost_per_k(reducer, task.d * k_block, task.m * k_block, workers)
    if comm_state is None:
        comm_state = reducer.init_state(task.d * k_block, task.m * k_block, device=device)
    else:
        comm_state = _own(comm_state)
    agree = (group if group is not None and not getattr(reducer, "per_node", False)
             and not getattr(reducer, "replicated", True) else None)
    run = _Run(
        task=task, carry=init_carry(state, iterate, key, comm_state, t=start_t, probe=probe),
        device=device, key=key, noise=noise if _stochastic(reducer) else None,
        masks=None if masks is None else masks[:, rank].to(device),
        done=torch.zeros((), dtype=torch.bool, device=device),
        nrun=torch.full((), start_t, dtype=torch.int32, device=device),
        tol=None if gap_tol is None else torch.full((), gap_tol, dtype=torch.float32,
                                                    device=device),
        agree=agree, k_block=k_block, block_solver=sspec.kind == "block",
    )

    def make_epoch(k, when):
        return make_epoch_step(task, mu, k, step_size=step_size, reducer=reducer,
                               solver=solver, noise=noise, group=group, when=when)

    tel = telemetry if telemetry is not None else Telemetry.noop()
    if masks is not None and tel.enabled:
        # the straggler accounting, from the host table the run already holds
        alive = [int(a) for a in (masks.numpy() > 0).sum(axis=1)]
        hist_alive = tel.registry.histogram("engine.alive_workers")
        for a in alive:
            hist_alive.observe(a)
        tel.event("engine.straggler_masks", "engine", epochs=len(alive), num_workers=workers,
                  min_alive=min(alive), mean_alive=sum(alive) / len(alive))
    capture = _capturable(device, mode, group, gap_tol is not None or adapt)
    stream = pool = None
    programs: Dict[tuple, _Program] = {}
    timings: Dict[str, list] = {"draw_us": [], "capture_ms": [], "instantiate_ms": [],
                                "pool_bytes": [], "table_bytes": []}
    rows = num_epochs - start_t
    hist = torch.full((rows, 5), float("nan"), dtype=torch.float32, device=device)
    host = np.full((rows, 5), np.nan, dtype=np.float32)
    fetched = 0  # rows of ``hist`` already in ``host``
    ran: List[Segment] = []  # in order
    seg_t0: List[float] = []  # each segment's first launch (telemetry us)
    recorded = 0  # segments of ``ran`` whose telemetry is out
    epochs_run = start_t

    def fetch_rows(upto: int, kind: str):
        """Fetch hist rows [fetched, upto) with the counters: (nrun, done)."""
        nonlocal fetched
        with tel.span("engine.fetch", "engine", kind=kind):
            got, cnt = _fetch(hist[fetched:upto], torch.stack([run.nrun.float(),
                                                               run.done.float()]))
        host[fetched:upto] = got.reshape(-1, 5)
        fetched = upto
        record_landed()
        return int(cnt[0]), bool(cnt[1])

    def record_landed():
        """Telemetry of every segment whose rows are now all on the host,
        stamped now (the reference's ``_record_block``)."""
        nonlocal recorded
        if not tel.enabled:
            return
        t_end = tel.now_us()
        while recorded < len(ran) and ran[recorded].start - start_t + ran[recorded].length <= fetched:
            _record_segment(tel, ran[recorded], seg_t0[recorded], t_end,
                            host[ran[recorded].start - start_t:], epoch_cost,
                            getattr(reducer, "spec", None), workers,
                            k_block if sspec.kind == "block" else None)
            recorded += 1

    def history(upto: int) -> Dict[str, list]:
        hist_lists = {k: list(initial_history[k]) if initial_history is not None else []
                      for k in (*_HISTORY_KEYS, "k")}
        for seg in ran:
            block = host[seg.start - start_t:seg.start - start_t + seg.length]
            for c, name in enumerate(_HISTORY_KEYS):
                hist_lists[name].extend(float(v) for v in block[:, c])
            hist_lists["k"].extend([seg.k] * seg.length)
        for name in hist_lists:
            del hist_lists[name][upto:]
        return hist_lists

    for i, seg in enumerate(segments):
        lo = seg.start - start_t
        for off in range(0, seg.length, MAX_PROGRAM_EPOCHS):
            length = min(MAX_PROGRAM_EPOCHS, seg.length - off)
            sig = (seg.k, length, off > 0 and gap_tol is not None)
            prog = programs.get(sig)
            rec = None  # the op log of a program's capture or first launch
            if prog is None:
                t_build = tel.now_us()
                prog = programs[sig] = _Program(run, *sig, make_epoch)
                stats["compilations"] += 1
                timings["table_bytes"].append(prog.table_bytes)
                rec = OpRecorder() if tel.wants_hlo else None
                if capture:
                    if stream is None:
                        stream, pool = torch.cuda.Stream(device), torch.cuda.graph_pool_handle()
                        _warm_up(device, stream, _process_groups(group, reducer))
                    with rec if rec is not None else contextlib.nullcontext():
                        prog.capture(pool, stream)
                    timings["capture_ms"].append(prog.capture_ms)
                    timings["instantiate_ms"].append(prog.graph.instantiate_ms)
                    timings["pool_bytes"].append(prog.pool_bytes)
                tel.complete("engine.compile", "engine", t_build, tel.now_us() - t_build,
                             k=seg.k, length=length, captured=capture,
                             capture_ms=prog.capture_ms if capture else None,
                             instantiate_ms=prog.graph.instantiate_ms if capture else None)
            timings["draw_us"].append(prog.fill(seg.start + off))
            t_disp = tel.now_us()
            if off == 0:
                seg_t0.append(t_disp)
            with rec if rec is not None and not capture else contextlib.nullcontext():
                prog.launch()
            tel.complete("engine.dispatch", "engine", t_disp, tel.now_us() - t_disp,
                         start=seg.start + off, length=length, k=seg.k)
            if rec is not None:
                _record_executable(tel, prog, rec)
            hist[lo + off:lo + off + length].copy_(prog.aux)
            stats["graph_replays"] += prog.graph is not None
        ran.append(seg)
        stats["dispatches"] += 1
        stats["segments_run"] += 1
        last = i == len(segments) - 1
        if mode == "legacy":
            # the reference's oracle: four blocking pulls an epoch
            row = [float(prog.aux[0, c]) for c in range(4)]
            stats["host_syncs"] += 4
            piters = float(seg.k)
            if adapt:
                piters = float(prog.aux[0, 4])
                stats["host_syncs"] += 1
            host[lo] = row + [piters]
            fetched = lo + 1
            record_landed()
            epochs_run += 1
            stop = False
            if gap_tol is not None:
                stop = bool(run.done)
                stats["host_syncs"] += 1
            if callback is not None:
                callback(seg.start, EpochAux(*_fetch(*prog.aux.T)))
                stats["host_syncs"] += 1
            if checkpointer is not None and checkpointer.want(i, stop or last):
                stats["host_syncs"] += 1
                with explicit_sync():
                    checkpointer.save_segment(
                        t=epochs_run, carry=run.carry._replace(t=epochs_run),
                        history=history(epochs_run),
                        masks=None if masks is None else masks.numpy(), done=stop)
            if stop:
                break
            continue
        stopped = None
        if callback is not None or (checkpointer is not None and gap_tol is not None):
            # the light boundary fetch: it serves the callback and the stop
            epochs_run, stopped = fetch_rows(lo + seg.length, "boundary")
            stats["host_syncs"] += 1
            if callback is not None:
                callback(seg.start, EpochAux(*host[lo:lo + seg.length].T))
        if checkpointer is not None and checkpointer.want(i, bool(stopped) or last):
            stats["host_syncs"] += 1
            # one fetch: the rows, the counters and the carry's copy to the
            # host, before the next replay
            with explicit_sync():
                epochs_run, stopped = fetch_rows(lo + seg.length, "checkpoint")
                checkpointer.save_segment(
                    t=epochs_run, carry=run.carry._replace(t=epochs_run),
                    history=history(epochs_run),
                    masks=None if masks is None else masks.numpy(), done=stopped)
        if gap_tol is not None:
            if stopped is None:  # one flag at the boundary: launch the next segment?
                stats["host_syncs"] += 1
                with tel.span("engine.fetch", "engine", kind="done-flag"):
                    stopped = _fetch(run.done.float())[0][0] > 0
            if stopped:
                break

    if mode == "scan":
        epochs_run, _ = fetch_rows(ran[-1].start - start_t + ran[-1].length, "final")
        stats["host_syncs"] += 1
    if gap_tol is not None and epochs_run < num_epochs:
        tel.event("engine.early_stop", "engine", epoch=epochs_run,
                  gap=float(host[epochs_run - start_t - 1, 1]) if epochs_run > start_t else None,
                  gap_tol=gap_tol)
    live = host[:epochs_run - start_t]
    iters = int(live[:, 4].sum())
    for name, per_k in epoch_cost.items():
        stats[name] = stats.get(name, 0) + iters * per_k
    return EngineResult(carry=run.carry._replace(t=epochs_run), history=history(epochs_run),
                        epochs_run=epochs_run, stats=stats,
                        masks=None if masks is None else masks[:epochs_run], timings=timings)
