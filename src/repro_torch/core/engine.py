"""Epoch engine: the K(t) schedule cut into constant-K segments.

``plan_segments`` partitions the schedule into maximal constant-K runs
(optionally capped at ``block_epochs``), as in the JAX package. Each segment
runs as a host loop of epochs whose work is all enqueued on the device: the
aux rows stay device tensors and are fetched once at the end of the run (or
once per segment when a callback wants them), so a run without ``gap_tol``
never waits for the device between epochs.

``gap_tol`` is the one exception. The JAX engine carries a device-side
``done`` flag and turns the epochs after the certificate into ``lax.cond``
no-ops. Eager PyTorch has no device-side branch that skips work, so this
engine reads the gap's verdict on the host after every epoch while
``gap_tol`` is set (one sync per epoch, counted in ``stats["host_syncs"]``),
then fills the rest of the segment with NaN rows, as the JAX engine does.
``epochs_run`` counts the epochs that ran and the histories are truncated to
it.

``checkpointer`` (a ``repro_torch.checkpoint.RunCheckpointer``) makes the
run durable: at each segment boundary it ``want``s, the engine fetches the
aux blocks not yet on the host and hands the carry to ``save_segment``,
which copies it to the host for an asynchronous write. That is one host
sync per saved boundary, counted in ``stats["host_syncs"]``; boundaries the
checkpointer does not want cost nothing.

``stats`` counts the engine's interactions with the device:
``segments_planned``/``segments_run``, ``dispatches`` (epoch steps
enqueued, plus the final loss in ``fit``) and ``host_syncs`` (every point
where the host waits for the device). It also holds the analytic comm cost
of the epochs run, as the reference derives it for its telemetry:
``comm_rounds`` (2K exchanges an epoch, times a topology's rounds per
exchange), ``comm_logical_bytes`` (the f32 vectors, 8 (d + m) K an epoch),
``comm_wire_bytes`` (the reducer's or graph's ``wire_bytes``) and, for a
graph, ``comm_hop_bytes_<hop>`` (``hop_wire_bytes``: global, neighbor,
intra, inter). The block solver "block:k" exchanges flattened (d k,) and
(m k,) blocks, so its costs are those of vectors k times as wide (and its
reducer state, top-k's residuals, is sized for them); K counts the
iterations that ran, fewer than K(t) when ``:adapt`` stopped an epoch early
(the reference counts the static K there), so the count stays the one the
workers' collectives show. ``:adapt``'s host reads of its verdict, one an
iteration, are host syncs too. The block solver's warm-start probe rides in
the carry, replicated, from ``probe`` (default: ``init_probe``).

With ``group`` (a ``comm.WorkerGroup``) the engine runs one worker of a
multi-worker run: every worker runs this same loop on its own rows, and
every aggregate of an epoch is an all-reduce over the group. ``masks`` is
the run's (num_epochs, N) straggler-weight table on the host; worker j
takes column j of row t as its weight in epoch t. Where the workers' gaps
may part (an int8 exchange across ``hier`` groups rounds with each
worker's own noise), the ``gap_tol`` verdict reads the largest gap over
the workers, so every worker stops at the same epoch; a gossip graph's
aux gap is that maximum already.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from .. import NoiseStream, as_v0_stream
from ..comm.base import DenseReducer, WorkerGroup, pmax
from ..specs import validate
from . import low_rank
from .frank_wolfe import (EpochAux, EpochCarry, init_carry, init_probe, k_schedule,
                          make_epoch_step)


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


@dataclasses.dataclass
class EngineResult:
    carry: EpochCarry
    history: Dict[str, list]
    epochs_run: int
    stats: Dict[str, int]
    masks: Optional[torch.Tensor] = None  # (epochs_run, N) weights, if given


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


def _stack_rows(rows: List[EpochAux]) -> EpochAux:
    """(length,) device columns from a segment's aux rows."""
    return EpochAux(*(torch.stack(col) for col in zip(*rows)))


def _fetch(blocks: List[list]) -> None:
    """Copy every block not yet on the host in one transfer (in place)."""
    pending = [b for b in blocks if b[2] is None]
    if not pending:
        return
    flat = torch.stack([torch.cat(cols) for cols in zip(*(b[1] for b in pending))])
    flat = flat.cpu().numpy()
    lo = 0
    for b in pending:
        hi = lo + len(b[1].loss)
        b[2] = EpochAux(*flat[:, lo:hi])
        lo = hi


def _history(initial: Optional[Dict[str, list]], blocks: List[list], upto: int
             ) -> Dict[str, list]:
    """The initial history plus every (fetched) block, cut to ``upto`` epochs."""
    history: Dict[str, list] = {
        k: list(initial[k]) if initial is not None else []
        for k in (*_HISTORY_KEYS, "k")
    }
    for seg, _, host in blocks:
        for name, col in zip(_HISTORY_KEYS, host):
            history[name].extend(float(v) for v in col)
        history["k"].extend([seg.k] * seg.length)
    for name in history:
        del history[name][upto:]
    return history


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
) -> EngineResult:
    """Run up to ``num_epochs`` DFW-Trace epochs of one worker on ``device``
    (``group``: one worker of that group; ``masks``: the (num_epochs, N)
    straggler weights, see the module doc).

    ``iterate`` defaults to a fresh store of ``max_rank`` capacity (validated
    >= num_epochs times the atoms an epoch appends), ``comm_state`` to
    ``reducer.init_state`` on ``device`` (at d k and m k for "block:k"),
    ``probe`` (block solver) to ``init_probe``. ``start_t``/``initial_history``/``iterate``/``state``
    resume a run at epoch ``start_t``; the plan is recomputed from there.
    ``noise`` feeds stochastic encodings; it defaults to a ``NoiseStream``
    with the seed of ``key``.
    """
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
    if sspec.kind == "block":
        if probe is None:
            probe = init_probe(sspec, task.m, device)
        elif isinstance(probe, torch.Tensor):
            probe = probe.to(device=device, dtype=torch.float32)
        else:  # a host array (the reference's init_probe, a checkpoint's leaf)
            probe = torch.tensor(probe, dtype=torch.float32, device=device)
        if tuple(probe.shape) != (task.m, sspec.k):
            raise ValueError(f"probe has shape {tuple(probe.shape)}; the solver carries "
                             f"({task.m}, {sspec.k})")
    else:
        probe = ()
    segments = plan_segments(schedule, num_epochs, block_epochs, start=start_t)
    stats = {
        "segments_planned": len(segments),
        "segments_run": 0,
        "dispatches": 0,
        "host_syncs": 0,
        "comm_rounds": 0,
        "comm_logical_bytes": 0,
        "comm_wire_bytes": 0,
    }
    epoch_cost = _comm_cost_per_k(reducer, task.d * k_block, task.m * k_block, workers)
    if comm_state is None:
        comm_state = reducer.init_state(task.d * k_block, task.m * k_block, device=device)
    carry = init_carry(state, iterate, key, comm_state, t=start_t, probe=probe)
    agree = (group is not None and not getattr(reducer, "per_node", False)
             and not getattr(reducer, "replicated", True))
    tol = None
    if gap_tol is not None:
        tol = torch.full((), gap_tol, dtype=torch.float32, device=device)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=device)
    nan_row = EpochAux(nan, nan, nan, nan, nan)

    blocks: List[list] = []  # [segment, device EpochAux block, host block or None]
    epochs_run = start_t
    stopped = False
    for i, seg in enumerate(segments):
        epoch = make_epoch_step(
            task, mu, seg.k, step_size=step_size, reducer=reducer, solver=solver,
            noise=noise, group=group,
        )
        rows: List[EpochAux] = []
        for _ in range(seg.length):
            if stopped:
                rows.append(nan_row)
                continue
            weight = None if masks is None else float(masks[carry.t, rank])
            carry, aux = epoch(carry, weight)
            stats["dispatches"] += 1
            if adapt:  # one host read of the stop's verdict an iteration run
                stats["host_syncs"] += epoch.last_iters
            for name, per_k in epoch_cost.items():
                stats[name] = stats.get(name, 0) + epoch.last_iters * per_k
            epochs_run += 1
            rows.append(aux)
            if tol is not None:
                # The gap comes from all-reduced values (<W, grad> and the
                # exchanged vector's norm), the same bits on every worker
                # unless the graph parts them (then their max), so every
                # worker reads the same verdict and stops at the same epoch.
                stats["host_syncs"] += 1
                gap = pmax(aux.gap.clone(), group) if agree else aux.gap
                stopped = bool(gap <= tol)
        stats["segments_run"] += 1
        block = _stack_rows(rows)
        host = None
        if callback is not None:
            host = EpochAux(*torch.stack(list(block)).cpu().numpy())
            stats["host_syncs"] += 1
            callback(seg.start, host)
        blocks.append([seg, block, host])
        if checkpointer is not None and checkpointer.want(i, stopped or i == len(segments) - 1):
            # One sync: the history so far, then the carry's copy to the host
            # inside save_segment (the device is idle by then).
            _fetch(blocks)
            stats["host_syncs"] += 1
            checkpointer.save_segment(
                t=epochs_run, carry=carry, history=_history(initial_history, blocks, epochs_run),
                masks=None if masks is None else masks.numpy(), done=stopped,
            )
        if stopped:
            break

    if any(b[2] is None for b in blocks):
        _fetch(blocks)
        stats["host_syncs"] += 1
    history = _history(initial_history, blocks, epochs_run)
    return EngineResult(carry=carry, history=history, epochs_run=epochs_run, stats=stats,
                        masks=None if masks is None else masks[:epochs_run])
