"""DFW-TRACE driver (paper Algorithm 2).

``make_epoch_step`` builds one FW epoch: power method on the implicit
gradient -> step size (2/(t+2) or the closed-form line search) ->
sufficient-information update + factored-iterate append. Everything an epoch
computes stays on the device: the step size, the gap and the aux row are
0-d tensors, and nothing in an epoch waits for the host. What an epoch
reads besides its carry (the counter t, the straggler weight, the start
vector or block, the int8 noise) comes in as device tensors
(``EpochInputs``), so the engine can capture an epoch once in a CUDA graph
and replay it for every epoch of a segment.

Every epoch consumes and produces one ``EpochCarry``, in the JAX package's
field layout. Execution lives in ``core/engine.py``; ``fit`` below is the
driver on top of it, for one process or for one worker of a group.

``solver="block:k[:adapt][:cold]"`` is the BlockFW tier (arXiv:1708.02105):
a rank-k block power iteration whose k atoms are blended into one feasible
direction and appended together, the orthonormalized right block carried in
``EpochCarry.probe`` as the next epoch's warm start.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from .. import DeviceLike, NoiseStream, V0Stream, as_v0_stream, resolve_device
from ..analysis.contracts import explicit_sync
from ..comm.base import DenseReducer, WorkerGroup, pmax, psum
from ..specs import parse_solver, validate
from . import low_rank
from .power_method import (block_power_iterations, host_when, orthonormalize_block,
                           power_iterations)
from .trace_norm import default_step_size, duality_gap

PyTree = Any


class EpochAux(NamedTuple):
    loss: torch.Tensor  # F(W^t) (pre-update), summed over workers
    gap: torch.Tensor  # duality-gap estimate at W^t
    sigma: torch.Tensor  # power-method top-singular-value estimate
    gamma: torch.Tensor  # step size actually taken
    piters: torch.Tensor  # power iterations executed (float32 scalar)


class EpochInputs(NamedTuple):
    """What one epoch reads besides its carry, as device tensors: rows of a
    segment's input tables (``core/engine.py``)."""

    t: torch.Tensor  # () float32 epoch counter (the step size 2/(t+2))
    weight: Optional[torch.Tensor]  # () float32 straggler weight; None: full participation
    v0: torch.Tensor  # (m,) start vector, or the block solver's (m, k) fresh columns
    noise: Optional[tuple]  # (K, D) u-slot and (K, M) v-slot draws of a stochastic encoding


class EpochCarry(NamedTuple):
    """Everything one FW epoch threads to the next.

    ``comm_state`` is the reducer's per-worker state (``()`` for dense).
    ``t`` is the epoch counter, a host int: the engine knows each segment's
    first epoch and hands the epochs their counters as ``EpochInputs.t``.
    ``key`` is the run's start-vector source (a
    ``repro_torch.V0Stream``), the counterpart of the replicated PRNG key.
    ``probe`` is the block solver's warm start, ``()`` for rank1.
    """

    state: PyTree
    iterate: low_rank.FactoredIterate
    comm_state: PyTree
    t: int
    key: V0Stream
    probe: PyTree = ()


def init_carry(
    state: PyTree,
    iterate: low_rank.FactoredIterate,
    key,
    comm_state: PyTree = (),
    t: int = 0,
    probe: PyTree = (),
) -> EpochCarry:
    """Carry at epoch ``t`` (0 for a fresh run, the saved counter to resume)."""
    return EpochCarry(
        state=state, iterate=iterate, comm_state=comm_state, t=int(t),
        key=as_v0_stream(key), probe=probe,
    )


# ---------------------------------------------------------------------------
# Solver tiers
# ---------------------------------------------------------------------------

#: Relative tolerance of the adaptive block power iteration: once no
#: estimated singular value moved by more than ADAPT_RTOL of the gap
#: certificate's scale, the epoch's remaining iterations are skipped.
ADAPT_RTOL = 0.05


def solver_probe_shape(spec, m: int) -> Optional[tuple]:
    """Shape of the warm-start probe in ``EpochCarry.probe``: (m, k) for the
    block solver, None for rank1 (no probe)."""
    s = parse_solver(spec)
    return (m, s.k) if s.kind == "block" else None


def init_probe(spec, m: int, device: DeviceLike = None, seed: int = 0x5EED):
    """Cold-start probe of a fresh run: an orthonormal (m, k) block of unit
    columns, ``V0Stream(seed).block(0, ...)`` on ``device`` (the same on
    every worker, no communication), for the block solver, ``()``
    for rank1. The reference draws its columns from ``PRNGKey(0x5EED)``; a
    caller may pass that block to ``fit(..., probe=)`` instead."""
    shape = solver_probe_shape(spec, m)
    if shape is None:
        return ()
    return orthonormalize_block(V0Stream(seed).block(0, m, shape[1], resolve_device(device)))


# ---------------------------------------------------------------------------
# K(t) schedules (paper Thm 2 + experimental settings §5)
# ---------------------------------------------------------------------------


def k_schedule(name: str) -> Callable[[int], int]:
    """Power-iteration schedules:

    - ``const:K``   K(t) = K
    - ``log``       K(t) = floor(1 + ln(t+1))
    - ``log_half``  K(t) = floor(1 + 0.5 ln(t+1))  (paper's logistic setting)
    - ``linear:c``  K(t) = 1 + ceil(c (t+2))

    Every schedule must give K(t) >= 1 (K=0 yields a zero LMO direction).
    """
    if name.startswith("const:"):
        k = int(name.split(":")[1])
        if k < 1:
            raise ValueError(
                f"K schedule {name!r}: K must be >= 1 (K=0 yields a zero LMO "
                "direction and a meaningless duality gap)"
            )
        return lambda t: k
    if name == "log":
        return lambda t: int(1 + math.log(t + 1))
    if name == "log_half":
        return lambda t: max(1, int(1 + 0.5 * math.log(t + 1)))
    if name.startswith("linear:"):
        c = float(name.split(":")[1])
        if c <= 0:
            raise ValueError(f"K schedule {name!r}: slope c must be > 0 so K(t) >= 1")
        return lambda t: 1 + int(math.ceil(c * (t + 2)))
    raise ValueError(f"unknown K schedule: {name!r}")


# ---------------------------------------------------------------------------
# One FW epoch
# ---------------------------------------------------------------------------


def make_epoch_step(
    task,
    mu: float,
    num_power_iters: int,
    *,
    step_size: str = "default",
    reducer: Optional[DenseReducer] = None,
    solver="rank1",
    noise: Optional[NoiseStream] = None,
    group: Optional[WorkerGroup] = None,
    when: Callable = host_when,
) -> Callable:
    """Returns ``epoch(carry, worker_weight=None, inputs=None) -> (carry,
    aux)`` with K = ``num_power_iters``.

    ``inputs`` (an ``EpochInputs``) is what the engine hands each epoch: the
    counter, the weight, the start vector (block) and the int8 noise as
    device tensors. Without it the epoch draws them itself, from
    ``carry.key`` and ``noise`` (default ``NoiseStream(0)``) at
    ``carry.t``, with ``worker_weight`` as its weight.

    The scalar aggregates (loss, <W, grad>, line-search terms) always stay
    exact f32 sums over ``group`` (None: one process); ``reducer`` (a
    reducer or a ``comm.topology`` graph) carries the power method's vector
    exchanges. Under a per-node graph (gossip) every worker has its own u,
    v and sigma: the gap and sigma of the aux are then the largest over
    the workers (one all-reduce MAX), so ``gap <= tol`` certifies every
    worker's iterate, as in the reference. The straggler weight scales the
    worker's loss, <W, grad>, line-search terms and power-method
    contributions, as in the reference (None: full participation, no
    multiply). The state, the iterate and the aux are the same on every
    worker after the epoch (on a flat graph): every worker forms them from
    the same all-reduced values. The iterate's store is updated in place.

    ``solver`` "block:k" runs ``block_power_iterations`` from the carried
    probe (its columns of norm <= 1e-6 swapped for the epoch's fresh ones;
    ``:cold`` starts from the fresh columns alone), the gap from the largest
    sigma, the atoms blended by c = sigma / (sum sigma + 1e-30) folded into
    u, and appends k factors; ``:adapt`` stops the iteration at
    ``ADAPT_RTOL``, its iterations after the first under ``when`` (a host
    branch by default; the engine's IF nodes when it captures the epoch).
    The aux's ``piters`` is the count of iterations run, on the device.
    Gossip graphs take rank1 only (as in the reference).
    """
    if step_size not in ("default", "linesearch"):
        raise ValueError(step_size)
    if step_size == "linesearch" and not hasattr(task, "linesearch_terms"):
        raise ValueError(f"{type(task).__name__} has no closed-form line search")
    if num_power_iters < 1:
        raise ValueError(
            f"num_power_iters={num_power_iters}: at least one power iteration "
            "is required (K=0 would feed a zero singular direction to the LMO)"
        )
    sspec, _, _ = validate(solver=solver)
    if reducer is None:
        reducer = DenseReducer()
    if noise is None:
        noise = NoiseStream(0)
    if sspec.kind == "block" and getattr(reducer, "per_node", False):
        raise ValueError(
            "per-node topologies (gossip) support only the rank1 solver: the block tier "
            "orthonormalizes against a consensus block, which a master-less exchange cannot "
            "provide; use topology='flat' or 'hier:g' with solver='block:k'"
        )
    per_node = group is not None and getattr(reducer, "per_node", False)
    # where the workers' exchanged blocks may part, they vote on :adapt's stop
    agree = (group if group is not None and not getattr(reducer, "replicated", True)
             else None)

    def sums(w, *local):
        """The workers' sums of the w-weighted local scalars, in one all-reduce."""
        if w is not None:
            local = tuple(w * x for x in local)
        if group is None:
            return local
        return tuple(psum(torch.stack(local), group).unbind())

    def draw(carry: EpochCarry, device, worker_weight) -> EpochInputs:
        """The epoch's own inputs, drawn at ``carry.t``."""
        if sspec.kind == "block":
            v0 = carry.key.block(carry.t, task.m, sspec.k, device)
        else:
            v0 = carry.key(carry.t, task.m, device)
        w = None
        if worker_weight is not None:
            w = torch.full((), float(worker_weight), dtype=torch.float32, device=device)
        return EpochInputs(t=torch.full((), float(carry.t), dtype=torch.float32, device=device),
                           weight=w, v0=v0, noise=None)

    def epoch(carry: EpochCarry, worker_weight: Optional[float] = None,
              inputs: Optional[EpochInputs] = None):
        state = carry.state
        device = carry.iterate.alpha.device
        # exchange (i, slot)'s noise: the stream at carry.t for an epoch that
        # draws its own inputs, else the inputs' tables (None: no encoding
        # that draws)
        noise_fn = None
        if inputs is None:
            inputs = draw(carry, device, worker_weight)

            def noise_fn(_t, i, slot, dim, dev):
                return noise(carry.t, i, slot, dim, dev)
        elif inputs.noise is not None:
            tables = dict(zip(("u", "v"), inputs.noise))

            def noise_fn(_t, i, slot, dim, dev):
                return tables[slot][i]
        w = inputs.weight
        loss, inner = sums(w, task.local_loss(state), task.inner_w_grad(state))
        if sspec.kind == "block":
            return block_epoch(carry, inputs, noise_fn, loss, inner)

        res, comm_state = power_iterations(
            partial(task.matvec, state),
            partial(task.rmatvec, state),
            inputs.v0,
            num_power_iters,
            reducer=reducer,
            comm_state=carry.comm_state,
            noise=noise_fn,
            t=carry.t,
            worker_weight=w,
        )
        gap, sigma = duality_gap(inner, res.sigma, mu), res.sigma
        if per_node:
            gap, sigma = pmax(torch.stack([gap, sigma]), group).unbind()

        if step_size == "linesearch":
            numer, denom = sums(w, *task.linesearch_terms(state, res.u, res.v, mu))
            gamma = torch.clamp(numer / torch.clamp(denom, min=1e-30), 0.0, 1.0)
        else:
            gamma = default_step_size(inputs.t)

        state = task.update(state, res.u, res.v, gamma, mu)
        it = low_rank.fw_update(carry.iterate, res.u, res.v, gamma, mu)
        aux = EpochAux(
            loss=loss, gap=gap, sigma=sigma, gamma=gamma,
            piters=torch.full((), num_power_iters, dtype=torch.float32, device=device),
        )
        return EpochCarry(
            state=state, iterate=it, comm_state=comm_state,
            t=carry.t + 1, key=carry.key, probe=carry.probe,
        ), aux

    def block_epoch(carry: EpochCarry, inputs: EpochInputs, noise_fn, loss, inner):
        state = carry.state
        # the epoch's fresh columns; a warm probe replaces all but its dead ones
        v0 = inputs.v0
        if not sspec.cold and isinstance(carry.probe, torch.Tensor):
            col_norm = torch.linalg.vector_norm(carry.probe, dim=0, keepdim=True)
            v0 = torch.where(col_norm > 1e-6, carry.probe, v0)
        w = inputs.weight
        res, comm_state = block_power_iterations(
            partial(task.matvec, state),
            partial(task.rmatvec, state),
            v0,
            num_power_iters,
            reducer=reducer,
            comm_state=carry.comm_state,
            noise=noise_fn,
            t=carry.t,
            worker_weight=w,
            adapt_rtol=ADAPT_RTOL if sspec.adaptive else None,
            # the gap certificate is inner + mu sigma_max: changes small
            # against |inner| / mu (or sigma itself) cannot move it
            adapt_ref=torch.abs(inner) / mu,
            agree=agree,
            when=when,
        )
        sigma_max = torch.max(res.sigma)
        gap = duality_gap(inner, sigma_max, mu)
        # S = -mu sum_j c_j u_j v_j^T with c = sigma / sum(sigma) (sum c <= 1
        # keeps ||S||_* <= mu), c folded into u's columns for the tasks
        c = res.sigma / (torch.sum(res.sigma) + 1e-30)
        u_c = res.u * c[None, :]
        if step_size == "linesearch":
            numer, denom = sums(w, *task.linesearch_terms(state, u_c, res.v, mu))
            gamma = torch.clamp(numer / torch.clamp(denom, min=1e-30), 0.0, 1.0)
        else:
            gamma = default_step_size(inputs.t)
        state = task.update(state, u_c, res.v, gamma, mu)
        it = low_rank.fw_update_block(carry.iterate, res.u, res.v, c, gamma, mu)
        aux = EpochAux(loss=loss, gap=gap, sigma=sigma_max, gamma=gamma, piters=res.iters)
        return EpochCarry(
            state=state, iterate=it, comm_state=comm_state,
            t=carry.t + 1, key=carry.key, probe=res.probe,
        ), aux

    return epoch


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    """``history`` entries are *pre-update* measurements; ``final_loss`` is F
    at the returned iterate. ``epochs_run`` < the requested count when the
    gap certificate stopped the run; histories are truncated to it.
    ``stats`` are the engine's counters (see ``core/engine.py``); ``masks``
    the straggler weights of the epochs run, (epochs_run, N), when the run
    was given them; ``comm_state`` the reducer's state at the end (top-k's
    residuals, ``()`` for dense and int8); ``probe`` the block solver's
    warm start at the end (``()`` for rank1); ``timings`` the engine's
    (draws, captures)."""

    iterate: low_rank.FactoredIterate
    state: PyTree
    history: Dict[str, list]
    final_loss: float = float("nan")
    epochs_run: int = 0
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    masks: Optional[torch.Tensor] = None
    comm_state: PyTree = ()
    probe: PyTree = ()  # the block solver's (m, k) warm start after the last epoch
    timings: Dict[str, list] = dataclasses.field(default_factory=dict)  # the engine's


def fit(
    task,
    state: PyTree,
    *,
    mu: float,
    num_epochs: int,
    key=0,
    schedule: str = "const:2",
    step_size: str = "default",
    callback: Optional[Callable[[int, EpochAux], None]] = None,
    reducer=None,
    max_rank: Optional[int] = None,
    gap_tol: Optional[float] = None,
    block_epochs: Optional[int] = None,
    iterate: Optional[low_rank.FactoredIterate] = None,
    comm_state=None,
    start_t: int = 0,
    initial_history: Optional[Dict[str, list]] = None,
    solver: str = "rank1",
    noise: Optional[NoiseStream] = None,
    checkpointer=None,
    device: DeviceLike = None,
    group: Optional[WorkerGroup] = None,
    masks=None,
    probe=None,
    mode: str = "scan",
    telemetry=None,
) -> FitResult:
    """Run DFW-TRACE for up to ``num_epochs`` epochs on ``device``.

    ``state`` is this worker's rows. ``group`` (a ``comm.WorkerGroup``)
    makes this call one worker of a multi-worker run: every aggregate is
    summed over the group, and every worker must make the same call on its
    own rows. ``masks`` is the (num_epochs, N) straggler-weight table, of
    which this worker reads its own column (see ``core/engine.py``).

    ``key`` is an int seed or a ``repro_torch.V0Stream``; ``noise`` is the
    stochastic encodings' ``NoiseStream`` (default: seeded like ``key``).
    ``history[name][t]`` is epoch t's measurement at W^t before its update;
    the loss of the returned iterate is ``final_loss``. ``gap_tol`` stops the run once the
    duality-gap certificate satisfies ``gap <= gap_tol``. ``callback(start_t,
    aux_block)`` fires once per segment with host numpy rows (NaN after an
    early stop). To resume, pass the state, iterate, ``comm_state`` (the
    reducer's, default its ``init_state``), ``start_t`` and
    ``initial_history`` of epoch ``start_t`` (``repro_torch.convert`` builds
    them from the JAX package's arrays). ``checkpointer`` (a
    ``repro_torch.checkpoint.RunCheckpointer``) saves segment boundaries;
    the caller joins its writer with ``checkpointer.wait()``.

    ``state`` is consumed: the run writes its tensors in place.

    ``mode`` is the engine's: "scan" (one dispatch a segment, captured as a
    CUDA graph on the card) or "legacy" (one an epoch, four blocking pulls
    each); see ``core/engine.py``.

    ``solver`` "block:k[:adapt][:cold]" runs the block tier: an epoch
    appends k factors (``max_rank`` defaults to ``num_epochs * k``), and
    ``probe`` is the (m, k) warm start of epoch ``start_t`` (default
    ``init_probe``'s cold start); ``FitResult.probe`` is the last one.

    ``telemetry`` (an ``obs.Telemetry``; the inert no-op when None) goes to
    the engine (its spans, samples and counters; see ``core/engine.py``),
    and the final loss's evaluation is its ``engine.final_loss`` span and
    ``dfw.final_loss`` gauge. It changes no bit, no ``stats`` entry and no
    launch.
    """
    from ..obs import Telemetry
    from .engine import run_epochs  # engine builds on this module

    tel = telemetry if telemetry is not None else Telemetry.noop()
    dev = resolve_device(device)
    state = type(state)(*(t if t is None else t.to(dev) for t in state))
    if iterate is not None:
        iterate = low_rank.FactoredIterate(*(t.to(dev) for t in iterate))
    eres = run_epochs(
        task,
        state,
        mu=mu,
        num_epochs=num_epochs,
        key=key,
        schedule=schedule,
        step_size=step_size,
        reducer=reducer,
        iterate=iterate,
        comm_state=comm_state,
        max_rank=max_rank,
        gap_tol=gap_tol,
        block_epochs=block_epochs,
        callback=callback,
        start_t=start_t,
        initial_history=initial_history,
        solver=solver,
        noise=noise,
        checkpointer=checkpointer,
        device=dev,
        group=group,
        masks=masks,
        probe=probe,
        mode=mode,
        telemetry=tel,
    )
    # F at the returned iterate over all the workers' rows: the plain sum,
    # never weighted by the straggler masks.
    with tel.span("engine.final_loss", "engine"), explicit_sync():
        final_loss = float(psum(task.local_loss(eres.carry.state), group))
    eres.stats["dispatches"] += 1
    eres.stats["host_syncs"] += 1
    if tel.enabled:
        tel.registry.gauge("dfw.final_loss").set(final_loss)
    return FitResult(
        iterate=eres.carry.iterate,
        state=eres.carry.state,
        history=eres.history,
        final_loss=final_loss,
        epochs_run=eres.epochs_run,
        stats=eres.stats,
        masks=eres.masks,
        comm_state=eres.carry.comm_state,
        probe=eres.carry.probe,
        timings=eres.timings,
    )
