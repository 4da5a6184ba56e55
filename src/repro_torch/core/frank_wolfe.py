"""DFW-TRACE driver (paper Algorithm 2).

``make_epoch_step`` builds one FW epoch: power method on the implicit
gradient -> step size (2/(t+2) or the closed-form line search) ->
sufficient-information update + factored-iterate append. Everything an epoch
computes stays on the device: the step size, the gap and the aux row are
0-d tensors, and nothing in an epoch waits for the host.

Every epoch consumes and produces one ``EpochCarry``, in the JAX package's
field layout. Execution lives in ``core/engine.py``; ``fit`` below is the
serial driver on top of it.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from .. import DeviceLike, NoiseStream, V0Stream, as_v0_stream, resolve_device
from ..comm.base import DenseReducer, psum
from ..specs import validate
from . import low_rank
from .power_method import power_iterations
from .trace_norm import default_step_size, duality_gap

PyTree = Any


class EpochAux(NamedTuple):
    loss: torch.Tensor  # F(W^t) (pre-update), summed over workers
    gap: torch.Tensor  # duality-gap estimate at W^t
    sigma: torch.Tensor  # power-method top-singular-value estimate
    gamma: torch.Tensor  # step size actually taken
    piters: torch.Tensor  # power iterations executed (float32 scalar)


class EpochCarry(NamedTuple):
    """Everything one FW epoch threads to the next.

    ``comm_state`` is the reducer's per-worker state (``()`` for dense).
    ``t`` is the epoch counter. It is a host int: the host loop drives the
    epochs, and the step size 2/(t+2) is formed on the device from it without
    a transfer. ``key`` is the run's start-vector source (a
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
) -> Callable:
    """Returns ``epoch(carry) -> (carry, aux)`` with K = ``num_power_iters``.

    The scalar aggregates (loss, <W, grad>, line-search terms) always stay
    exact; ``reducer`` carries the power method's vector exchanges, with
    ``noise`` (default ``NoiseStream(0)``) for stochastic encodings.
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
    validate(solver=solver)
    if reducer is None:
        reducer = DenseReducer()
    if noise is None:
        noise = NoiseStream(0)

    def epoch(carry: EpochCarry):
        state, it = carry.state, carry.iterate
        device = it.alpha.device
        t = torch.full((), float(carry.t), dtype=torch.float32, device=device)
        loss = psum(task.local_loss(state))
        inner = psum(task.inner_w_grad(state))

        v0 = carry.key(carry.t, task.m, device)
        res, comm_state = power_iterations(
            partial(task.matvec, state),
            partial(task.rmatvec, state),
            v0,
            num_power_iters,
            reducer=reducer,
            comm_state=carry.comm_state,
            noise=noise,
            t=carry.t,
        )
        gap = duality_gap(inner, res.sigma, mu)

        if step_size == "linesearch":
            numer, denom = task.linesearch_terms(state, res.u, res.v, mu)
            numer, denom = psum(numer), psum(denom)
            gamma = torch.clamp(numer / torch.clamp(denom, min=1e-30), 0.0, 1.0)
        else:
            gamma = default_step_size(t)

        state = task.update(state, res.u, res.v, gamma, mu)
        it = low_rank.fw_update(it, res.u, res.v, gamma, mu)
        aux = EpochAux(
            loss=loss, gap=gap, sigma=res.sigma, gamma=gamma,
            piters=torch.full((), num_power_iters, dtype=torch.float32, device=device),
        )
        return EpochCarry(
            state=state, iterate=it, comm_state=comm_state,
            t=carry.t + 1, key=carry.key, probe=carry.probe,
        ), aux

    return epoch


# ---------------------------------------------------------------------------
# Serial driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitResult:
    """``history`` entries are *pre-update* measurements; ``final_loss`` is F
    at the returned iterate. ``epochs_run`` < the requested count when the
    gap certificate stopped the run; histories are truncated to it.
    ``stats`` are the engine's counters (see ``core/engine.py``)."""

    iterate: low_rank.FactoredIterate
    state: PyTree
    history: Dict[str, list]
    final_loss: float = float("nan")
    epochs_run: int = 0
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)


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
    start_t: int = 0,
    initial_history: Optional[Dict[str, list]] = None,
    solver: str = "rank1",
    noise: Optional[NoiseStream] = None,
    checkpointer=None,
    device: DeviceLike = None,
) -> FitResult:
    """Run DFW-TRACE for up to ``num_epochs`` epochs on ``device``.

    ``key`` is an int seed or a ``repro_torch.V0Stream``; ``noise`` is the
    stochastic encodings' ``NoiseStream`` (default: seeded like ``key``).
    ``history[name][t]`` is epoch t's measurement at W^t before its update;
    the loss of the returned iterate is ``final_loss``. ``gap_tol`` stops the run once the
    duality-gap certificate satisfies ``gap <= gap_tol``. ``callback(start_t,
    aux_block)`` fires once per segment with host numpy rows (NaN after an
    early stop). To resume, pass the state, iterate, ``start_t`` and
    ``initial_history`` of epoch ``start_t`` (``repro_torch.convert`` builds
    them from the JAX package's arrays). ``checkpointer`` (a
    ``repro_torch.checkpoint.RunCheckpointer``) saves segment boundaries;
    the caller joins its writer with ``checkpointer.wait()``.

    ``state`` is consumed: the dense tasks' update runs in place on its
    (n, m) tensors.
    """
    from .engine import run_epochs  # engine builds on this module

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
    )
    final_loss = float(task.local_loss(eres.carry.state))
    eres.stats["dispatches"] += 1
    eres.stats["host_syncs"] += 1
    return FitResult(
        iterate=eres.carry.iterate,
        state=eres.carry.state,
        history=eres.history,
        final_loss=final_loss,
        epochs_run=eres.epochs_run,
        stats=eres.stats,
    )
