"""Declared cost contracts, checked against what a program ran and against a
run's counters: the port's copy of the JAX package's
``repro.analysis.contracts``.

DFW-Trace's cost claims are statements about programs and counters: an
epoch with K power iterations costs exactly 2K collective rounds, a
``const:K`` run is one dispatch a segment, serving never builds the d x m
matrix, nothing crosses from the card to the host unasked, and the disabled
telemetry handle is free and silent. A :class:`Contract` states such bounds
once, beside the code that owns them (``core.power_method.
collective_rounds_contract``, ``comm.topology.Topology.collective_contract``,
``core.engine.dispatch_contract``, ``serve.ServingEngine.contract``,
``obs.noop_contract``), and the tests and ``tools/torch_contracts.py`` check
the same declaration. Four surfaces:

- ``check_ops(target, *args)`` reads an op log (``analysis.recorder``: a
  program's capture, or its eager run) where the reference reads compiled
  HLO: collective counts, the round budget, forbidden output shapes, and,
  for a contract with ``no_host_transfers``/``max_host_syncs``, the log's
  implicit device reads and the explicit fetch blocks that read the device.
- ``check_stats(stats)``: the dispatch, compilation and host-sync caps
  against an engine's or a serving engine's ``stats``.
- ``check_telemetry(handle)``: the cost of a span and the events recorded.
- ``guard()``: inside it, on the card, an operation that waits for the card
  (``.item()``, ``.cpu()``, ``float(t)``, ``nonzero``) raises, through
  PyTorch's CUDA sync debug mode, the counterpart of
  ``jax.transfer_guard_device_to_host("disallow")``. The engine's own
  fetches, which it counts in ``stats["host_syncs"]``, go through
  :func:`explicit_sync`, as ``jax.device_get`` passes the JAX guard.

Every violation raises :class:`ContractViolation` (an ``AssertionError``)
naming the contract, the clause, and what was seen against what is allowed.
:func:`verify_declared` checks every declared contract at probe scale: the
collective ones over gloo worker processes on the CPU, the rest on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from . import recorder


class ContractViolation(AssertionError):
    """A program or a runtime counter broke a declared invariant."""


def measure(target: Any, *args, **kwargs) -> Dict:
    """The op-log analysis of ``target`` (``recorder.analyze``'s dict):
    ``target`` is such a dict, an ``OpRecorder``, or a callable run under a
    fresh recorder with ``args``/``kwargs``."""
    if isinstance(target, dict):
        return target
    if isinstance(target, recorder.OpRecorder):
        return target.analyze()
    if callable(target):
        with recorder.OpRecorder() as rec:
            target(*args, **kwargs)
        return rec.analyze()
    raise TypeError(
        f"cannot read an op log from {type(target).__name__}; pass an OpRecorder, its "
        "analyze() dict, or a callable and its arguments"
    )


@dataclasses.dataclass(frozen=True)
class Contract:
    """One layer's declared cost and discipline invariants.

    Op-log clauses (``check_ops``): ``collective_counts``, the exact
    collectives by kind the program runs (the power method's
    ``{"all-reduce": 2K}``); ``max_collective_rounds``, a cap on their
    total; ``forbid_shapes``, output shapes no op may produce (factor-form
    serving's ``((d, m), (m, d))``).

    Counter clauses (``check_stats``): ``max_dispatches``,
    ``max_compilations``, ``max_host_syncs``. ``no_host_transfers`` is the
    transfer discipline: ``guard()`` enforces it on the card, ``check_ops``
    on a log (no implicit device read; with ``max_host_syncs``, at most that
    many explicit fetch blocks that read the device).

    Telemetry clauses (``check_telemetry``): ``max_noop_span_us`` caps the
    cost of entering and leaving one ``span()``, ``max_events`` the events
    the handle recorded: together they pin the disabled default to free and
    silent (``obs.noop_contract``).
    """

    name: str
    collective_counts: Optional[Mapping[str, float]] = None
    max_collective_rounds: Optional[float] = None
    forbid_shapes: Tuple[Tuple[int, ...], ...] = ()
    max_dispatches: Optional[int] = None
    max_compilations: Optional[int] = None
    max_host_syncs: Optional[int] = None
    no_host_transfers: bool = False
    max_noop_span_us: Optional[float] = None
    max_events: Optional[int] = None

    def _fail(self, clause: str, detail: str):
        raise ContractViolation(f"contract {self.name!r}: {clause}: {detail}")

    # ------------------------------------------------------------------ ops
    def check_ops(self, target: Any, *args, **kwargs) -> Dict:
        """Assert the op-log clauses against ``target`` (see :func:`measure`);
        returns the analysis."""
        analysis = measure(target, *args, **kwargs)
        counts = analysis["collective_count"]
        if self.collective_counts is not None:
            want = {k: float(v) for k, v in self.collective_counts.items() if v}
            if counts != want:
                self._fail("collective_counts",
                           f"the program runs {counts or '{}'}, declared {want}")
        if self.max_collective_rounds is not None:
            total = sum(counts.values())
            if total > self.max_collective_rounds:
                self._fail("max_collective_rounds",
                           f"{total} collectives > {self.max_collective_rounds} (by kind: "
                           f"{counts})")
        for dims in self.forbid_shapes:
            ops = analysis["shapes"].get(tuple(int(d) for d in dims))
            if ops:
                self._fail("forbid_shapes", f"shape {tuple(dims)} made by {', '.join(ops)}")
        if self.no_host_transfers and analysis["implicit_syncs"]:
            self._fail("no_host_transfers",
                       f"{analysis['implicit_syncs']} implicit device reads")
        if self.no_host_transfers and self.max_host_syncs is not None:
            if analysis["explicit_syncs"] > self.max_host_syncs:
                self._fail("max_host_syncs", f"{analysis['explicit_syncs']} explicit fetch "
                           f"blocks > declared max {self.max_host_syncs}")
        return analysis

    # ---------------------------------------------------------------- stats
    def check_stats(self, stats: Mapping[str, int]) -> None:
        """Assert the declared caps against an engine or serving ``stats``
        dict (only the declared caps are checked)."""
        for key, cap in (
            ("dispatches", self.max_dispatches),
            ("compilations", self.max_compilations),
            ("host_syncs", self.max_host_syncs),
        ):
            if cap is None:
                continue
            if key not in stats:
                self._fail(key, f"stats dict has no {key!r} counter: {dict(stats)}")
            if stats[key] > cap:
                self._fail(key, f"{stats[key]} > declared max {cap} ({dict(stats)})")

    # ------------------------------------------------------------ telemetry
    def check_telemetry(self, telemetry, iters: int = 2000) -> None:
        """Assert the telemetry clauses against an ``obs.Telemetry``: the
        mean cost of ``iters`` empty spans against ``max_noop_span_us`` and
        the handle's event count against ``max_events`` (an enabled handle
        fails the no-op contract's event clause: that is the point). Both
        clauses are checked, and one ``ContractViolation`` names every clause
        that failed, so a slow machine's timing cannot hide the event count."""
        failed = []
        if self.max_noop_span_us is not None:
            t0 = time.perf_counter()
            for _ in range(iters):
                with telemetry.span("contract.noop_probe"):
                    pass
            per_span_us = (time.perf_counter() - t0) * 1e6 / iters
            if per_span_us > self.max_noop_span_us:
                failed.append(f"max_noop_span_us: {per_span_us:.2f}us per span() > declared "
                              f"{self.max_noop_span_us}us")
        if self.max_events is not None:
            n = telemetry.event_count()
            if n > self.max_events:
                failed.append(f"max_events: handle recorded {n} events > declared "
                              f"{self.max_events} (enabled={telemetry.enabled})")
        if failed:
            raise ContractViolation(f"contract {self.name!r}: " + "; ".join(failed))

    # ---------------------------------------------------------------- guard
    def guard(self):
        """Context manager enforcing ``no_host_transfers`` on the card (no-op
        when the contract does not declare it, or without CUDA)."""
        if not self.no_host_transfers or not torch.cuda.is_available():
            return contextlib.nullcontext()
        return _sync_mode("error")


@contextlib.contextmanager
def _sync_mode(mode) -> Iterator[None]:
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def explicit_sync(counted: bool = True) -> Iterator[None]:
    """Around a deliberate device read: it lifts a :meth:`Contract.guard`
    for its body, and an open ``OpRecorder`` takes the body's reads as
    explicit and, where ``counted`` (a fetch the engine counts in
    ``stats["host_syncs"]``) and the body reads the device, counts the
    block."""
    with recorder.explicit(counted):
        if torch.cuda.is_available() and torch.cuda.get_sync_debug_mode() != 0:
            with _sync_mode(0):
                yield
        else:
            yield


# ---------------------------------------------------------------------------
# Declared-contract verification
# ---------------------------------------------------------------------------

#: The worker count of the collective probes (gloo, on the CPU).
PROBE_WORKERS = 4
_K, _KB, _N, _M = 3, 4, 512, 48


def _collective_probes(group, device) -> Dict[str, Dict]:
    """One gloo worker's op logs (module level: ``run_workers`` starts it by
    name): K rank-1 and K block power iterations over the group, on this
    worker's rows of a seeded (n, m) matrix."""
    from ..comm import DenseReducer
    from ..core import power_method

    gen = torch.Generator().manual_seed(7)
    a = torch.randn((_N, _M), generator=gen)
    rows = _N // group.size
    a = a[group.rank * rows:(group.rank + 1) * rows].to(device)
    reducer = DenseReducer(group)
    out = {}
    with recorder.OpRecorder() as rec:
        power_method.power_iterations(lambda v: a @ v, lambda u: a.T @ u,
                                      torch.ones(_M, device=device) / _M ** 0.5, _K,
                                      reducer=reducer)
    out["rank1"] = rec.analyze()
    v0 = torch.linalg.qr(torch.randn((_M, _KB), generator=gen))[0].to(device)
    with recorder.OpRecorder() as rec:
        power_method.block_power_iterations(lambda v: a @ v, lambda u: a.T @ u, v0, _K,
                                            reducer=reducer)
    out["block"] = rec.analyze()
    return out


def verify_declared(verbose: bool = True, device=None) -> int:
    """Build and check every declared contract at probe scale; returns a
    process exit code. The power method's 2K-rounds contracts run on
    ``PROBE_WORKERS`` gloo worker processes on the CPU (the reference uses 8
    fake devices); the engine, serving and telemetry probes run in this
    process on ``device``: the card when it is ``None`` (on the card the
    engine's programs and the scorer are captured, and their captures are
    what is read), the CPU only when asked for."""
    from .. import resolve_device
    from ..core import engine, frank_wolfe, low_rank, power_method, tasks
    from ..launch.dfw import run_workers
    from ..obs import Telemetry, noop_contract
    from ..serve import ServeConfig, ServingEngine

    dev = resolve_device(device)
    failures = 0

    def report(contract: Contract, err: Optional[BaseException], note: str):
        nonlocal failures
        if err is None:
            if verbose:
                print(f"contract {contract.name}: OK ({note})")
        else:
            failures += 1
            print(f"contract {contract.name}: FAIL\n  {err}")

    # 1. Power method: K iterations cost exactly 2K all-reduces (the carried
    # sigma), rank-1 and block (the Gram orthogonalization runs on the
    # already-summed block), on every worker.
    probes = [(power_method.collective_rounds_contract(_K), "rank1"),
              (power_method.block_collective_rounds_contract(_K, _KB), "block")]
    try:
        logs = run_workers(PROBE_WORKERS, _collective_probes, device="cpu")
    except Exception as e:  # noqa: BLE001 - every failure is reported
        for c, _ in probes:
            report(c, e, "")
    else:
        for c, key in probes:
            try:
                for worker in logs:
                    c.check_ops(worker[key])
                report(c, None, f"{PROBE_WORKERS} gloo workers, K={_K}: all-reduce == {2 * _K}")
            except Exception as e:  # noqa: BLE001
                report(c, e, "")

    # 2. Engine: a const:K run is one dispatch a segment plus the final loss,
    # with no implicit device read and at most 2 fetches; rank-1 and block.
    rng = torch.Generator().manual_seed(0)
    w = torch.randn((24, 18), generator=rng)
    x = torch.randn((400, 24), generator=rng)
    for solver in ("rank1", "block:4:adapt"):
        c = engine.dispatch_contract(
            name=None if solver == "rank1" else f"engine.dispatch[solver={solver}]")
        try:
            task = tasks.MultiTaskLeastSquares(d=24, m=18)
            state = task.init_state(x.to(dev), (x @ w).to(dev))
            with recorder.OpRecorder() as rec, c.guard():
                res = frank_wolfe.fit(task, state, mu=1.0, num_epochs=30, key=1,
                                      step_size="linesearch", solver=solver, device=dev)
            c.check_stats(res.stats)
            seen = c.check_ops(rec)
            report(c, None, f"30-epoch const:2 {solver} on {dev.type}: stats {res.stats}, "
                   f"{seen['explicit_syncs']} explicit fetches that read, 0 implicit")
        except Exception as e:  # noqa: BLE001
            report(c, e, "")

    # 3. Serving: no scorer makes the d x m (or m x d) matrix, and a load
    # and a dispatch read nothing from the card unasked.
    d_s, m_s = 48, 36
    eng = ServingEngine(d_s, m_s, ServeConfig(max_batch=8, rank_block=8, verify_kernels=False),
                        device=dev)
    c = eng.contract(max_compilations=1)
    try:
        g = torch.Generator().manual_seed(7)
        it = low_rank.FactoredIterate(
            u=torch.randn((5, d_s), generator=g), s=torch.randn(5, generator=g),
            v=torch.randn((5, m_s), generator=g), alpha=torch.tensor(0.9),
            count=torch.tensor(5, dtype=torch.int32))
        eng.load(low_rank.pack_live(it))
        with c.guard():
            pending = eng.score_async(torch.ones((3, d_s)).numpy())
        pending.block()
        eng.check_contract(c)
        report(c, None, f"rank-5 load + dispatch on {dev.type}, stats {eng.stats}")
    except Exception as e:  # noqa: BLE001
        report(c, e, "")

    # 4. The disabled telemetry handle is free and silent.
    c = noop_contract()
    try:
        c.check_telemetry(Telemetry.noop())
        report(c, None, "no-op handle: spans free, event stream empty")
    except Exception as e:  # noqa: BLE001
        report(c, e, "")

    if failures:
        print(f"{failures} contract(s) FAILED")
    elif verbose:
        print("all declared contracts OK")
    return 1 if failures else 0
