"""Declared cost contracts, checked against a run's counters.

The port's copy of the counter half of the JAX package's
``repro.analysis.contracts``: a :class:`Contract` declares caps on a run's
``stats`` (``max_dispatches``, ``max_compilations``, ``max_host_syncs``) and
``no_host_transfers``, which :meth:`Contract.guard` enforces with PyTorch's
CUDA sync debug mode: inside the guard, an operation that waits for the card
(``.item()``, ``.cpu()``, ``float(t)``, ``nonzero``) raises, the counterpart
of ``jax.transfer_guard_device_to_host("disallow")``. The engine's own
fetches, which it counts in ``stats["host_syncs"]``, go through
:func:`explicit_sync`, as ``jax.device_get`` passes the JAX guard. The
compiled-module clauses (collective counts, forbidden shapes) and the
telemetry clauses come with the port's telemetry.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Mapping, Optional

import torch


class ContractViolation(AssertionError):
    """A runtime counter broke a declared invariant."""


@dataclasses.dataclass(frozen=True)
class Contract:
    """One layer's declared counter caps and transfer discipline (see the
    module doc)."""

    name: str
    max_dispatches: Optional[int] = None
    max_compilations: Optional[int] = None
    max_host_syncs: Optional[int] = None
    no_host_transfers: bool = False

    def _fail(self, clause: str, detail: str):
        raise ContractViolation(f"contract {self.name!r}: {clause}: {detail}")

    def check_stats(self, stats: Mapping[str, int]) -> None:
        """Assert the declared caps against an engine ``stats`` dict."""
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


def explicit_sync():
    """Context manager around a deliberate, counted device read: it lifts
    a :meth:`Contract.guard` for its body (nothing to lift without CUDA)."""
    if not torch.cuda.is_available() or torch.cuda.get_sync_debug_mode() == 0:
        return contextlib.nullcontext()
    return _sync_mode(0)
