"""Request micro-batching for the serving engine, as in ``repro.serve.batcher``.

A single request costs a whole padded dispatch. ``MicroBatcher`` gathers
single requests into one ``score_async`` call and gives each caller a
``Ticket``. A batch goes out when it reaches ``flush_at`` rows or when the
caller calls ``flush()``; tickets are bound to the model version at
dispatch, so requests flushed before a swap score against the old model and
requests flushed after it against the new one.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .engine import PendingScores, ServingEngine


class Ticket:
    """One submitted request's future score row. ``result()`` blocks, and
    first flushes the batcher when this request is still queued, so a lone
    ticket never waits for neighbours that may not come."""

    __slots__ = ("_batcher", "_pending", "_row")

    def __init__(self, batcher: "MicroBatcher"):
        self._batcher = batcher
        self._pending: Optional[PendingScores] = None
        self._row = -1

    def _attach(self, pending: PendingScores, row: int) -> None:
        self._pending = pending
        self._row = row

    @property
    def dispatched(self) -> bool:
        return self._pending is not None

    @property
    def version(self) -> int:
        if self._pending is None:
            raise RuntimeError("ticket not dispatched yet; flush() first")
        return self._pending.version

    @property
    def step(self):
        if self._pending is None:
            raise RuntimeError("ticket not dispatched yet; flush() first")
        return self._pending.step

    def result(self) -> np.ndarray:
        if self._pending is None:
            self._batcher.flush()
        return self._pending.block()[self._row]


class MicroBatcher:
    """Gather single requests into padded engine dispatches. ``flush_at``
    (default: the engine's ``max_batch``) trades fill for latency."""

    def __init__(self, engine: ServingEngine, *, flush_at: Optional[int] = None):
        self.engine = engine
        self.flush_at = engine.cfg.max_batch if flush_at is None else int(flush_at)
        if not 1 <= self.flush_at <= engine.cfg.max_batch:
            raise ValueError(
                f"flush_at={self.flush_at}: must be in [1, max_batch={engine.cfg.max_batch}]"
            )
        self._rows: List[np.ndarray] = []
        self._tickets: List[Ticket] = []

    @property
    def pending_count(self) -> int:
        return len(self._rows)

    def submit(self, x) -> Ticket:
        """Queue one (n_in,) request; flushes at ``flush_at`` rows."""
        row = np.asarray(x, np.float32)
        if row.ndim != 1 or row.shape[0] != self.engine.n_in:
            raise ValueError(
                f"submit takes one ({self.engine.n_in},) request; got shape {row.shape} "
                "(use engine.score for whole batches)"
            )
        ticket = Ticket(self)
        self._rows.append(row)
        self._tickets.append(ticket)
        if len(self._rows) >= self.flush_at:
            self.flush()
        return ticket

    def flush(self) -> Optional[PendingScores]:
        """Dispatch everything queued as one batch (nothing when empty)."""
        if not self._rows:
            return None
        pending = self.engine.score_async(np.stack(self._rows))
        for row, ticket in enumerate(self._tickets):
            ticket._attach(pending, row)
        self._rows, self._tickets = [], []
        return pending
