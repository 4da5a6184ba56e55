"""Top-k sparsifying reducer with per-worker error feedback (``comm="topk:r"``).

Each worker sends only the k largest-magnitude components of its corrected
contribution ``c = x + e`` (e: the residual of everything it never sent);
the sum is reassembled from an index and a value all-gather, and the unsent
mass ``c - topk(c)`` becomes the next residual, as in the JAX package's
``comm/topk.py``. The compression error is fed back, not dropped, so the
transmitted signal tracks the true one over the rounds.

Two choices keep the port's bits fixed and the reference's:

- **Ties.** ``jax.lax.top_k`` takes the lower index first among equal
  magnitudes; ``torch.topk`` promises no order. The port takes the first k
  of a stable descending sort of |c|, which is the reference's rule.
- **Reassembly.** The gathered (N, k) values are added rank by rank into a
  zero vector: within one rank's top-k the indices are distinct, so each
  ``index_add_`` touches every address once, and the sum's order is the
  ranks' (the reference's scatter-add of the rank-major flattened set on the
  CPU). One scatter-add of the flattened N·k set would add duplicates with
  CUDA atomics, in an order that changes from run to run.

The residuals are per-worker state, ``{"u": (d,), "v": (m,)}``, threaded
through the epochs by the engine (``EpochCarry.comm_state``). A worker whose
straggler weight is 0 sends zeros and keeps its residual frozen. Wire cost
of one exchange: two all-gathers of (N, k), int32 indices and f32 values,
8·N·k bytes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .base import Noise, WorkerGroup


class TopKReducer:
    """Keep the ``k`` largest-|.| components per vector, error feedback for
    the rest, summed over ``group`` (None: one process)."""

    stochastic = False

    def __init__(self, k: int = 32, group: Optional[WorkerGroup] = None):
        if k < 1:
            raise ValueError(f"topk keep-count must be >= 1, got {k}")
        self.k = int(k)
        self.group = group
        self.exchanges = 0

    @property
    def spec(self) -> str:
        return f"topk:{self.k}"

    def init_state(self, d: int, m: int, device=None) -> Dict[str, torch.Tensor]:
        return {"u": torch.zeros(d, dtype=torch.float32, device=device),
                "v": torch.zeros(m, dtype=torch.float32, device=device)}

    def exchange(self, x: torch.Tensor, state, *, slot: str, noise: Noise = None, weight=None):
        """(sum over workers of their top-k of ``x + e``, new state)."""
        self.exchanges += 1
        e = state[slot]
        c = x + e
        k = min(self.k, c.shape[0])
        idx = top_k_indices(c, k)
        vals = c[idx]
        if weight is not None:  # on the device: a worker left out sends zeros
            alive = torch.as_tensor(weight, device=c.device) > 0
            vals = torch.where(alive, vals, torch.zeros_like(vals))
        sparse_local = torch.zeros_like(c).index_put_((idx,), vals)
        new_state = dict(state)
        # ... and keeps its residual
        new_state[slot] = (c - sparse_local if weight is None
                           else torch.where(alive, c - sparse_local, e))
        if self.group is None:
            return sparse_local, new_state
        gi = self.group.all_gather(idx.to(torch.int32)[None])
        gv = self.group.all_gather(vals[None])
        return reassemble(gi, gv, c.shape[0]), new_state

    def wire_bytes(self, dim: int, num_workers: int) -> int:
        return num_workers * min(self.k, dim) * (4 + 4)  # gathered int32 idx + f32 vals


def reassemble(gi: torch.Tensor, gv: torch.Tensor, dim: int) -> torch.Tensor:
    """The (dim,) sum of the workers' sparse vectors from the gathered
    (N, k) indices and values, added rank by rank into zeros: each rank's
    indices are distinct, so every ``index_add_`` adds to an address once
    and the sum's order is the ranks' on any device."""
    total = torch.zeros(dim, dtype=gv.dtype, device=gv.device)
    for r in range(gi.shape[0]):
        total.index_add_(0, gi[r].long(), gv[r])
    return total


def top_k_indices(c: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest |c|, the lower index first among equal
    magnitudes (``jax.lax.top_k``'s order)."""
    return torch.sort(torch.abs(c), descending=True, stable=True).indices[:k]
