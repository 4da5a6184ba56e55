"""The collective chokepoint of the port (one process).

Every vector and scalar aggregate of an epoch goes through :func:`psum` /
:func:`pmax` or a reducer's ``exchange`` here, as in the JAX package, so the
places where workers would exchange data stay in one module. This slice runs
one process, so each aggregate is the identity (the "sum" over one worker);
``torch.distributed`` comes with the multi-worker slice.

:class:`DenseReducer` is the exact aggregate the power method's vector
exchanges use (``comm="dense"``); its per-worker state is the empty tuple.
It counts its exchanges, so a run can show that an epoch with K power
iterations made exactly 2K of them.
"""
from __future__ import annotations

import torch

from ..specs import NotYetPorted, parse_comm


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the workers (one process: ``x`` itself)."""
    return x


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Max of ``x`` over the workers (one process: ``x`` itself)."""
    return x


class DenseReducer:
    """Exact f32 sum, the paper's master aggregate."""

    spec = "dense"

    def __init__(self):
        self.exchanges = 0

    def init_state(self, d: int, m: int):
        return ()

    def exchange(self, x: torch.Tensor, state, *, slot: str):
        """(sum over workers of ``x``, new state); ``slot`` is "u" or "v"."""
        self.exchanges += 1
        return psum(x), state


def make_reducer(spec: str) -> DenseReducer:
    """``"dense"`` -> :class:`DenseReducer`; other valid specs are not ported."""
    c = parse_comm(spec)
    if c.kind != "dense":
        raise NotYetPorted(f"comm {c.spec!r} is not yet ported to PyTorch")
    return DenseReducer()
