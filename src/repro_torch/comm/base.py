"""The collective chokepoint of the port (one process).

Every vector and scalar aggregate of an epoch goes through :func:`psum` /
:func:`pmax` or a reducer's ``exchange`` here, as in the JAX package, so the
places where workers would exchange data stay in one module. This slice runs
one process, so each aggregate is the identity (the "sum" over one worker);
``torch.distributed`` comes with the multi-worker slice.

A reducer encodes the power method's two vector exchanges per iteration:
:class:`DenseReducer` is the exact f32 sum (``comm="dense"``) and
``comm.int8.Int8Reducer`` the stochastic-rounding int8 sum (``comm="int8"``;
a one-worker run still applies the encoding, as the JAX package's serial
run does). ``exchange(x, state, slot=..., noise=...)`` takes ``noise``, a
function ``noise(dim, device)`` that returns this exchange's uniform [0, 1)
draws (see ``repro_torch.NoiseStream``); encodings without randomness ignore
it. Every reducer counts its exchanges, so a run can show that an epoch with
K power iterations made exactly 2K of them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..specs import NotYetPorted, parse_comm

Noise = Optional[Callable[[int, torch.device], torch.Tensor]]


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the workers (one process: ``x`` itself)."""
    return x


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Max of ``x`` over the workers (one process: ``x`` itself)."""
    return x


class DenseReducer:
    """Exact f32 sum, the paper's master aggregate; its state is ``()``."""

    spec = "dense"

    def __init__(self):
        self.exchanges = 0

    def init_state(self, d: int, m: int):
        return ()

    def exchange(self, x: torch.Tensor, state, *, slot: str, noise: Noise = None):
        """(sum over workers of ``x``, new state); ``slot`` is "u" or "v"."""
        self.exchanges += 1
        return psum(x), state

    def wire_bytes(self, dim: int, num_workers: int) -> int:
        return 2 * 4 * dim  # ring all-reduce: 2x the f32 vector


def make_reducer(spec: str, *, num_workers: int = 1):
    """``"dense"`` -> :class:`DenseReducer`, ``"int8"`` -> ``Int8Reducer``
    sized for ``num_workers``; other valid specs are not ported."""
    c = parse_comm(spec)
    if c.kind == "dense":
        return DenseReducer()
    if c.kind == "int8":
        from .int8 import Int8Reducer

        return Int8Reducer(num_workers=num_workers)
    raise NotYetPorted(f"comm {c.spec!r} is not yet ported to PyTorch")
