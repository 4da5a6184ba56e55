"""Power method on the implicit gradient (paper Alg. 2, lines 5-10).

The paper's workers send ``grad_j @ v`` to a master that sums and broadcasts;
here every aggregate goes through the comm chokepoint (``comm.base``): an
all-reduce over the workers' process group, the identity for one process.
Only O(d+m) vectors cross the wire.
The ``reducer`` slot takes a reducer or a topology (``comm.topology``):
under a gossip graph every worker ends with its own estimate of u, v and
sigma. A reducer with a stochastic encoding (int8) draws each exchange's noise from
a ``repro_torch.NoiseStream`` at (epoch t, iteration i, slot).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..comm.base import DenseReducer

_EPS = 1e-30


class PowerResult(NamedTuple):
    """Top singular triple estimate after K two-sided power iterations."""

    u: torch.Tensor  # (d,) left singular vector estimate, unit norm
    v: torch.Tensor  # (m,) right singular vector estimate, unit norm
    sigma: torch.Tensor  # () top singular value estimate (= ||A^T u|| >= 0)


def sphere_vector(gen: torch.Generator, m: int, device, dtype=torch.float32) -> torch.Tensor:
    """Uniform random vector on the unit (m-1)-sphere, drawn from ``gen``."""
    v = torch.randn(m, generator=gen, device=device, dtype=dtype)
    return v / (torch.linalg.vector_norm(v) + _EPS)


def power_iterations(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    num_iters: int,
    *,
    reducer: Optional[DenseReducer] = None,
    comm_state=(),
    noise=None,
    t: int = 0,
    worker_weight: Optional[float] = None,
):
    """Run ``num_iters`` two-sided power iterations on the implicit operator.

    ``matvec(v)``/``rmatvec(u)`` compute this worker's ``A_j v`` / ``A_j^T
    u``; each is summed over workers by ``reducer.exchange`` and normalized.
    ``sigma = ||A^T u||`` is the norm of the *last* aggregated ``rmatvec``,
    carried out of the loop and never recomputed, so K iterations make
    exactly 2K exchanges. The two-sided iteration gives ``u^T A v = sigma >=
    0``, so the trace-norm LMO is ``-mu u v^T`` with no sign fix.

    ``noise`` (a ``NoiseStream``, or None for encodings without randomness)
    and the epoch ``t`` give exchange (i, slot) its noise ``noise(t, i,
    slot, dim, device)``.

    ``worker_weight`` is this worker's straggler weight for the epoch: its
    contributions are ``w * matvec(v)`` and ``w * rmatvec(u)`` (0 for a
    worker left out, N / alive for the others under reweighting), as in the
    reference. ``None`` means full participation and multiplies by nothing.
    The weight also goes to ``exchange``: a stateful reducer (top-k) must
    know a worker that was left out, whose contribution is zero but whose
    residual is not.

    Returns ``(PowerResult, comm_state)``.
    """
    if num_iters < 1:
        raise ValueError(
            f"num_iters={num_iters}: power_iterations needs >= 1 iteration "
            "(0 returns u=0, sigma=0 and silently corrupts the caller)"
        )
    if reducer is None:
        reducer = DenseReducer()

    def draw(i, slot):
        return None if noise is None else partial(noise, t, i, slot)

    def weighted(x):
        return x if worker_weight is None else worker_weight * x

    v = v0
    for i in range(num_iters):
        uu, comm_state = reducer.exchange(
            weighted(matvec(v)), comm_state, slot="u", noise=draw(i, "u"), weight=worker_weight)
        u = uu / (torch.linalg.vector_norm(uu) + _EPS)
        vv, comm_state = reducer.exchange(
            weighted(rmatvec(u)), comm_state, slot="v", noise=draw(i, "v"), weight=worker_weight)
        sigma = torch.linalg.vector_norm(vv)
        v = vv / (sigma + _EPS)
    return PowerResult(u=u, v=v, sigma=sigma), comm_state
