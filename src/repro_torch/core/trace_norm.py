"""Trace-norm ball geometry: LMO, duality gap, step size."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rank1(NamedTuple):
    """A rank-1 matrix ``scale * u v^T`` kept factored (never materialized)."""

    u: torch.Tensor  # (d,)
    v: torch.Tensor  # (m,)
    scale: torch.Tensor  # ()


def lmo_trace_ball(u: torch.Tensor, v: torch.Tensor, mu: float) -> Rank1:
    """S* = argmin_{||S||_* <= mu} <S, A> = -mu u1 v1^T for top pair (u1,v1)."""
    return Rank1(u=u, v=v, scale=torch.full((), -mu, dtype=u.dtype, device=u.device))


def duality_gap(inner_w_grad: torch.Tensor, sigma1: torch.Tensor, mu: float) -> torch.Tensor:
    """FW duality gap g(W) = <W, grad> + mu * sigma1(grad) >= F(W) - F(W*)."""
    return inner_w_grad + mu * sigma1


def default_step_size(t: torch.Tensor) -> torch.Tensor:
    """The classic FW schedule gamma_t = 2/(t+2), in t's dtype (float32)."""
    return 2.0 / (t + 2.0)
