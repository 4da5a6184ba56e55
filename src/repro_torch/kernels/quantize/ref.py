"""Plain PyTorch versions of the int8 reducer's quantize/dequantize pair.

The same arithmetic as the JAX package's ``kernels/quantize/ref.py``:
``inv = budget / (scale + 1e-30)`` is one f32 division (spelled as a tensor
division: ``int / tensor`` in PyTorch multiplies by a reciprocal, which
rounds differently), then ``x * inv`` and ``+ noise`` are rounded one at a
time before the floor.
"""
from __future__ import annotations

import torch

_EPS = 1e-30


def quantize(x: torch.Tensor, noise: torch.Tensor, scale: torch.Tensor,
             budget: int) -> torch.Tensor:
    """clip(floor(x * budget / scale + noise), -budget, budget) as int8.

    With ``noise ~ U[0, 1)`` this is exact stochastic rounding:
    ``E[q] = x * budget / scale``; for ``|x| <= scale`` the clip never binds.
    """
    inv = torch.full_like(scale, float(budget)) / (scale + _EPS)
    v = torch.floor(x * inv + noise)
    return torch.clamp(v, -budget, budget).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor, budget: int) -> torch.Tensor:
    """q * scale / budget as f32 (q is the summed integer vector)."""
    return q.to(torch.float32) * (scale / torch.full_like(scale, float(budget)))
