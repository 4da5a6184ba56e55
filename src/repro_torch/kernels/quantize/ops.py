"""Public wrappers of the int8 reducer's stochastic-rounding pair.

``quantize(x, noise, scale, budget=b)`` maps an f32 vector onto the integer
grid [-b, b] under the shared scale (a 0-d float32 device tensor, never read
by the host) and ``dequantize(q, scale, budget=b)`` maps summed integers
back to f32. CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the hand-written kernel (``csrc/quantize.cu``) or raise. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from .. import _checks
from .._count import launched
from . import kernel, ref


def _scale(scale: torch.Tensor, device: torch.device) -> torch.Tensor:
    if not isinstance(scale, torch.Tensor) or scale.numel() != 1 or scale.dtype != torch.float32:
        raise TypeError("scale must be a one-element float32 tensor")
    _checks.same_device(device, scale=scale)
    return scale.reshape(())


def _budget(budget: int) -> int:
    if not 1 <= int(budget) <= 127:
        raise ValueError(f"budget must lie in [1, 127], got {budget}")
    return int(budget)


def quantize(x: torch.Tensor, noise: torch.Tensor, scale: torch.Tensor, *,
             budget: int) -> torch.Tensor:
    """Stochastic-round x (n,) f32 -> (n,) int8 with uniform [0, 1) ``noise``."""
    if not isinstance(x, torch.Tensor) or x.dim() != 1:
        raise ValueError("x must be a 1-D tensor")
    n = x.shape[0]
    x = _checks.vector_f32(x, "x", n)
    noise = _checks.vector_f32(noise, "noise", n)
    _checks.same_device(x.device, noise=noise)
    scale, budget = _scale(scale, x.device), _budget(budget)
    if not _checks.kernel_device(x.device, "quantize"):
        return ref.quantize(x, noise, scale, budget)
    out = torch.empty(n, dtype=torch.int8, device=x.device)
    if n:
        kernel.quantize(x, noise, scale, out, budget)
        launched(quantize, out)
    return out


def dequantize(q: torch.Tensor, scale: torch.Tensor, *, budget: int) -> torch.Tensor:
    """Summed integers q (n,) int8 -> (n,) f32 under the shared ``scale``."""
    if not isinstance(q, torch.Tensor) or q.dim() != 1 or q.dtype != torch.int8:
        raise TypeError("q must be a 1-D int8 tensor")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    scale, budget = _scale(scale, q.device), _budget(budget)
    if not _checks.kernel_device(q.device, "dequantize"):
        return ref.dequantize(q, scale, budget)
    out = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    if q.numel():
        kernel.dequantize(q, scale, out, budget)
        launched(dequantize, out)
    return out


quantize.launches = 0
dequantize.launches = 0
