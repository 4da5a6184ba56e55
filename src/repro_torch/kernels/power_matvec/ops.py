"""Public wrappers of the power-method matvecs.

``matvec(a, v)`` is A @ v and ``rmatvec(a, u)`` is A^T @ u, both (n, m)
float32 row-major matrices with f32 accumulation, returning 1-D vectors like
the JAX package's ops. CPU tensors take the plain version (``ref.py``); CUDA
tensors launch the hand-written kernel (``csrc/power_matvec.cu``) or raise.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from .. import _checks
from . import kernel, ref

# rmatvec row slab per stage-1 block; fixed per shape, so the summation
# order (and the result's bits) is the same on every call.
RMATVEC_ROWS_PER_SLAB = 2048
_MAX_SLABS = 65535  # gridDim.y limit


def _rows_per_slab(n: int) -> int:
    return max(RMATVEC_ROWS_PER_SLAB, -(-n // _MAX_SLABS))


def _matrix(a: torch.Tensor, name: str = "a") -> None:
    if not isinstance(a, torch.Tensor) or a.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor")
    _checks.dense_f32(a, name, a.shape)


def matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v -> (n,) float32."""
    _matrix(a)
    n, m = a.shape
    v = _checks.vector_f32(v, "v", m)
    _checks.same_device(a.device, v=v)
    if not _checks.kernel_device(a.device, "power_matvec.matvec"):
        return ref.matvec(a, v)
    out = torch.empty(n, dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out.zero_()
    kernel.matvec(a, v, out)
    matvec.launches += 1
    return out


def rmatvec(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A^T @ u -> (m,) float32, bit-identical across repeated calls on CUDA."""
    _matrix(a)
    n, m = a.shape
    u = _checks.vector_f32(u, "u", n)
    _checks.same_device(a.device, u=u)
    if not _checks.kernel_device(a.device, "power_matvec.rmatvec"):
        return ref.rmatvec(a, u)
    out = torch.empty(m, dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out.zero_()
    rows = _rows_per_slab(n)
    partial = torch.empty((-(-n // rows), m), dtype=torch.float32, device=a.device)
    kernel.rmatvec(a, u, partial, out, rows)
    rmatvec.launches += 1
    return out


matvec.launches = 0
rmatvec.launches = 0
