"""Public wrappers of the power-method matvecs.

``matvec(a, v)`` is A @ v and ``rmatvec(a, u)`` is A^T @ u, both (n, m)
float32 row-major matrices with f32 accumulation, returning 1-D vectors like
the JAX package's ops. ``matmat(a, v)`` (A @ V, V (m, k)) and ``rmatmat(a,
u)`` (A^T @ U, U (n, k)) are their block forms for the block:k solver, where
the reference vmaps the vector ops over the k columns: each reads A once per
32 columns. CPU tensors take the plain version (``ref.py``); CUDA
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


# rmatmat's slab: its partials are (slabs, m, min(k, 32)), 41 MB on X at k = 32.
RMATMAT_ROWS_PER_SLAB = 8192
MATMAT_GROUP = 32  # columns per pass over A


def _rows_per_slab(n: int, rows: int = RMATVEC_ROWS_PER_SLAB) -> int:
    return max(rows, -(-n // _MAX_SLABS))


def _block(t: torch.Tensor, name: str, rows: int) -> torch.Tensor:
    """``t`` as a contiguous float32 (rows, k) block, k >= 1."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2 or t.shape[1] < 1:
        raise ValueError(f"{name} must be a 2-D ({rows}, k) tensor with k >= 1")
    _checks.dense_f32(t, name, (rows, t.shape[1]))
    return t


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


def matmat(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ V -> (n, k) float32 for V (m, k); each output one fixed-order sum."""
    _matrix(a)
    n, m = a.shape
    v = _block(v, "v", m)
    _checks.same_device(a.device, v=v)
    if not _checks.kernel_device(a.device, "power_matvec.matmat"):
        return ref.matmat(a, v)
    out = torch.empty((n, v.shape[1]), dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out.zero_()
    kernel.matmat(a, v, out)
    matmat.launches += 1
    return out


def rmatmat(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A^T @ U -> (m, k) float32 for U (n, k), bit-identical across repeated
    calls on CUDA (two fixed-order stages)."""
    _matrix(a)
    n, m = a.shape
    u = _block(u, "u", n)
    _checks.same_device(a.device, u=u)
    if not _checks.kernel_device(a.device, "power_matvec.rmatmat"):
        return ref.rmatmat(a, u)
    k = u.shape[1]
    out = torch.empty((m, k), dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out.zero_()
    rows = _rows_per_slab(n, RMATMAT_ROWS_PER_SLAB)
    partial = torch.empty((-(-n // rows), m, min(k, MATMAT_GROUP)), dtype=torch.float32,
                          device=a.device)
    kernel.rmatmat(a, u, partial, out, rows)
    rmatmat.launches += 1
    return out


matvec.launches = 0
rmatvec.launches = 0
matmat.launches = 0
rmatmat.launches = 0
