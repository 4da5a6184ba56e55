"""Public wrappers of the power-method matvecs.

``matvec(a, v)`` is A @ v and ``rmatvec(a, u)`` is A^T @ u, both (n, m)
float32 row-major matrices with f32 accumulation, returning 1-D vectors like
the JAX package's ops. ``matmat(a, v)`` (A @ V, V (m, k)) and ``rmatmat(a,
u)`` (A^T @ U, U (n, k)) are their block forms for the block:k solver, where
the reference vmaps the vector ops over the k columns: each reads A once per
32 columns. ``rmatmat``'s partials are (slabs, m, min(k, 32)): its work
items are (slab of rows, 256-column tile) pairs on one persistent block an
SM, and the slab height makes the item count a multiple of the block count
(``_rmatmat_rows_per_slab``). ``power_iter_step(x, r, v)`` is one
two-sided power iteration on the implicit A = X^T R: four launches, two of
``matvec`` and two of ``rmatvec``, each X and R read twice. CPU tensors take
the plain version (``ref.py``); CUDA tensors launch the hand-written kernel
(``csrc/power_matvec.cu``) or raise.
Each wrapper counts its kernel launches in ``<wrapper>.launches``
(``power_iter_step``'s are its matvecs' and rmatvecs').
"""
from __future__ import annotations

import math

import torch

from .. import _checks
from .._count import launched
from . import kernel, ref

# rmatvec row slab per stage-1 block; fixed per shape, so the summation
# order (and the result's bits) is the same on every call.
RMATVEC_ROWS_PER_SLAB = 2048
_MAX_SLABS = 65535  # gridDim.y limit

MATMAT_GROUP = 32  # columns per pass over A
# rmatmat's work items (csrc/power_matvec.cu): A columns a tile holds, rows a
# ring stage holds (a slab is whole stages), and the most rows a slab holds.
RMATMAT_TILE = 256
RMATMAT_STAGE = 32
RMATMAT_MAX_ROWS = 65536


def _rows_per_slab(n: int) -> int:
    return max(RMATVEC_ROWS_PER_SLAB, -(-n // _MAX_SLABS))


def _rmatmat_rows_per_slab(n: int, m: int, blocks: int) -> int:
    """The slab height for rmatmat on ``blocks`` persistent blocks: the
    fewest slabs of at most RMATMAT_MAX_ROWS rows whose count times the
    column tiles is a multiple of ``blocks``, so that every block takes the
    same number of items; rounded up to whole stages (which may drop a slab
    at small n, where the items do not fill one round anyway). Fixed per
    shape and card, so the slab sums' order is too."""
    tiles = -(-m // RMATMAT_TILE)
    unit = blocks // math.gcd(tiles, blocks)
    slabs = unit * -(-n // (unit * RMATMAT_MAX_ROWS))
    rows = -(-n // slabs)
    return -(-rows // RMATMAT_STAGE) * RMATMAT_STAGE


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
    launched(matvec, out)
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
    launched(rmatvec, out)
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
    launched(matmat, out)
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
    rows = _rmatmat_rows_per_slab(
        n, m, torch.cuda.get_device_properties(a.device).multi_processor_count)
    partial = torch.empty((-(-n // rows), m, min(k, MATMAT_GROUP)), dtype=torch.float32,
                          device=a.device)
    kernel.rmatmat(a, u, partial, out, rows)
    launched(rmatmat, out)
    return out


def power_iter_step(x: torch.Tensor, r: torch.Tensor,
                    v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One two-sided power iteration on A = X^T R for X (n, d), R (n, m) and
    v (m,) or (m, 1), the reference's ``ops.power_iter_step``: t = R v,
    u = X^T t normalised, s = X u, v' = R^T s normalised (each norm plus
    1e-30). Returns unit (u (d,), v' (m,)) float32. Four kernel launches on
    CUDA tensors; the plain versions on the CPU."""
    t = matvec(r, v)
    u = rmatvec(x, t)
    u = u / (torch.linalg.vector_norm(u) + 1e-30)
    s = matvec(x, u)
    v2 = rmatvec(r, s)
    return u, v2 / (torch.linalg.vector_norm(v2) + 1e-30)


matvec.launches = 0
rmatvec.launches = 0
matmat.launches = 0
rmatmat.launches = 0
