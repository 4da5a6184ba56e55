"""Public wrappers of the fused Frank-Wolfe rank-1 update.

``rank1_update(z, x, y, a, b)`` is a*Z + b*x y^T and
``rank1_update_axpy(z, y0, x, y, a, b, c)`` is a*Z + b*x y^T + c*Y0, for
(n, m) float32 row-major Z/Y0 and vectors x (n,), y (m,). The scalars may be
Python floats or 0-d float32 tensors on Z's device; they are stacked on the
device, never read by the host. ``out`` may be ``z`` itself to update in
place. ``rankk_update(z, p, q, a, b)`` and ``rankk_update_axpy(z, y0, p, q,
a, b, c)`` are the rank-k forms of the block:k solver, with P Q^T (P (n, k),
Q (m, k)) in place of x y^T. CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the hand-written kernel
(``csrc/rank1_update.cu``) or raise. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .. import _checks
from . import kernel, ref

Scalar = Union[float, torch.Tensor]


def _scalars(device: torch.device, *vals: Scalar) -> torch.Tensor:
    out = []
    for i, v in enumerate(vals):
        if isinstance(v, torch.Tensor):
            if v.numel() != 1 or v.dtype != torch.float32:
                raise TypeError(f"scalar {i} must be a one-element float32 tensor")
            _checks.same_device(device, **{f"scalar {i}": v})
            out.append(v.reshape(()))
        else:
            out.append(torch.full((), float(v), dtype=torch.float32, device=device))
    return torch.stack(out)


def _prepare(z, x, y, out, y0=None):
    if not isinstance(z, torch.Tensor) or z.dim() != 2:
        raise ValueError("z must be a 2-D tensor")
    _checks.dense_f32(z, "z", z.shape)
    n, m = z.shape
    x = _checks.vector_f32(x, "x", n)
    y = _checks.vector_f32(y, "y", m)
    named = dict(x=x, y=y)
    if y0 is not None:
        _checks.dense_f32(y0, "y0", (n, m))
        named["y0"] = y0
    if out is not None:
        _checks.dense_f32(out, "out", (n, m))
        named["out"] = out
    _checks.same_device(z.device, **named)
    return x, y


def rank1_update(
    z: torch.Tensor, x: torch.Tensor, y: torch.Tensor, a: Scalar, b: Scalar,
    *, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z' = a*Z + b*x y^T, one pass over Z; written into ``out`` when given."""
    x, y = _prepare(z, x, y, out)
    scal = _scalars(z.device, a, b)
    if not _checks.kernel_device(z.device, "rank1_update"):
        res = ref.rank1_update(z, x, y, scal)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(z)
    if z.numel():
        kernel.update(out, z, None, x, y, scal)
        rank1_update.launches += 1
    return out


def rank1_update_axpy(
    z: torch.Tensor, y0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
    a: Scalar, b: Scalar, c: Scalar, *, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z' = a*Z + b*x y^T + c*Y0 (the MTLS residual update), one pass."""
    x, y = _prepare(z, x, y, out, y0)
    scal = _scalars(z.device, a, b, c)
    if not _checks.kernel_device(z.device, "rank1_update_axpy"):
        res = ref.rank1_update_axpy(z, y0, x, y, scal)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(z)
    if z.numel():
        kernel.update(out, z, y0, x, y, scal)
        rank1_update_axpy.launches += 1
    return out


def _prepare_k(z, p, q, out, y0=None):
    if not isinstance(z, torch.Tensor) or z.dim() != 2:
        raise ValueError("z must be a 2-D tensor")
    _checks.dense_f32(z, "z", z.shape)
    n, m = z.shape
    if not isinstance(p, torch.Tensor) or p.dim() != 2 or p.shape[1] < 1:
        raise ValueError("p must be a 2-D (n, k) tensor with k >= 1")
    k = p.shape[1]
    _checks.dense_f32(p, "p", (n, k))
    _checks.dense_f32(q, "q", (m, k))
    named = dict(p=p, q=q)
    if y0 is not None:
        _checks.dense_f32(y0, "y0", (n, m))
        named["y0"] = y0
    if out is not None:
        _checks.dense_f32(out, "out", (n, m))
        named["out"] = out
    _checks.same_device(z.device, **named)


def rankk_update(
    z: torch.Tensor, p: torch.Tensor, q: torch.Tensor, a: Scalar, b: Scalar,
    *, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z' = a*Z + b*P Q^T, one pass over Z; written into ``out`` when given."""
    _prepare_k(z, p, q, out)
    scal = _scalars(z.device, a, b)
    if not _checks.kernel_device(z.device, "rankk_update"):
        res = ref.rankk_update(z, p, q, scal)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(z)
    if z.numel():
        kernel.update_k(out, z, None, p, q, scal)
        rankk_update.launches += 1
    return out


def rankk_update_axpy(
    z: torch.Tensor, y0: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
    a: Scalar, b: Scalar, c: Scalar, *, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z' = a*Z + b*P Q^T + c*Y0 (the MTLS residual's block update), one pass."""
    _prepare_k(z, p, q, out, y0)
    scal = _scalars(z.device, a, b, c)
    if not _checks.kernel_device(z.device, "rankk_update_axpy"):
        res = ref.rankk_update_axpy(z, y0, p, q, scal)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(z)
    if z.numel():
        kernel.update_k(out, z, y0, p, q, scal)
        rankk_update_axpy.launches += 1
    return out


rank1_update.launches = 0
rank1_update_axpy.launches = 0
rankk_update.launches = 0
rankk_update_axpy.launches = 0
