"""Public wrapper of factor-form scoring.

``factor_matvec(x, a, s, b, alpha=...)`` is ``alpha * ((X @ A^T) * s) @ B``
for a request batch X (bt, n_in) and a factor triple A (r, n_in), s (r,),
B (r, n_out), returning (bt, n_out) float32. X, A and B may each be float32
or bfloat16, as the reference's kernel takes any input dtype; s is float32,
and every sum is taken in f32 (the rank-r intermediate included). The CUDA
kernel reads bf16 operands from memory as they are: nothing is upcast into
a copy. Scoring the
factored iterate ``W = alpha * U^T diag(s) V`` is ``factor_matvec(x, u, s,
v)`` for ``X @ W`` and ``factor_matvec(x, v, s, u)`` for ``X @ W^T``.

``alpha`` (a Python float or a 0-d float32 tensor on the tensors' device) is
folded into ``s`` here, so the kernel and the plain version stay scale-free.
Rank 0 (a fresh iterate) scores exact zeros without a launch. CPU tensors
take the plain version (``ref.py``); CUDA tensors launch the hand-written
kernel (``csrc/factor_matvec.cu``), which masks every ragged edge itself, or
raise. Rows of the factors past the live rank carry s == 0 and are exact
no-ops, so a rank bucket padded with them gives the live rank's bits.
``factor_matvec.launches`` counts the kernel launches.
"""
from __future__ import annotations

from typing import Union

import torch

from .. import _checks
from .._count import launched
from . import kernel, ref


OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _operand(t: torch.Tensor, name: str, shape=None) -> None:
    """``t`` a contiguous 2-D float32 or bfloat16 tensor (of ``shape``)."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor")
    dtype = t.dtype if t.dtype in OPERAND_DTYPES else torch.float32
    if t.dtype != dtype:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    _checks.dense_f32(t, name, t.shape if shape is None else shape, dtype)


def factor_matvec(
    x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
    *, alpha: Union[float, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """alpha * ((X @ A^T) * s) @ B -> (bt, n_out) float32."""
    _operand(x, "x")
    _operand(b, "b")
    bt, n_in = x.shape
    r, n_out = b.shape
    _operand(a, "a", (r, n_in))
    s = _checks.vector_f32(s, "s", r)
    _checks.same_device(x.device, a=a, s=s, b=b)
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1 or alpha.dtype != torch.float32:
            raise TypeError("alpha must be a one-element float32 tensor or a float")
        _checks.same_device(x.device, alpha=alpha)
        s = s * alpha.reshape(())
    elif float(alpha) != 1.0:
        s = s * float(alpha)
    if r == 0:
        return torch.zeros((bt, n_out), dtype=torch.float32, device=x.device)
    if not _checks.kernel_device(x.device, "factor_matvec"):
        return ref.factor_matvec(x, a, s, b)
    out = torch.empty((bt, n_out), dtype=torch.float32, device=x.device)
    if bt == 0 or n_out == 0:
        return out
    kernel.factor_matvec(x, a, s, b, out)
    launched(factor_matvec, out)
    return out


factor_matvec.launches = 0
