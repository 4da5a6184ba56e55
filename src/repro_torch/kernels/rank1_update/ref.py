"""Plain PyTorch versions of the fused rank-1 update and its rank-k forms.

``scal`` holds the scalars on the tensors' device: [a, b] or [a, b, c].
"""
from __future__ import annotations

import torch


def rank1_update(z, x, y, scal) -> torch.Tensor:
    """a*Z + b*outer(x, y)."""
    return scal[0] * z + scal[1] * torch.outer(x.reshape(-1), y.reshape(-1))


def rank1_update_axpy(z, y0, x, y, scal) -> torch.Tensor:
    """a*Z + b*outer(x, y) + c*Y0."""
    return (
        scal[0] * z
        + scal[1] * torch.outer(x.reshape(-1), y.reshape(-1))
        + scal[2] * y0
    )


def rankk_update(z, p, q, scal) -> torch.Tensor:
    """a*Z + b*(P Q^T)."""
    return scal[0] * z + scal[1] * (p @ q.T)


def rankk_update_axpy(z, y0, p, q, scal) -> torch.Tensor:
    """a*Z + b*(P Q^T) + c*Y0."""
    return scal[0] * z + scal[1] * (p @ q.T) + scal[2] * y0
