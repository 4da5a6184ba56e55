"""Plain PyTorch versions of the power-method matvecs and their block forms
(f32 accumulation)."""
from __future__ import annotations

import torch


def matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v -> (n,) for A (n, m) and v (m,) or (m, 1)."""
    return a @ v.reshape(a.shape[1])


def rmatvec(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A^T @ u -> (m,) for A (n, m) and u (n,) or (n, 1)."""
    return a.T @ u.reshape(a.shape[0])


def matmat(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ V -> (n, k) for A (n, m) and V (m, k)."""
    return a @ v


def rmatmat(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A^T @ U -> (m, k) for A (n, m) and U (n, k)."""
    return a.T @ u
