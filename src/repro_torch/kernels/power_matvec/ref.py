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


def power_iter_step(x: torch.Tensor, r: torch.Tensor,
                    v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One two-sided power iteration on A = X^T R (X (n, d), R (n, m), v
    (m,) or (m, 1)): unit (u (d,), v' (m,)), each norm plus 1e-30, as the
    reference's ``ref.power_iter_step``."""
    u = rmatvec(x, matvec(r, v))
    u = u / (torch.linalg.vector_norm(u) + 1e-30)
    v2 = rmatvec(r, matvec(x, u))
    return u, v2 / (torch.linalg.vector_norm(v2) + 1e-30)
