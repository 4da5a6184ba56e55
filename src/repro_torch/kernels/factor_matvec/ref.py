"""Plain PyTorch versions of factor-form scoring: X, A and B float32 or
bfloat16, every product and sum in f32 (a bf16 operand is widened to f32,
exactly, before its first product, as the reference accumulates any input
dtype in f32)."""
from __future__ import annotations

import torch


def factor_matvec(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """((X @ A^T) * s) @ B for X (bt, n_in), A (r, n_in), s (r,) or (r, 1),
    B (r, n_out) -> (bt, n_out), rank by rank: column k of the rank-r
    intermediate is (X @ a[k]) * s[k], and the sum over k runs in ascending
    order, as in the kernel. Every rank's work has the same shapes whatever
    r is, so rows past the live rank (s == 0, zero factors) add exact zeros:
    a padded rank bucket gives the live rank's bits. (One matrix product of
    all ranks at once would not: BLAS picks its summation order by shape.)"""
    x, a, b = x.float(), a.float(), b.float()
    s = s.reshape(a.shape[0])
    out = torch.zeros((x.shape[0], b.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(a.shape[0]):
        out += ((x @ a[k]) * s[k])[:, None] * b[k]
    return out


def dense_matvec(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """X @ (A^T diag(s) B), the materialised n_in x n_out product: the
    computation factor-form scoring avoids. Tests and the serving engine's
    start-up check only."""
    w = torch.einsum("k,ki,kj->ij", s.reshape(a.shape[0]), a.float(), b.float())
    return x.float() @ w
