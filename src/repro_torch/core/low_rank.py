"""Factored low-rank iterate store.

W^t = alpha * sum_{k<count} s[k] U[k] V[k]^T, kept as factors: O(t(d+m))
memory instead of O(dm). Buffers are preallocated at ``max_rank``. The FW
recurrence W <- (1-gamma) W + gamma S is folded into the running scale
``alpha``, so an epoch touches O(d+m) memory. ``alpha`` and ``count`` live
on the device, and ``fw_update`` writes row ``count`` (``fw_update_block`` the
k rows from ``count``) without reading it on the host, in place: the store
a run carries is the one the engine's CUDA graphs write.

``right_multiply`` scores row-major data against the iterate (X W, the
head's logits) through the ``factor_matvec`` kernel on the card.
The reference's ``packed_like`` (a treedef skeleton for its restores) has
no counterpart: the port's ``checkpoint.restore_run`` reads each leaf by
its path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.factor_matvec import ops as fm_ops


class FactoredIterate(NamedTuple):
    """W = alpha * sum_{k<count} s[k] * U[k] V[k]^T."""

    u: torch.Tensor  # (max_rank, d)
    s: torch.Tensor  # (max_rank,)
    v: torch.Tensor  # (max_rank, m)
    alpha: torch.Tensor  # () running global scale
    count: torch.Tensor  # () int32, number of live factors


def init(max_rank: int, d: int, m: int, *, device, dtype=torch.float32) -> FactoredIterate:
    return FactoredIterate(
        u=torch.zeros((max_rank, d), dtype=dtype, device=device),
        s=torch.zeros((max_rank,), dtype=dtype, device=device),
        v=torch.zeros((max_rank, m), dtype=dtype, device=device),
        alpha=torch.ones((), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def fw_update(
    it: FactoredIterate, u: torch.Tensor, v: torch.Tensor, gamma: torch.Tensor, mu: float
) -> FactoredIterate:
    """W <- (1-gamma) W + gamma (-mu u v^T), appending one factor.

    The (1-gamma) rescale is folded into ``alpha`` and the new factor is
    stored pre-divided by the new alpha. gamma = 1 annihilates the iterate
    (W <- S): alpha underflows to zero, so it is floored back to 1 *and* the
    live factors' s entries are zeroed; flooring alone would bring the old
    factors back at full scale. The line search clips gamma into [0, 1], so
    gamma == 1 is reachable at any t. ``it`` is updated in place and
    returned.
    """
    new_alpha = it.alpha * (1.0 - gamma)
    dead = torch.abs(new_alpha) < 1e-30
    one = torch.ones_like(new_alpha)
    safe_alpha = torch.where(dead, one, new_alpha)
    s_live = torch.where(dead, torch.zeros_like(it.s), it.s)
    s_new = -gamma * mu / safe_alpha
    k = it.count.reshape(1).long()
    return _append(it, k, u.reshape(1, -1), s_live, s_new.reshape(1), v.reshape(1, -1),
                   safe_alpha, 1)


def _append(it: FactoredIterate, rows, u_rows, s_live, s_new, v_rows, alpha,
            k: int) -> FactoredIterate:
    """``it`` with factor rows ``rows`` written, ``s_live`` for the old
    scales, ``alpha`` and the count advanced by k, in place."""
    it.u.index_copy_(0, rows, u_rows.to(it.u.dtype))
    it.s.copy_(s_live).index_copy_(0, rows, s_new.to(it.s.dtype))
    it.v.index_copy_(0, rows, v_rows.to(it.v.dtype))
    it.alpha.copy_(alpha)
    it.count.add_(k)
    return it


def fw_update_block(
    it: FactoredIterate, u: torch.Tensor, v: torch.Tensor, c: torch.Tensor,
    gamma: torch.Tensor, mu: float,
) -> FactoredIterate:
    """Rank-k FW step: W <- (1-gamma) W + gamma S with the blended block atom
    S = -mu sum_j c_j u_j v_j^T, appending k factors at once.

    ``u`` (d, k) and ``v`` (m, k) hold unit atom columns, ``c`` (k,) the
    nonnegative blend weights with sum c <= 1, so ||S||_* <= mu. The alpha
    folding and the gamma = 1 dead-iterate handling are ``fw_update``'s;
    the k new rows land at ``count .. count+k-1`` (on the device: no host
    read of ``count``), in place as in ``fw_update``.
    """
    k = u.shape[1]
    new_alpha = it.alpha * (1.0 - gamma)
    dead = torch.abs(new_alpha) < 1e-30
    safe_alpha = torch.where(dead, torch.ones_like(new_alpha), new_alpha)
    s_live = torch.where(dead, torch.zeros_like(it.s), it.s)
    s_new = (-gamma * mu / safe_alpha) * c.to(it.s.dtype)
    rows = it.count.reshape(1).long() + torch.arange(k, device=it.count.device)
    return _append(it, rows, u.T, s_live, s_new, v.T, safe_alpha, k)


def materialize(it: FactoredIterate) -> torch.Tensor:
    """Dense W, O(dm) memory; tests and small problems only."""
    return it.alpha * torch.einsum("k,kd,km->dm", it.s, it.u, it.v)


def matvec(it: FactoredIterate, x: torch.Tensor) -> torch.Tensor:
    """W @ x in O(t(d+m)) without materializing W."""
    return it.alpha * (it.u.T @ (it.s * (it.v @ x)))


def rmatvec(it: FactoredIterate, x: torch.Tensor) -> torch.Tensor:
    """W^T @ x in O(t(d+m))."""
    return it.alpha * (it.v.T @ (it.s * (it.u @ x)))


def gather_entries(it: FactoredIterate, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """W[rows, cols] for index vectors (p,) in O(t p): held-out evaluation
    for matrix completion without materializing W."""
    rows, cols = rows.long(), cols.long()
    return it.alpha * torch.einsum("k,kp,kp->p", it.s, it.u[:, rows], it.v[:, cols])


#: Rows of X a ``right_multiply`` launch takes: 65,536 rows of 1,000
#: logits are 262 MB on the card.
RIGHT_MULTIPLY_ROWS = 1 << 16


def right_multiply(it: FactoredIterate, x: torch.Tensor) -> torch.Tensor:
    """X @ W for row-major data X (n, d) -> (n, m), factored: alpha ((X U^T)
    diag(s)) V, without forming W. One ``factor_matvec`` call a chunk of
    ``RIGHT_MULTIPLY_ROWS`` rows: the kernel on a CUDA tensor, its plain
    version on the CPU. Rows of the store past ``count`` carry s = 0 and add
    exact zeros, and the kernel's batch tiling moves no bit, so on the card
    the chunks give one call's bits."""
    x = x.contiguous()
    parts = [fm_ops.factor_matvec(x[lo:lo + RIGHT_MULTIPLY_ROWS], it.u, it.s, it.v,
                                  alpha=it.alpha)
             for lo in range(0, x.shape[0], RIGHT_MULTIPLY_ROWS)] or [
        torch.zeros((0, it.v.shape[1]), dtype=torch.float32, device=x.device)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def trace_norm_upper_bound(it: FactoredIterate) -> torch.Tensor:
    """||W||_* <= |alpha| sum_k |s_k| (triangle inequality on unit factors)."""
    return torch.abs(it.alpha) * torch.sum(torch.abs(it.s))


#: Keys of ``pack_live``'s dict, in the order a checkpoint stores them.
PACKED_KEYS = ("alpha", "count", "s", "u", "v")


def pack_live(it: FactoredIterate) -> dict:
    """Host (numpy) dict of the iterate trimmed to its ``count`` live factors,
    in the JAX package's ``pack_live`` layout. Reads the device: not for the
    epoch loop."""
    k = int(it.count)
    return {
        "u": it.u[:k].cpu().numpy(),
        "s": it.s[:k].cpu().numpy(),
        "v": it.v[:k].cpu().numpy(),
        "alpha": it.alpha.cpu().numpy(),
        "count": it.count.cpu().numpy(),
    }


def unpack_live(packed: dict, max_rank: int, *, device) -> FactoredIterate:
    """Inverse of ``pack_live`` onto a ``max_rank``-capacity store (which may
    differ from the saved one as long as it holds the live prefix)."""
    k = int(np.asarray(packed["count"]))
    if max_rank < k:
        raise ValueError(f"max_rank={max_rank} < {k} live factors in the packed iterate")

    def pad(x):
        x = np.asarray(x, np.float32)
        out = np.zeros((max_rank,) + x.shape[1:], np.float32)
        out[:k] = x[:k]
        return torch.from_numpy(out).to(device)

    return FactoredIterate(
        u=pad(packed["u"]),
        s=pad(packed["s"]),
        v=pad(packed["v"]),
        alpha=torch.from_numpy(np.array(packed["alpha"], np.float32).reshape(())).to(device),
        count=torch.from_numpy(np.array(packed["count"], np.int32).reshape(())).to(device),
    )
