"""Plain PyTorch versions of the observed-entry (COO) matvec.

The matrix-completion gradient ``G = P_Omega(W - M)`` has values ``vals_e``
at ``(rows_e, cols_e)``; ``G v`` and ``G^T u`` are segment sums over the
entries (``jax.ops.segment_sum`` in the JAX package, ``index_add_`` here).
On CUDA ``index_add_`` uses float atomics, so its last bits can change from
run to run; the kernel's are fixed.
"""
from __future__ import annotations

import torch


def coo_matvec(seg: torch.Tensor, gat: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
               out_dim: int) -> torch.Tensor:
    """out[seg_e] += vals_e * x[gat_e] -> (out_dim,) float32."""
    out = torch.zeros(out_dim, dtype=torch.float32, device=vals.device)
    return out.index_add_(0, seg, vals * x[gat])


def matvec(rows, cols, vals, v, num_rows: int) -> torch.Tensor:
    """G @ v -> (num_rows,): scatter vals_e * v[cols_e] into rows."""
    return coo_matvec(rows, cols, vals, v, num_rows)


def rmatvec(rows, cols, vals, u, num_cols: int) -> torch.Tensor:
    """G^T @ u -> (num_cols,): scatter vals_e * u[rows_e] into cols."""
    return coo_matvec(cols, rows, vals, u, num_cols)


def gather_sorted(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """vals[perm]: caller-order values in a sorted order."""
    return vals[perm.long()]


def coo_matvec_sorted(order, vals_sorted: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[seg_e] += vals_e * x[gat_e] over a ``SegmentOrder``, from values in
    its sorted order: the segment of sorted position k is the s with
    seg_ptr[s] <= k < seg_ptr[s + 1]."""
    seg_sorted = torch.repeat_interleave(
        torch.arange(order.out_dim, device=vals_sorted.device), torch.diff(order.seg_ptr),
        output_size=vals_sorted.numel())
    return coo_matvec(seg_sorted, order.gat_sorted, vals_sorted, x, order.out_dim)


def coo_matvec_pieces(order, vals_sorted: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's two stages on a ``SegmentOrder``, in plain PyTorch: the
    products in sorted order (values in that order) summed per piece, then
    the pieces per segment. Holds the order's structure (every entry in
    exactly one piece of its own segment) to the plain version on the CPU."""
    dev = vals_sorted.device
    num_pieces = order.piece_start.numel()
    contrib = vals_sorted * x[order.gat_sorted.long()]
    lengths = order.piece_end - order.piece_start
    piece_of = torch.repeat_interleave(torch.arange(num_pieces, device=dev), lengths)
    first = torch.cumsum(lengths, 0) - lengths  # each piece's first slot in `entry`
    slot = torch.arange(piece_of.numel(), device=dev)
    entry = order.piece_start[piece_of] + slot - first[piece_of]
    partial = torch.zeros(num_pieces, dtype=torch.float32, device=dev).index_add_(
        0, piece_of, contrib[entry])
    seg_of = torch.repeat_interleave(
        torch.arange(order.out_dim, device=dev), torch.diff(order.piece_ptr))
    return torch.zeros(order.out_dim, dtype=torch.float32, device=dev).index_add_(
        0, seg_of, partial)
