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


def resid_step(gamma, mu, resid, vals, weight, u_e, v_e) -> torch.Tensor:
    """``MatrixCompletion.update``'s chain on entries with factors u_e and
    v_e: resid' = (1 - g) resid - g w M - (g mu) w u_e v_e, each operation a
    pass of its own (gamma a 0-d float32 tensor, mu a number: ``g * mu`` is
    f32, with mu rounded to f32 as PyTorch rounds a scalar operand)."""
    uv = weight * (u_e * v_e)
    return (1.0 - gamma) * resid - gamma * weight * vals - (gamma * mu) * uv


def segment_of_sorted(order) -> torch.Tensor:
    """The segment of every sorted position of a ``SegmentOrder``: the
    segment of its piece (pieces are contiguous and in sorted order)."""
    return torch.repeat_interleave(order.piece_seg, order.piece_end - order.piece_start,
                                   output_size=order.perm.numel())


def update_resid(gamma, mu, u, v, rows, cols, resid, vals, weight, by_row, row_copies, by_col,
                 col_copies):
    """``ops.update_resid`` in plain PyTorch: ``resid_step`` in caller order,
    and in each order's sorted order from its (resid, vals, weight) copies,
    the entry's segment factor read through its piece (the row order: u by
    row, v by column; the column order the reverse, the same product).
    Returns (caller order, row order, column order)."""
    out = [resid_step(gamma, mu, resid, vals, weight, u[rows], v[cols])]
    for order, (c_resid, c_vals, c_weight), x_seg, x_gat in (
            (by_row, row_copies, u, v), (by_col, col_copies, v, u)):
        out.append(resid_step(gamma, mu, c_resid, c_vals, c_weight,
                              x_seg[segment_of_sorted(order)], x_gat[order.gat_sorted]))
    return tuple(out)
