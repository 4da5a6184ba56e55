"""Public wrapper of the observed-entry (COO) matvec.

``build_order(seg, gat, out_dim, in_dim)`` builds, once per run and on the
entries' device, the stable segment-sorted order the kernel reduces along
(the entries' indices never change during a run). ``coo_matvec(order, vals,
x)`` is ``out[seg_e] += vals_e * x[gat_e]`` for values in the caller's entry
order: G v with the row order, G^T u with the column order. CPU tensors take
the plain version (``ref.py``, on the caller-order indices); CUDA tensors
launch the hand-written kernel (``csrc/mc_matvec.cu``) or raise. The wrapper
counts its kernel launches in ``coo_matvec.launches``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _checks
from . import kernel, ref

# Entries per piece: a warp's share of one segment. Fixed per run, so the
# summation order, and the result's bits, are the same on every call.
PIECE = 1024


@dataclasses.dataclass(frozen=True)
class SegmentOrder:
    """A segment-sorted view of a COO entry set (built by :func:`build_order`).

    ``seg``/``gat`` are the caller-order index vectors themselves (no copy).
    ``perm`` lists the entries sorted by segment, stably; ``gat_sorted`` is
    ``gat[perm]``; segment s owns sorted positions ``seg_ptr[s]:seg_ptr[s+1]``
    and pieces ``piece_ptr[s]:piece_ptr[s+1]``; piece j covers sorted
    positions ``piece_start[j]:piece_end[j]`` (at most ``PIECE`` of them).
    """

    seg: torch.Tensor  # (p,) int32, caller order
    gat: torch.Tensor  # (p,) int32, caller order
    perm: torch.Tensor  # (p,) int32
    gat_sorted: torch.Tensor  # (p,) int32
    seg_ptr: torch.Tensor  # (out_dim + 1,) int64
    piece_start: torch.Tensor  # (pieces,) int64
    piece_end: torch.Tensor  # (pieces,) int64
    piece_ptr: torch.Tensor  # (out_dim + 1,) int64
    in_dim: int

    @property
    def out_dim(self) -> int:
        return self.seg_ptr.numel() - 1

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def to(self, device) -> "SegmentOrder":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "in_dim"
        })


def _index(t: torch.Tensor, name: str) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    return t.contiguous()


def build_order(seg: torch.Tensor, gat: torch.Tensor, out_dim: int, in_dim: int) -> SegmentOrder:
    """The segment-sorted order of entries (seg_e, gat_e), on their device,
    cut into pieces of at most ``PIECE`` entries.

    Checks the indices against ``[0, out_dim)`` and ``[0, in_dim)`` (one
    host read), since the kernel would read out of bounds otherwise.
    """
    seg, gat = _index(seg, "seg"), _index(gat, "gat")
    if seg.shape != gat.shape:
        raise ValueError(f"seg {tuple(seg.shape)} and gat {tuple(gat.shape)} differ in shape")
    if out_dim < 0 or in_dim < 0:
        raise ValueError("out_dim and in_dim must be >= 0")
    piece = PIECE
    p, dev = seg.numel(), seg.device
    if p >= 2**31:
        raise ValueError(f"{p} entries: the order uses int32 positions (< 2**31)")
    if p:
        lo_s, hi_s, lo_g, hi_g = torch.stack(
            [seg.min(), seg.max(), gat.min(), gat.max()]).tolist()
        if lo_s < 0 or hi_s >= out_dim:
            raise ValueError(f"segment indices must lie in [0, {out_dim})")
        if lo_g < 0 or hi_g >= in_dim:
            raise ValueError(f"gather indices must lie in [0, {in_dim})")
    perm = torch.sort(seg, stable=True).indices
    counts = torch.bincount(seg, minlength=out_dim)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    seg_ptr = torch.cat([zero, torch.cumsum(counts, 0)])
    pieces = torch.div(counts + (piece - 1), piece, rounding_mode="floor")
    piece_ptr = torch.cat([zero, torch.cumsum(pieces, 0)])
    num_pieces = int(piece_ptr[-1])
    piece_seg = torch.repeat_interleave(
        torch.arange(out_dim, device=dev), pieces, output_size=num_pieces)
    local = torch.arange(num_pieces, device=dev) - piece_ptr[piece_seg]
    piece_start = seg_ptr[piece_seg] + local * piece
    piece_end = torch.minimum(piece_start + piece, seg_ptr[piece_seg + 1])
    return SegmentOrder(
        seg=seg, gat=gat, perm=perm.to(torch.int32), gat_sorted=gat[perm],
        seg_ptr=seg_ptr, piece_start=piece_start, piece_end=piece_end,
        piece_ptr=piece_ptr, in_dim=int(in_dim),
    )


def coo_matvec(order: SegmentOrder, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[seg_e] += vals_e * x[gat_e]`` -> (out_dim,) float32; on CUDA the
    same bits on every call."""
    p = order.perm.numel()
    vals = _checks.vector_f32(vals, "vals", p)
    x = _checks.vector_f32(x, "x", order.in_dim)
    _checks.same_device(order.device, vals=vals, x=x)
    if not _checks.kernel_device(vals.device, "coo_matvec"):
        return ref.coo_matvec(order.seg, order.gat, vals, x, order.out_dim)
    out = torch.empty(order.out_dim, dtype=torch.float32, device=vals.device)
    if order.out_dim == 0:
        return out
    partial = torch.empty(order.piece_start.numel(), dtype=torch.float32, device=vals.device)
    kernel.coo_matvec(order, vals, x, partial, out)
    coo_matvec.launches += 1
    return out


coo_matvec.launches = 0
