"""Public wrapper of the observed-entry (COO) matvec.

``build_order(seg, gat, out_dim, in_dim)`` builds, once per run and on the
entries' device, the stable segment-sorted order the kernel reduces along
(the entries' indices never change during a run). ``gather_sorted(order,
vals)`` copies values from the caller's entry order into the order's sorted
order (``vals[order.perm]``), and ``coo_matvec(order, vals_sorted, x)`` is
``out[seg_e] += vals_e * x[gat_e]`` from values in that sorted order: G v
with the row order, G^T u with the column order. The values change less
often than they are read (the matrix-completion residual: once per epoch,
read 2K times), so the caller keeps the sorted copies. It gathers them once,
with the order: ``build_order_with_copies(seg, gat, out_dim, in_dim,
fields)`` sorts and gathers the fields and the order's ``gat_sorted`` in one
record gather (each entry's fields packed into one 16-byte record, fetched
by one random read). ``update_resid`` then writes the matrix-completion
residual after each step in caller order and in each order's sorted order
at once, from values and weights kept in those orders, so the copies are
never gathered again. ``coo_matmat`` and ``update_resid`` with (d, k) and
(m, k) factors are the block forms of the block:k solver;
``update_resid_caller`` is that block ``update_resid``'s caller order alone
(the block line search's entry values). CPU tensors take
the plain versions (``ref.py``: the
segment sum over the sorted order, the gather, the update's chain); CUDA
tensors launch the hand-written kernels (``csrc/mc_matvec.cu``) or raise.
Each wrapper counts its kernel launches in ``.launches``; the gather's count
is ``gather_sorted.launches``, one per call of either gather (an order's
copies: its pack and its gather).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

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
    positions ``piece_start[j]:piece_end[j]`` (at most ``PIECE`` of them) of
    segment ``piece_seg[j]``.
    """

    seg: torch.Tensor  # (p,) int32, caller order
    gat: torch.Tensor  # (p,) int32, caller order
    perm: torch.Tensor  # (p,) int32
    gat_sorted: torch.Tensor  # (p,) int32
    seg_ptr: torch.Tensor  # (out_dim + 1,) int64
    piece_start: torch.Tensor  # (pieces,) int64
    piece_end: torch.Tensor  # (pieces,) int64
    piece_ptr: torch.Tensor  # (out_dim + 1,) int64
    piece_seg: torch.Tensor  # (pieces,) int64
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


def _sorted_order(seg: torch.Tensor, gat: torch.Tensor, out_dim: int, in_dim: int) -> dict:
    """The fields of a ``SegmentOrder`` but ``gat_sorted``: the checks, the
    stable sort and the pieces."""
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
    return dict(seg=seg, gat=gat, perm=perm.to(torch.int32), seg_ptr=seg_ptr,
                piece_start=piece_start, piece_end=piece_end, piece_ptr=piece_ptr,
                piece_seg=piece_seg, in_dim=int(in_dim))


def build_order(seg: torch.Tensor, gat: torch.Tensor, out_dim: int, in_dim: int) -> SegmentOrder:
    """The segment-sorted order of entries (seg_e, gat_e), on their device,
    cut into pieces of at most ``PIECE`` entries.

    Checks the indices against ``[0, out_dim)`` and ``[0, in_dim)`` (one
    host read), since the kernel would read out of bounds otherwise.
    """
    f = _sorted_order(seg, gat, out_dim, in_dim)
    return SegmentOrder(gat_sorted=f["gat"][f["perm"].long()], **f)


def build_order_with_copies(
    seg: torch.Tensor, gat: torch.Tensor, out_dim: int, in_dim: int,
    fields: Sequence[torch.Tensor],
) -> Tuple[SegmentOrder, Tuple[torch.Tensor, ...]]:
    """``build_order`` and the sorted copies ``field[order.perm]`` of one to
    three caller-order fields (float32 or int32, (p,) each) from one record
    gather, which also gives the order's ``gat_sorted``: each entry costs one
    random read, not one per field. On CUDA the gather uses 16 bytes an entry
    of scratch, freed before return. -> ``(order, copies)``."""
    if not 1 <= len(fields) <= 3:
        raise ValueError(f"one to three fields, got {len(fields)}")
    seg = _index(seg, "seg")
    _check_fields(seg.numel(), seg.device, fields)
    f = _sorted_order(seg, gat, out_dim, in_dim)
    *copies, gat_sorted = _gather(f["perm"], (*fields, f["gat"]))
    return SegmentOrder(gat_sorted=gat_sorted, **f), tuple(copies)


def _check_fields(p: int, device: torch.device, fields) -> None:
    for i, t in enumerate(fields):
        name = f"fields[{i}]"
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{name} must be float32 or int32, got {t.dtype}")
        if t.shape != (p,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({p},)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _checks.same_device(device, **{name: t})


def _gather(perm: torch.Tensor, fields) -> list:
    """``[t[perm] for t in fields]`` for one to four checked (p,) float32 or
    int32 fields on perm's device: one call of the kernel (for more than one
    field its pack and its gather), one count in ``gather_sorted.launches``."""
    if not _checks.kernel_device(perm.device, "gather_sorted"):
        return [ref.gather_sorted(perm, t) for t in fields]
    p = perm.numel()
    outs = [torch.empty(p, dtype=t.dtype, device=perm.device) for t in fields]
    if p == 0:
        return outs
    records = (torch.empty((p, 4), dtype=torch.int32, device=perm.device)
               if len(fields) > 1 else None)
    kernel.gather_sorted(perm, fields, outs, records)
    gather_sorted.launches += 1
    return outs


def gather_sorted(order: SegmentOrder, vals: torch.Tensor) -> torch.Tensor:
    """``vals[order.perm]``: values in the caller's entry order, copied into
    the order's sorted order (what :func:`coo_matvec` reads) -> (p,) float32;
    the one-field case of the record gather."""
    vals = _checks.vector_f32(vals, "vals", order.perm.numel())
    _checks.same_device(order.device, vals=vals)
    return _gather(order.perm, (vals,))[0]


def gather_sorted_fields(order: SegmentOrder, fields: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
    """``field[order.perm]`` for one to four caller-order fields (float32 or
    int32, (p,) each) by one record gather, as ``build_order_with_copies``
    makes them."""
    if not 1 <= len(fields) <= 4:
        raise ValueError(f"one to four fields, got {len(fields)}")
    _check_fields(order.perm.numel(), order.device, fields)
    return tuple(_gather(order.perm, fields))


def coo_matvec(order: SegmentOrder, vals_sorted: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[seg_e] += vals_e * x[gat_e]`` -> (out_dim,) float32, with the
    values in the order's sorted order (``gather_sorted(order, vals)``); on
    CUDA the same bits on every call."""
    p = order.perm.numel()
    vals_sorted = _checks.vector_f32(vals_sorted, "vals_sorted", p)
    x = _checks.vector_f32(x, "x", order.in_dim)
    _checks.same_device(order.device, vals_sorted=vals_sorted, x=x)
    if not _checks.kernel_device(vals_sorted.device, "coo_matvec"):
        return ref.coo_matvec_sorted(order, vals_sorted, x)
    out = torch.empty(order.out_dim, dtype=torch.float32, device=x.device)
    if order.out_dim == 0:
        return out
    partial = torch.empty(order.piece_start.numel(), dtype=torch.float32, device=x.device)
    kernel.coo_matvec(order, vals_sorted, x, partial, out)
    coo_matvec.launches += 1
    return out


def coo_matmat(order: SegmentOrder, vals_sorted: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The block form of :func:`coo_matvec`: ``out[seg_e, :] += vals_e *
    x[gat_e, :]`` -> (out_dim, k) float32 for x (in_dim, k), values in the
    order's sorted order (G V with the row order, G^T U with the column
    order); on CUDA the same bits on every call."""
    p = order.perm.numel()
    vals_sorted = _checks.vector_f32(vals_sorted, "vals_sorted", p)
    if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be a 2-D ({order.in_dim}, k) tensor with k >= 1")
    _checks.dense_f32(x, "x", (order.in_dim, x.shape[1]))
    _checks.same_device(order.device, vals_sorted=vals_sorted, x=x)
    if not _checks.kernel_device(vals_sorted.device, "coo_matmat"):
        return ref.coo_matvec_sorted(order, vals_sorted, x)
    k = x.shape[1]
    out = torch.empty((order.out_dim, k), dtype=torch.float32, device=x.device)
    if order.out_dim == 0:
        return out
    partial = torch.empty((order.piece_start.numel(), k), dtype=torch.float32, device=x.device)
    kernel.coo_matmat(order, vals_sorted, x, partial, out)
    coo_matmat.launches += 1
    return out


def _factor(t: torch.Tensor, name: str, rows: int) -> torch.Tensor:
    """A (rows,) vector or a (rows, k) block factor, float32, contiguous."""
    if isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[1] > 1:
        _checks.dense_f32(t, name, (rows, t.shape[1]))
        return t
    return _checks.vector_f32(t, name, rows)


def update_resid(
    gamma: torch.Tensor, mu: float, u: torch.Tensor, v: torch.Tensor,
    rows: torch.Tensor, cols: torch.Tensor, resid: torch.Tensor, vals: torch.Tensor,
    weight: torch.Tensor, by_row: SegmentOrder, row_copies: Sequence[torch.Tensor],
    by_col: SegmentOrder, col_copies: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The matrix-completion residual after a step of size ``gamma`` towards
    the atom ``-mu u v^T``, on the entries (rows, cols) with observed values
    ``vals`` and {0, 1} weights:
    ``resid' = (1 - g) resid - (g w) vals - (g mu) w u[row] v[col]``, each
    operation rounded in the chain's order, so that the bits are those of
    ``ref.resid_step``. Returns ``(resid', resid' in the row order, resid' in
    the column order)``; ``row_copies`` and ``col_copies`` are (resid, vals,
    weight) in each order's sorted order (``gather_sorted``), and each sorted
    result has the bits of ``gather_sorted(order, resid')``. ``gamma`` is a
    one-element float32 tensor on the entries' device (read there: no host
    sync); ``mu`` a number. u (d,) and v (m,) are a rank-1 atom's factors; u
    (d, k) and v (m, k) a block atom's, with u[row] v[col] the k-term dot
    in ascending j (``ref.entry_dot``), the same chain in all three orders."""
    p = rows.numel()
    rows, cols = _index(rows, "rows"), _index(cols, "cols")
    if rows.shape != (p,) or cols.shape != (p,):
        raise ValueError("rows and cols must both be (p,)")
    resid, vals, weight = (_checks.vector_f32(t, n, p) for t, n in (
        (resid, "resid"), (vals, "vals"), (weight, "weight")))
    if not (isinstance(gamma, torch.Tensor) and gamma.numel() == 1
            and gamma.dtype == torch.float32):
        raise TypeError("gamma must be a one-element float32 tensor")
    gamma = gamma.reshape(())
    u = _factor(u, "u", by_row.out_dim)
    v = _factor(v, "v", by_col.out_dim)
    if u.dim() != v.dim() or (u.dim() == 2 and u.shape[1] != v.shape[1]):
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} are not one atom's factors")
    dev = rows.device
    _checks.same_device(dev, cols=cols, resid=resid, vals=vals, weight=weight, gamma=gamma,
                        u=u, v=v)
    orders = []
    for name, order, copies, in_dim in (("row", by_row, row_copies, v.shape[0]),
                                        ("column", by_col, col_copies, u.shape[0])):
        if order.perm.numel() != p or order.in_dim != in_dim:
            raise ValueError(f"the {name} order is {order.out_dim} x {order.in_dim} over "
                             f"{order.perm.numel()} entries, not these")
        if len(copies) != 3:
            raise ValueError(f"the {name} order needs its (resid, vals, weight) copies")
        copies = tuple(_checks.vector_f32(t, f"{name}-order {n}", p)
                       for t, n in zip(copies, ("resid", "vals", "weight")))
        _checks.same_device(dev, order=order.perm, **{f"{name}_copy{i}": t
                                                      for i, t in enumerate(copies)})
        orders.append((order, copies))
    mu = float(mu)
    if not _checks.kernel_device(dev, "update_resid"):
        return ref.update_resid(gamma, mu, u, v, rows, cols, resid, vals, weight,
                                by_row, orders[0][1], by_col, orders[1][1])
    outs = tuple(torch.empty(p, dtype=torch.float32, device=dev) for _ in range(3))
    if p == 0:
        return outs
    kernel.update_resid(gamma, mu, u, v, (rows, cols, resid, vals, weight), outs, orders)
    update_resid.launches += 1
    update_resid.route_launches["block" if u.dim() == 2 else "rank1"] += 1
    return outs


def update_resid_caller(
    gamma: torch.Tensor, mu: float, u: torch.Tensor, v: torch.Tensor,
    rows: torch.Tensor, cols: torch.Tensor, resid: torch.Tensor, vals: torch.Tensor,
    weight: torch.Tensor,
) -> torch.Tensor:
    """``update_resid(...)[0]`` for block factors u (d, k) and v (m, k),
    with the same bits: the block kernel launched over the caller order
    alone, so that no sorted order is read or written. u and v are not
    checked against the entries' index range (no order gives d and m)."""
    p = rows.numel()
    rows, cols = _index(rows, "rows"), _index(cols, "cols")
    if rows.shape != (p,) or cols.shape != (p,):
        raise ValueError("rows and cols must both be (p,)")
    resid, vals, weight = (_checks.vector_f32(t, n, p) for t, n in (
        (resid, "resid"), (vals, "vals"), (weight, "weight")))
    if not (isinstance(gamma, torch.Tensor) and gamma.numel() == 1
            and gamma.dtype == torch.float32):
        raise TypeError("gamma must be a one-element float32 tensor")
    gamma = gamma.reshape(())
    if not (isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor) and u.dim() == 2
            and v.dim() == 2 and u.shape[1] == v.shape[1]):
        raise ValueError("u and v must be one block atom's (d, k) and (m, k) factors")
    _checks.dense_f32(u, "u", tuple(u.shape))
    _checks.dense_f32(v, "v", tuple(v.shape))
    dev = rows.device
    _checks.same_device(dev, cols=cols, resid=resid, vals=vals, weight=weight, gamma=gamma,
                        u=u, v=v)
    mu = float(mu)
    if not _checks.kernel_device(dev, "update_resid_caller"):
        return ref.update_resid_caller(gamma, mu, u, v, rows, cols, resid, vals, weight)
    out = torch.empty(p, dtype=torch.float32, device=dev)
    if p == 0:
        return out
    kernel.update_resid_caller(gamma, mu, u, v, (rows, cols, resid, vals, weight), out)
    update_resid_caller.launches += 1
    return out


gather_sorted.launches = 0
coo_matvec.launches = 0
coo_matmat.launches = 0
update_resid.route_launches = {"rank1": 0, "block": 0}  # update_resid_kernel, the block one
update_resid.launches = 0
update_resid_caller.launches = 0
