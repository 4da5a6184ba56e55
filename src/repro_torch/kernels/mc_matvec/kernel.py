"""ctypes binding of ``csrc/mc_matvec.cu`` (see its header for the design).

Launches go on PyTorch's current stream and do not synchronise; the caller
allocates the outputs and the per-piece scratch. A launch that CUDA refuses
raises here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("mc_matvec")
        lib.mc_coo_matvec_f32.argtypes = [_P] * 8 + [_I64, _I64, _I, _P]
        lib.mc_coo_matvec_f32.restype = ctypes.c_int
        lib.mc_gather_sorted.argtypes = [_P, _I] + [_P] * 9 + [_I64, _I, _P]
        lib.mc_gather_sorted.restype = ctypes.c_int
        lib.mc_update_resid_f32.argtypes = (
            [_P, ctypes.c_float] + [_P] * 8 + [_I64] + ([_P] * 8 + [_I64]) * 2 + [_I, _P])
        lib.mc_update_resid_f32.restype = ctypes.c_int
        lib.mc_coo_matmat_f32.argtypes = [_P] * 8 + [_I64, _I64, _I64, _I, _P]
        lib.mc_coo_matmat_f32.restype = ctypes.c_int
        lib.mc_update_resid_block_f32.argtypes = (
            [_P, ctypes.c_float] + [_P] * 8 + [_I64, _I64] + ([_P] * 8 + [_I64]) * 2 + [_I, _P])
        lib.mc_update_resid_block_f32.restype = ctypes.c_int
        lib.mc_error_string.argtypes = [ctypes.c_int]
        lib.mc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.mc_error_string(err).decode()}")


def coo_matvec(order, vals_sorted: torch.Tensor, x: torch.Tensor, partial: torch.Tensor,
               out: torch.Tensor) -> None:
    """out (out_dim,) = segment sums of vals_sorted * x[gat_sorted] over ``order``."""
    lib = _library()
    _raise(lib, "coo_matvec", lib.mc_coo_matvec_f32(
        order.gat_sorted.data_ptr(), vals_sorted.data_ptr(), x.data_ptr(),
        order.piece_start.data_ptr(), order.piece_end.data_ptr(), order.piece_ptr.data_ptr(),
        partial.data_ptr(), out.data_ptr(), order.piece_start.numel(), order.out_dim,
        vals_sorted.device.index, torch.cuda.current_stream(vals_sorted.device).cuda_stream,
    ))


def coo_matmat(order, vals_sorted: torch.Tensor, x: torch.Tensor, partial: torch.Tensor,
               out: torch.Tensor) -> None:
    """out (out_dim, k) = segment sums of vals_sorted * x[gat_sorted, :] over
    ``order``, x (in_dim, k); ``partial`` is (pieces, k) scratch."""
    lib = _library()
    _raise(lib, "coo_matmat", lib.mc_coo_matmat_f32(
        order.gat_sorted.data_ptr(), vals_sorted.data_ptr(), x.data_ptr(),
        order.piece_start.data_ptr(), order.piece_end.data_ptr(), order.piece_ptr.data_ptr(),
        partial.data_ptr(), out.data_ptr(), order.piece_start.numel(), order.out_dim,
        x.shape[1], vals_sorted.device.index,
        torch.cuda.current_stream(vals_sorted.device).cuda_stream,
    ))


def gather_sorted(perm: torch.Tensor, fields, outs, records) -> None:
    """outs[f] (p,) = fields[f][perm] for 1 to 4 fields of 4-byte words;
    ``records`` is (p, 4) int32 scratch (None for one field)."""
    lib = _library()
    n = len(fields)
    src = [t.data_ptr() for t in fields] + [None] * (4 - n)
    dst = [t.data_ptr() for t in outs] + [None] * (4 - n)
    _raise(lib, "gather_sorted", lib.mc_gather_sorted(
        perm.data_ptr(), n, *src, *dst, None if records is None else records.data_ptr(),
        perm.numel(), perm.device.index, torch.cuda.current_stream(perm.device).cuda_stream,
    ))


def update_resid(gamma: torch.Tensor, mu: float, u: torch.Tensor, v: torch.Tensor, entries,
                 outs, orders) -> None:
    """outs[0] (p,) = the residual after a step, from ``entries`` (rows, cols,
    resid, vals, weight) in caller order; outs[1] and outs[2] likewise in
    the row and the column order, from ``orders``: ``(order, (resid, vals,
    weight) in its sorted order)`` for each. u (d,) and v (m,), or block
    factors (d, k) and (m, k)."""
    lib = _library()
    sorted_args = []
    for (order, copies), out_sorted in zip(orders, outs[1:]):
        sorted_args += [order.gat_sorted.data_ptr(), order.piece_start.data_ptr(),
                        order.piece_end.data_ptr(), order.piece_seg.data_ptr(),
                        *(t.data_ptr() for t in copies), out_sorted.data_ptr(),
                        order.piece_start.numel()]
    stream = torch.cuda.current_stream(u.device).cuda_stream
    if u.dim() == 2:  # block factors (d, k) and (m, k)
        _raise(lib, "update_resid", lib.mc_update_resid_block_f32(
            gamma.data_ptr(), mu, *(t.data_ptr() for t in entries), u.data_ptr(), v.data_ptr(),
            outs[0].data_ptr(), outs[0].numel(), u.shape[1], *sorted_args, u.device.index,
            stream,
        ))
        return
    _raise(lib, "update_resid", lib.mc_update_resid_f32(
        gamma.data_ptr(), mu, *(t.data_ptr() for t in entries), u.data_ptr(), v.data_ptr(),
        outs[0].data_ptr(), outs[0].numel(), *sorted_args,
        u.device.index, stream,
    ))


def update_resid_caller(gamma: torch.Tensor, mu: float, u: torch.Tensor, v: torch.Tensor,
                        entries, out) -> None:
    """out (p,) = ``update_resid``'s caller-order result for block factors u
    (d, k) and v (m, k): its kernel launched with no sorted order."""
    lib = _library()
    no_order = [None] * 8 + [0]
    _raise(lib, "update_resid_caller", lib.mc_update_resid_block_f32(
        gamma.data_ptr(), mu, *(t.data_ptr() for t in entries), u.data_ptr(), v.data_ptr(),
        out.data_ptr(), out.numel(), u.shape[1], *no_order, *no_order, u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream,
    ))
