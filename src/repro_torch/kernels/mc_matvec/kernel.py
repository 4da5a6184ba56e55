"""ctypes binding of ``csrc/mc_matvec.cu`` (see its header for the design).

Launches go on PyTorch's current stream and do not synchronise; the caller
allocates the output and the per-piece scratch. A launch that CUDA refuses
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
        lib.mc_coo_matvec_f32.argtypes = [_P] * 9 + [_I64, _I64, _I, _P]
        lib.mc_coo_matvec_f32.restype = ctypes.c_int
        lib.mc_error_string.argtypes = [ctypes.c_int]
        lib.mc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def coo_matvec(order, vals: torch.Tensor, x: torch.Tensor, partial: torch.Tensor,
               out: torch.Tensor) -> None:
    """out (out_dim,) = segment sums of vals[perm] * x[gat_sorted] over ``order``."""
    lib = _library()
    err = lib.mc_coo_matvec_f32(
        order.perm.data_ptr(), order.gat_sorted.data_ptr(), vals.data_ptr(), x.data_ptr(),
        order.piece_start.data_ptr(), order.piece_end.data_ptr(), order.piece_ptr.data_ptr(),
        partial.data_ptr(), out.data_ptr(), order.piece_start.numel(), order.out_dim,
        vals.device.index, torch.cuda.current_stream(vals.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"coo_matvec launch failed: {lib.mc_error_string(err).decode()}")
