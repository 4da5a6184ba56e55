"""ctypes binding of ``csrc/factor_matvec.cu`` (see its header for the design).

The launch goes on PyTorch's current stream and does not synchronise; the
caller allocates the output. A launch that CUDA refuses raises here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_lib = None

# Batch rows per block, largest first; the kernel is compiled for these.
ROWS_PER_BLOCK = (8, 4, 2, 1)
# Blocks wanted before a block takes more rows (about one per SM).
MIN_BLOCKS = 128


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("factor_matvec")
        lib.fm_factor_matvec_f32.argtypes = [_P] * 5 + [_I64] * 4 + [_I, _I, _I, _P]
        lib.fm_factor_matvec_f32.restype = ctypes.c_int
        lib.fm_error_string.argtypes = [ctypes.c_int]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rows_per_block(bt: int) -> int:
    """The most rows per block that still leaves ``MIN_BLOCKS`` blocks (the
    result's bits do not depend on it)."""
    return next((r for r in ROWS_PER_BLOCK if -(-bt // r) >= MIN_BLOCKS), 1)


def factor_matvec(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                  out: torch.Tensor) -> None:
    """out (bt, n_out) = ((x (bt, n_in) @ a (r, n_in)^T) * s (r,)) @ b (r, n_out);
    all f32, contiguous, on one CUDA device, bt >= 1 and r >= 1."""
    lib = _library()
    bt, n_in = x.shape
    r, n_out = b.shape
    vec4 = int(n_in % 4 == 0 and x.data_ptr() % 16 == 0 and a.data_ptr() % 16 == 0)
    err = lib.fm_factor_matvec_f32(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
        bt, n_in, r, n_out, rows_per_block(bt), vec4, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"factor_matvec launch failed: {lib.fm_error_string(err).decode()}")
