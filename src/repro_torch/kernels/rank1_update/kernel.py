"""ctypes binding of ``csrc/rank1_update.cu`` (see its header for the design).

Launches go on PyTorch's current stream and do not synchronise; the caller
allocates the output (which may be ``z`` itself, for an in-place update).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("rank1_update")
        lib.r1_update_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _P]
        lib.r1_update_f32.restype = ctypes.c_int
        lib.rk_update_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P]
        lib.rk_update_f32.restype = ctypes.c_int
        lib.r1_error_string.argtypes = [ctypes.c_int]
        lib.r1_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def update(
    out: torch.Tensor, z: torch.Tensor, y0: Optional[torch.Tensor],
    x: torch.Tensor, y: torch.Tensor, scal: torch.Tensor,
) -> None:
    """out = a*z + b*x y^T [+ c*y0], with scal = [a, b(, c)] on the device."""
    lib = _library()
    n, m = z.shape
    mats = [out, z, y] + ([y0] if y0 is not None else [])
    vec = 4 if m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in mats) else 1
    err = lib.r1_update_f32(
        out.data_ptr(), z.data_ptr(), y0.data_ptr() if y0 is not None else None,
        x.data_ptr(), y.data_ptr(), scal.data_ptr(), n, m, int(y0 is not None),
        vec, z.device.index, torch.cuda.current_stream(z.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"rank1_update launch failed: {lib.r1_error_string(err).decode()}"
        )


def update_k(
    out: torch.Tensor, z: torch.Tensor, y0: Optional[torch.Tensor],
    p: torch.Tensor, q: torch.Tensor, scal: torch.Tensor,
) -> None:
    """out = a*z + b*p q^T [+ c*y0] for p (n, k), q (m, k), scal = [a, b(, c)]."""
    lib = _library()
    n, m = z.shape
    err = lib.rk_update_f32(
        out.data_ptr(), z.data_ptr(), y0.data_ptr() if y0 is not None else None,
        p.data_ptr(), q.data_ptr(), scal.data_ptr(), n, m, p.shape[1], int(y0 is not None),
        z.device.index, torch.cuda.current_stream(z.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"rankk_update launch failed: {lib.r1_error_string(err).decode()}"
        )
