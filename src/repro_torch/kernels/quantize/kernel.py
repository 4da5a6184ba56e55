"""ctypes binding of ``csrc/quantize.cu`` (see its header for the design).

Launches go on PyTorch's current stream and do not synchronise; the caller
allocates the output. A launch that CUDA refuses raises here.
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
        lib = _build.library("quantize")
        lib.qz_quantize_f32.argtypes = [_P, _P, _P, _P, _I64, _I, _I, _P]
        lib.qz_quantize_f32.restype = ctypes.c_int
        lib.qz_dequantize_f32.argtypes = [_P, _P, _P, _I64, _I, _I, _P]
        lib.qz_dequantize_f32.restype = ctypes.c_int
        lib.qz_error_string.argtypes = [ctypes.c_int]
        lib.qz_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.qz_error_string(err).decode()}")


def quantize(x: torch.Tensor, noise: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
             budget: int) -> None:
    """out (n,) int8 = quantize(x, noise, scale); scale is a device scalar."""
    lib = _library()
    err = lib.qz_quantize_f32(
        x.data_ptr(), noise.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel(),
        budget, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check(lib, err, "quantize")


def dequantize(q: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, budget: int) -> None:
    """out (n,) f32 = q * (scale / budget)."""
    lib = _library()
    err = lib.qz_dequantize_f32(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), q.numel(), budget,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(lib, err, "dequantize")
