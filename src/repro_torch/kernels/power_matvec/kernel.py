"""ctypes binding of ``csrc/power_matvec.cu`` (see its header for the design).

Launches go on PyTorch's current stream and do not synchronise; the caller
allocates every output and scratch buffer. A launch that CUDA refuses raises
here, with the error string, instead of failing later.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "pm_matvec_f32": [_P, _P, _P, _I64, _I64, _I, _I, _P],
    "pm_rmatvec_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P],
    "pm_matmat_f32": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _P],
    "pm_rmatmat_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _P],
}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("power_matvec")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.pm_error_string.argtypes = [ctypes.c_int]
        lib.pm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _vec(*tensors: torch.Tensor, m: int) -> int:
    """4 when every row starts on a 16-byte boundary (float4 loads), else 1."""
    return 4 if m % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.pm_error_string(err).decode()}")


def matvec(a: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> None:
    """out (n,) = a (n, m) @ v (m,); all f32, contiguous, on one CUDA device."""
    lib = _library()
    n, m = a.shape
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pm_matvec_f32(
        a.data_ptr(), v.data_ptr(), out.data_ptr(), n, m,
        _vec(a, v, m=m), a.device.index, stream,
    )
    _check(lib, err, "power_matvec.matvec")


def rmatvec(
    a: torch.Tensor, u: torch.Tensor, partial: torch.Tensor, out: torch.Tensor,
    rows_per_slab: int,
) -> None:
    """out (m,) = a (n, m)^T @ u (n,) via ``partial`` (ceil(n/rows_per_slab), m)."""
    lib = _library()
    n, m = a.shape
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pm_rmatvec_f32(
        a.data_ptr(), u.data_ptr(), partial.data_ptr(), out.data_ptr(), n, m,
        rows_per_slab, _vec(a, m=m), a.device.index, stream,
    )
    _check(lib, err, "power_matvec.rmatvec")


def matmat(a: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> None:
    """out (n, k) = a (n, m) @ v (m, k); all f32, contiguous, on one CUDA device."""
    lib = _library()
    n, m = a.shape
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pm_matmat_f32(a.data_ptr(), v.data_ptr(), out.data_ptr(), n, m, v.shape[1],
                            _vec(a, m=m), a.device.index, stream)
    _check(lib, err, "power_matvec.matmat")


def rmatmat(a: torch.Tensor, u: torch.Tensor, partial: torch.Tensor, out: torch.Tensor,
            rows_per_slab: int) -> None:
    """out (m, k) = a (n, m)^T @ u (n, k) via ``partial`` (ceil(n/rows_per_slab), m,
    min(k, 32))."""
    lib = _library()
    n, m = a.shape
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pm_rmatmat_f32(a.data_ptr(), u.data_ptr(), partial.data_ptr(), out.data_ptr(), n, m,
                             u.shape[1], rows_per_slab, _vec(a, m=m), a.device.index, stream)
    _check(lib, err, "power_matvec.rmatmat")
