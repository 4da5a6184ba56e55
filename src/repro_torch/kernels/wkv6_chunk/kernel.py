"""ctypes binding of ``csrc/wkv6_chunk.cu`` (see its header for the design).

The launch goes on PyTorch's current stream and does not synchronise; the
caller allocates y and S_out. A launch that CUDA refuses raises here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_lib = None

#: Largest dk and dv the kernel is compiled for (RWKV-6's head size).
MAX_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("wkv6_chunk")
        lib.wkv6_forward.argtypes = [_P] * 8 + [_I64] * 15 + [_I] * 8 + [_P]
        lib.wkv6_forward.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def wkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor, y: torch.Tensor, s_out: torch.Tensor) -> None:
    """y (B, H, q, dv) f32, read through its strides, and s_out (B, H, dk,
    dv) f32, contiguous, of one chunk: r, k, logw (B, H, q, dk) and v (B, H,
    q, dv) through their (B, H, q) strides, u (H, dk) and s0 (B, H, dk, dv)
    contiguous f32; one CUDA device, last dimensions contiguous."""
    lib = _library()
    b, h, q, dk = r.shape
    dv = v.shape[-1]
    err = lib.wkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
        *y.stride()[:3], b, h, q, dk, dv, _DTYPE_CODE[r.dtype], _DTYPE_CODE[logw.dtype],
        r.device.index, torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"wkv6_chunk launch failed: {lib.wkv6_error_string(err).decode()}")
