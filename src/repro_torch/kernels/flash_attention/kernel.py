"""ctypes binding of ``csrc/flash_attention.cu`` (see its header for the design).

Two routes, both hand-written: ``flash_attention_wgmma`` (bf16, Dh 64 or
128, strides TMA can describe; ``wgmma_route`` says when) and
``flash_attention`` (the generic kernel: f32, and every other bf16 shape).
The launch goes on PyTorch's current stream and does not synchronise; the
caller allocates the output. A launch that CUDA refuses raises here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_lib = None

# Head dims the generic kernel is compiled for; a smaller Dh runs in the next
# one up with a zero tail.
HEAD_DIMS = (64, 128)
# Head dims of the wgmma route (whole 128-byte panels of 64 bf16 columns).
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("flash_attention")
        lib.fa_forward.argtypes = ([_P] * 4 + [_I64] * 9 + [_I] * 7 + [_F] + [_I] * 5 + [_P])
        lib.fa_forward.restype = ctypes.c_int
        lib.fa_forward_wgmma.argtypes = ([_P] * 4 + [_I64] * 9 + [_I] * 6 + [_F] + [_I] * 3
                                         + [_P])
        lib.fa_forward_wgmma.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def head_dim_bucket(dh: int) -> int:
    """The compiled head dim the generic kernel runs ``dh`` in."""
    return next(d for d in HEAD_DIMS if dh <= d)


def vec_ok(dtype: torch.dtype, dh: int, *tensors: torch.Tensor) -> bool:
    """16-byte loads are safe: every row of q, k and v starts on a 16-byte
    boundary and Dh fills whole 16-byte chunks."""
    per16 = 128 // torch.finfo(dtype).bits
    if dh % per16:
        return False
    for t in tensors:
        if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
            return False
    return True


def _tma_strides(t: torch.Tensor):
    """t's (B, H, S) strides in elements for a tensor map: a dimension of
    size 1 is never stepped over, so its stride is set to 8 (16 bytes)."""
    return [st if n > 1 else 8 for n, st in zip(t.shape[:3], t.stride()[:3])]


def wgmma_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The wgmma kernel takes the call: bf16, Dh 64 or 128, Skv >= 1, and q,
    k, v each 16-byte aligned with (B, H, S) strides of whole 16-byte
    multiples (what TMA can describe)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in WGMMA_HEAD_DIMS or k.shape[2] < 1:
        return False
    return all(t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0 for st in _tma_strides(t))
               for t in (q, k, v))


def _raise(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: {lib.fa_error_string(err).decode()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                    *, scale: float, causal: bool, q_offset: int = 0) -> None:
    """The generic kernel: out (B, Hq, Sq, Dh, contiguous) = attention of q
    (B, Hq, Sq, Dh) over k, v (B, Hkv, Skv, Dh), read through their (B, H,
    S) strides; one dtype, one CUDA device, last dimension contiguous. With
    ``causal`` query row i sits at kv position ``q_offset`` + i (0, or an
    offset with q_offset + Sq <= Skv)."""
    lib = _library()
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _raise(lib, lib.fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, hq, hkv, sq, skv, dh, head_dim_bucket(dh), scale, int(causal), int(q_offset),
        _DTYPE_CODE[q.dtype], int(vec_ok(q.dtype, dh, q, k, v)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    ))


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                          *, scale: float, causal: bool, q_offset: int = 0) -> None:
    """The wgmma kernel, for calls ``wgmma_route`` accepts; as above."""
    lib = _library()
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _raise(lib, lib.fa_forward_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        b, hq, hkv, sq, skv, dh, scale, int(causal), int(q_offset), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
