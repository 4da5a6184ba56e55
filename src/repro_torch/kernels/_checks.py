"""Argument checks shared by the kernel wrappers (``*/ops.py``).

A wrapper takes the plain PyTorch version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises. These checks run on both, so a
CPU test sees the same refusals the card would.
"""
from __future__ import annotations

from typing import Sequence

import torch


def dense_f32(t: torch.Tensor, name: str, shape: Sequence[int]) -> None:
    """``t`` is a contiguous float32 tensor of exactly ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def vector_f32(t: torch.Tensor, name: str, length: int) -> torch.Tensor:
    """``t`` of shape (length,) or (length, 1), float32, contiguous; as (length,)."""
    if isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[1] == 1:
        t = t.reshape(t.shape[0])
    dense_f32(t, name, (length,))
    return t


def same_device(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def kernel_device(device: torch.device, op: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {device}")
