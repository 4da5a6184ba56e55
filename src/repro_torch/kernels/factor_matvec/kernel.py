"""ctypes binding of ``csrc/factor_matvec.cu`` (see its header for the design).

The launch goes on PyTorch's current stream and does not synchronise; the
caller allocates the output. A launch that CUDA refuses raises here.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_lib = None

CLUSTER = 16  # blocks of a thread-block cluster (Hopper's non-portable most)
RANK_TILE = 64  # rank columns of T per pass
MIN_CHUNK = 64  # n_in columns a stage-1 chunk takes before the split grows
MAX_BATCH_TILES = 65535  # the grid's y extent


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is spread over the card (``launch_plan``)."""

    m_tiles: int  # 16-row MMA tiles per batch tile: 1, 2 or 4
    batch_tile: int  # batch rows a cluster owns (16 * m_tiles)
    batch_tiles: int  # clusters
    chunks: int  # blocks of a cluster that sum a chunk of n_in in stage 1
    chunk_width: int  # n_in columns per chunk (a multiple of 8)
    rank_tiles: int  # passes of RANK_TILE rank columns
    out_cols: int  # n_out columns each block of a cluster owns in stage 2

    @property
    def blocks(self) -> int:
        return CLUSTER * self.batch_tiles


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def launch_plan(bt: int, n_in: int, r: int, n_out: int) -> LaunchPlan:
    """The launch plan of one call: a cluster of ``CLUSTER`` blocks per batch
    tile of 16, 32 or 64 rows (the fewest that hold ``bt``, at most 64).
    Stage 1's split of n_in (``chunks`` x ``chunk_width``), and so the order
    of every sum, depends on n_in alone; the tiles of the batch, the ranks
    and n_out move no bit of the result."""
    if bt < 1 or r < 1 or n_in < 0 or n_out < 0:
        raise ValueError(f"factor_matvec needs bt, r >= 1 (got bt={bt}, r={r})")
    m_tiles = 1 if bt <= 16 else 2 if bt <= 32 else 4
    batch_tiles = -(-bt // (16 * m_tiles))
    if batch_tiles > MAX_BATCH_TILES:
        raise ValueError(f"batch of {bt} rows: at most {64 * MAX_BATCH_TILES} per call")
    chunks = min(CLUSTER, max(1, -(-n_in // MIN_CHUNK)))
    width = max(8, _round8(-(-n_in // chunks)))
    return LaunchPlan(m_tiles=m_tiles, batch_tile=16 * m_tiles, batch_tiles=batch_tiles,
                      chunks=max(1, -(-n_in // width)), chunk_width=width,
                      rank_tiles=-(-r // RANK_TILE),
                      out_cols=max(8, _round8(-(-n_out // CLUSTER))))


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("factor_matvec")
        lib.fm_factor_matvec.argtypes = (
            [_P] * 5 + [_I64] * 4 + [_I, _I, _I64, _I64, _I, _I, _I, _I, _P])
        lib.fm_factor_matvec.restype = ctypes.c_int
        lib.fm_error_string.argtypes = [ctypes.c_int]
        lib.fm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _four_aligned(t: torch.Tensor) -> bool:
    """Does ``t`` start on a boundary of four of its elements (a 16-byte
    f32 copy, an 8-byte bf16 load)?"""
    return t.data_ptr() % (4 * t.element_size()) == 0


def factor_matvec(x: torch.Tensor, a: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                  out: torch.Tensor) -> None:
    """out (bt, n_out) = ((x (bt, n_in) @ a (r, n_in)^T) * s (r,)) @ b (r, n_out);
    x, a and b each f32 or bf16 (read as such by the kernel), s and out f32,
    all contiguous, on one CUDA device, bt >= 1 and r >= 1."""
    lib = _library()
    bt, n_in = x.shape
    r, n_out = b.shape
    plan = launch_plan(bt, n_in, r, n_out)
    vec_in = int(n_in % 4 == 0 and _four_aligned(x) and _four_aligned(a))
    vec_out = int(n_out % 4 == 0 and _four_aligned(b))
    bf16 = sum(bit for bit, t in ((1, x), (2, a), (4, b)) if t.dtype == torch.bfloat16)
    err = lib.fm_factor_matvec(
        x.data_ptr(), a.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
        bt, n_in, r, n_out, plan.m_tiles, plan.chunks, plan.chunk_width, plan.out_cols,
        vec_in, vec_out, bf16, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"factor_matvec launch failed: {lib.fm_error_string(err).decode()}")
