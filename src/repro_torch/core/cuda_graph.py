"""CUDA graphs: one captured program (:func:`capture`), and one executable
graph with IF conditional nodes from captured pieces (:class:`CondGraph`).

:func:`capture` records straight-line device work into one
``torch.cuda.CUDAGraph``, replayed with ``graph.replay()``: the decode step of
``launch.serve.generate`` and the per-bucket scorer of
``serve.ServingEngine``, the counterparts of ``jax.jit(serve_step)`` and of the
reference's ahead-of-time executables.

PyTorch captures straight-line work (``torch.cuda.CUDAGraph(keep_graph=True)``);
``csrc/cuda_graph.cu`` strings such pieces together and puts some under IF
nodes (CUDA 12.4 or later), the counterpart of ``lax.cond`` inside a compiled
scan. :class:`CondGraph` runs a Python program once to build the graph: the
program's work is captured piece by piece, and each ``when(pred, body)`` it
calls ends the current piece, captures ``body`` into the body graph of an IF
node on the 0-d bool device tensor ``pred``, and starts the next piece.
``replay`` then launches the whole program on the current stream with no
host work beyond the launch.

Every piece allocates from one memory pool (``pool``), shared with the other
graphs a run replays one after another; a tensor a piece writes and a later
piece reads stays alive in Python until the graph is built. What a body
computes must land in tensors allocated outside it: a body that does not run
leaves its own allocations unwritten.
"""
from __future__ import annotations

import ctypes
import gc
import time
import warnings
from typing import Callable, List

import torch

from ..analysis import recorder
from ..kernels import _count

_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..kernels import _build

        lib = _build.library("cuda_graph")
        for name, args in (("cg_graph_create", [ctypes.POINTER(_P)]),
                           ("cg_graph_destroy", [_P]),
                           ("cg_node_count", [_P, ctypes.POINTER(ctypes.c_size_t)]),
                           ("cg_add_child", [_P, _P, ctypes.POINTER(_P)]),
                           ("cg_add_if", [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P)]),
                           ("cg_instantiate", [ctypes.POINTER(_P), _P]),
                           ("cg_launch", [_P, _P]),
                           ("cg_exec_destroy", [_P]),
                           ("cg_runtime_version", [ctypes.POINTER(ctypes.c_int)])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        lib.cg_error_string.argtypes = [ctypes.c_int]
        lib.cg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA graph {what} failed: {_library().cg_error_string(err).decode()}")


def capture(program: Callable[[], None], *, stream: torch.cuda.Stream, pool=None,
            generators=()):
    """Capture ``program()`` (device work with no host reads) into one
    ``torch.cuda.CUDAGraph`` on ``stream``, after it waits for the current
    stream; the current stream then waits for ``stream``. ``pool``: a
    ``torch.cuda.graph_pool_handle()`` to share (default: a fresh one);
    ``generators``: ``torch.Generator`` s the program draws from, registered
    so that each replay draws afresh. Returns ``(graph, capture ms, pool
    bytes)``, the bytes the capture reserved. A capture that fails raises;
    no garbage collection runs while it is open (see :class:`CondGraph`)."""
    dev = stream.device
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    current = torch.cuda.current_stream(dev)
    stream.wait_stream(current)
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
    collecting = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=torch.cuda.graph_pool_handle() if pool is None else pool)
            try:
                program()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    capture_ms = 1e3 * (time.perf_counter() - t0)
    current.wait_stream(stream)
    # The device counters of an open ``kernels.Executed`` block that the
    # graph's launches add into: kept alive as long as the graph, which may
    # be replayed after the block has closed.
    graph.counters = None if _count.ACTIVE is None else _count.ACTIVE[1]
    return graph, capture_ms, torch.cuda.memory_stats(dev)["reserved_bytes.all.current"] - reserved


def runtime_version() -> int:
    """The CUDA runtime's version (12080 for 12.8); IF nodes need 12040."""
    v = ctypes.c_int(0)
    _check(_library().cg_runtime_version(ctypes.byref(v)), "version query")
    return v.value


class CondGraph:
    """A program captured once into one graph with IF nodes, replayed at will.

    ``CondGraph(program, pool=..., stream=...)`` runs ``program(when)`` with
    ``stream`` current, capturing its work; ``pool`` is a
    ``torch.cuda.graph_pool_handle()``. The pieces' graphs are kept (their
    pool memory is the program's scratch), as is every ``pred``;
    ``instantiate_ms`` is the host time of the graph's instantiation."""

    def __init__(self, program: Callable[[Callable], None], *, pool, stream: torch.cuda.Stream):
        lib = _library()
        self._pieces: List[torch.cuda.CUDAGraph] = []
        self._preds: List[torch.Tensor] = []
        self._pool = pool
        root = _P()
        _check(lib.cg_graph_create(ctypes.byref(root)), "create")
        self._graph = root
        self._frames = [[root, _P()]]  # (graph, tail node) being appended to
        self._exec = None
        self._piece = None
        # A garbage collection inside a capture may free another graph, whose
        # CUDA calls invalidate the capture: none runs until this one ends.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                self._begin()
                try:
                    program(self.when)
                    self._end()
                except BaseException:
                    self._abandon()
                    raise
        finally:
            if collecting:
                gc.enable()
        exec_ = _P()
        t0 = time.perf_counter()
        _check(lib.cg_instantiate(ctypes.byref(exec_), root), "instantiate")
        self.instantiate_ms = 1e3 * (time.perf_counter() - t0)
        self._exec = exec_

    def _begin(self) -> None:
        piece = torch.cuda.CUDAGraph(keep_graph=True)
        piece.capture_begin(pool=self._pool)
        self._piece = piece

    def _end(self) -> None:
        piece, self._piece = self._piece, None
        with warnings.catch_warnings():  # an empty piece (nothing between two IF nodes)
            warnings.simplefilter("ignore")
            piece.capture_end()
        self._pieces.append(piece)
        raw = _P(piece.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        _check(_library().cg_node_count(raw, ctypes.byref(count)), "node count")
        if count.value:
            graph, tail = self._frames[-1]
            _check(_library().cg_add_child(graph, raw, ctypes.byref(tail)), "child node")

    def _abandon(self) -> None:
        """End the capture a failure left open (the failure is what raises)."""
        piece, self._piece = self._piece, None
        if piece is not None:
            try:
                piece.capture_end()
            except RuntimeError:
                pass

    def when(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        """Capture ``body`` under an IF node on ``pred`` (a 0-d bool tensor
        on the device, read when the graph reaches the node)."""
        if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
            raise TypeError("an IF node's predicate is a one-element bool CUDA tensor")
        self._end()
        self._preds.append(pred)
        graph, tail = self._frames[-1]
        inner = _P()
        _check(_library().cg_add_if(graph, pred.data_ptr(), ctypes.byref(tail),
                                    ctypes.byref(inner)), "IF node")
        self._frames.append([inner, _P()])
        self._begin()
        with recorder.conditional():  # an open OpRecorder marks the body's ops
            body()
        self._end()
        self._frames.pop()
        self._begin()

    def replay(self) -> None:
        stream = torch.cuda.current_stream()
        _check(_library().cg_launch(self._exec, _P(stream.cuda_stream)), "launch")

    def __del__(self):
        lib = _lib
        if lib is None:
            return
        if getattr(self, "_exec", None) is not None:
            lib.cg_exec_destroy(self._exec)
        if getattr(self, "_graph", None) is not None:
            lib.cg_graph_destroy(self._graph)
