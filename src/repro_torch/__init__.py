"""PyTorch/CUDA port of the DFW-Trace package ``repro``.

Module names mirror ``src/repro/`` one for one. The port imports torch and
numpy only: no JAX, and nothing from ``repro`` (it keeps its own copies of
what it needs).

Two policies live here:

- **Device.** Every entry point takes a ``device`` argument and runs on
  ``cuda`` unless the caller passes ``device="cpu"``. Without CUDA, the
  default raises instead of carrying on quietly on the CPU.
- **Randomness.** The power method's start vector of epoch ``t`` comes from
  a :class:`V0Stream`, the counterpart of the JAX package's
  ``sphere_vector(fold_in(key, t), m)``. A free run draws it from a
  ``torch.Generator`` seeded by (seed, t), so epoch t's vector does not depend
  on how the run was cut into segments or resumed. A caller may instead hand
  in every epoch's vector (``V0Stream.from_table``); the parity tests inject
  the JAX run's stream that way. The int8 reducer's stochastic-rounding
  noise comes from a :class:`NoiseStream` in the same way: one uniform
  [0, 1) vector per exchange (epoch t, power iteration i, slot u or v).
  The engine takes a whole segment's draws at once (``segment``) into
  tables its graph reads: a generator draw captured in a CUDA graph would
  replay with an advanced Philox offset instead of the (seed, t) seed, so
  the draws stay on the host side of a replay.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """``cuda``; raises when CUDA is not available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default. "
            "Pass device='cpu' explicitly to run the plain PyTorch versions."
        )
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`.

    On CUDA this also pins float32 matrix products to full precision (no
    TF32), so the plain versions that run beside the kernels stay in f32.
    """
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # tensors report an index; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mix(seed: int, t: int) -> int:
    """A 63-bit generator seed for epoch ``t`` of run ``seed``."""
    return (seed * 0x9E3779B97F4A7C15 + t * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


class V0Stream:
    """Per-epoch unit start vectors for the power method.

    ``V0Stream(seed)`` draws epoch t's vector from a ``torch.Generator`` on
    the target device, seeded from (seed, t); no host sync is involved.
    ``V0Stream.from_table(rows)`` returns row t of a caller-given (T, m)
    table instead (moved to the device once); its seed is 0, the one a
    checkpoint of the run records. A resume keeps a table-fed stream
    (``tabled``): its rows are indexed by absolute epoch.

    ``stream.block(t, m, k, device)`` is the block solver's (m, k) block of
    fresh unit columns for epoch t, the counterpart of the reference's
    ``sphere_vector(fold_in(fold_in(key, t), 101 + j), m)`` for j < k: drawn
    from a generator seeded from (seed, t, 101), or slab t of a (T, m, k)
    table given to ``from_table``.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._table: Optional[torch.Tensor] = None
        self._tables: Dict[torch.device, torch.Tensor] = {}
        self._gens: Dict[torch.device, torch.Generator] = {}

    @classmethod
    def from_table(cls, table) -> "V0Stream":
        stream = cls()
        stream._table = torch.as_tensor(table, dtype=torch.float32)
        if stream._table.dim() not in (2, 3):
            raise ValueError("v0 table must be (epochs, m), or (epochs, m, k) for block columns")
        return stream

    @property
    def tabled(self) -> bool:
        """Does the stream return a caller-given table's rows?"""
        return self._table is not None

    def _row(self, t: int, shape: tuple, device: torch.device) -> torch.Tensor:
        if tuple(self._table.shape[1:]) != shape or not 0 <= t < self._table.shape[0]:
            raise IndexError(f"v0 table {tuple(self._table.shape)} has no entry {t} of shape "
                             f"{shape}")
        if device not in self._tables:
            self._tables[device] = self._table.to(device)
        return self._tables[device][t]

    def _gen(self, device: torch.device) -> torch.Generator:
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        return gen

    def block(self, t: int, m: int, k: int, device) -> torch.Tensor:
        """Epoch t's (m, k) block of unit columns."""
        device = torch.device(device)
        if self._table is not None:
            return self._row(t, (m, k), device)
        gen = self._gen(device)
        gen.manual_seed(_mix(_mix(self.seed, t), 101))
        cols = torch.randn((k, m), generator=gen, device=device, dtype=torch.float32)
        cols = cols / (torch.linalg.vector_norm(cols, dim=1, keepdim=True) + 1e-30)
        return cols.T.contiguous()

    def __call__(self, t: int, m: int, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        if self._table is not None:
            return self._row(t, (m,), device)
        from .core.power_method import sphere_vector

        gen = self._gen(device)
        gen.manual_seed(_mix(self.seed, t))
        return sphere_vector(gen, m, device)

    def segment(self, start: int, length: int, m: int, device, out=None) -> torch.Tensor:
        """Epochs ``start .. start+length-1``'s vectors as a (length, m)
        table, each row ``self(t, m, device)``'s bits; written into ``out``
        when given (an engine's preallocated table)."""
        return self._fill(start, length, (m,), device, out,
                          lambda t, dev: self(t, m, dev))

    def block_segment(self, start: int, length: int, m: int, k: int, device,
                      out=None) -> torch.Tensor:
        """:meth:`block`'s (m, k) blocks of epochs ``start ..
        start+length-1`` as a (length, m, k) table."""
        return self._fill(start, length, (m, k), device, out,
                          lambda t, dev: self.block(t, m, k, dev))

    def _fill(self, start, length, shape, device, out, draw) -> torch.Tensor:
        device = torch.device(device)
        if out is None:
            out = torch.empty((length, *shape), dtype=torch.float32, device=device)
        if self._table is not None:
            self._row(start + length - 1, shape, device)  # bounds and device copy
            return out.copy_(self._tables[device][start:start + length])
        for j in range(length):
            out[j].copy_(draw(start + j, device))
        return out


_SLOTS = {"u": 0, "v": 1}


class NoiseStream:
    """Uniform [0, 1) stochastic-rounding noise, one vector per exchange.

    ``stream(t, i, slot, dim, device)`` is the noise of the exchange in
    slot ``slot`` ("u" or "v") of power iteration ``i`` of epoch ``t``, the
    counterpart of the JAX package's ``uniform(fold_in(fold_in(fold_in(
    fold_in(key, t), 0xC033), i), slot), (dim,))``. ``NoiseStream(seed)``
    draws it from a ``torch.Generator`` on ``device`` seeded from (seed, t,
    i, slot), with no host sync, so it does not depend on how a run was cut
    into segments. ``NoiseStream(seed, worker=j)`` is worker j's stream of a
    multi-worker run, the counterpart of the reference's
    ``fold_axis_index(key, axis)``: j is mixed into the seed, so every
    worker rounds with its own draws (``worker=None``, the default, is the
    one-process stream). ``NoiseStream.from_tables(u, v)`` returns ``u[t,
    i]`` / ``v[t, i]`` of caller-given (T, K, d) and (T, K, m) tables
    instead: one worker's tables.
    """

    def __init__(self, seed: int = 0, *, worker: Optional[int] = None):
        self.seed = int(seed)
        self._base = self.seed if worker is None else _mix(self.seed, (1 << 32) + int(worker))
        self._tables: Optional[Dict[str, torch.Tensor]] = None
        self._on: Dict[tuple, torch.Tensor] = {}
        self._gens: Dict[torch.device, torch.Generator] = {}

    @classmethod
    def from_tables(cls, u, v) -> "NoiseStream":
        stream = cls(0)
        stream._tables = {
            "u": torch.as_tensor(u, dtype=torch.float32),
            "v": torch.as_tensor(v, dtype=torch.float32),
        }
        if any(t.dim() != 3 for t in stream._tables.values()):
            raise ValueError("noise tables must be (epochs, iterations, dim)")
        return stream

    def __call__(self, t: int, i: int, slot: str, dim: int, device) -> torch.Tensor:
        if slot not in _SLOTS:
            raise ValueError(f"slot must be 'u' or 'v', got {slot!r}")
        device = torch.device(device)
        if self._tables is not None:
            table = self._tables[slot]
            if not (0 <= t < table.shape[0] and 0 <= i < table.shape[1]) or table.shape[2] != dim:
                raise IndexError(
                    f"noise table {slot} {tuple(table.shape)} has no entry ({t}, {i}) "
                    f"of length {dim}"
                )
            if (slot, device) not in self._on:
                self._on[slot, device] = table.to(device)
            return self._on[slot, device][t, i]
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        gen.manual_seed(_mix(_mix(self._base, t), 2 * i + _SLOTS[slot] + 1))
        return torch.rand(dim, generator=gen, device=device, dtype=torch.float32)

    def segment(self, start: int, length: int, iters: int, d: int, m: int, device,
                out=None) -> tuple:
        """The noise of epochs ``start .. start+length-1``, iterations below
        ``iters``, as (length, iters, d) u-slot and (length, iters, m)
        v-slot tables whose entries are ``self(t, i, slot, dim, device)``'s
        bits; written into ``out`` (a pair) when given."""
        device = torch.device(device)
        if out is None:
            out = tuple(torch.empty((length, iters, dim), dtype=torch.float32, device=device)
                        for dim in (d, m))
        for tab, slot, dim in zip(out, ("u", "v"), (d, m)):
            if self._tables is not None:
                self(start + length - 1, iters - 1, slot, dim, device)  # bounds, device copy
                tab.copy_(self._on[slot, device][start:start + length, :iters])
                continue
            for j in range(length):
                for i in range(iters):
                    tab[j, i].copy_(self(start + j, i, slot, dim, device))
        return out


def as_v0_stream(key) -> V0Stream:
    """An int seed or a :class:`V0Stream` as a :class:`V0Stream`."""
    if isinstance(key, V0Stream):
        return key
    if isinstance(key, int):
        return V0Stream(key)
    raise TypeError(f"key must be an int seed or a V0Stream, got {type(key).__name__}")


from . import checkpoint, serve  # noqa: E402  (they use the policies above)

__all__ = [
    "DeviceLike", "NoiseStream", "V0Stream", "as_v0_stream", "checkpoint", "default_device",
    "resolve_device", "serve",
]
