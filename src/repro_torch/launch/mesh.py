"""Device meshes of the port, the counterpart of ``repro.launch.mesh``.

Single node : (16, 16)    ("data", "model")          = 256 workers
Multi-node  : (2, 16, 16) ("pod", "data", "model")   = 512 workers

A :class:`Mesh` separates the layout (``shape``, ``axis_names``) from the
processes that run it. A layout alone resolves sharding specs (as JAX's
abstract mesh does), so the spec functions and tests need no process group.
A mesh over a ``comm.WorkerGroup`` lays the group's ranks out row-major over
the axes, as ``np.asarray(devices).reshape(shape)`` lays out devices: rank r
sits at ``np.unravel_index(r, shape)``. Its subgroups (the ranks that differ
only along some axes) are made once, when the mesh is built, by every worker
in the same order (``WorkerGroup.split``), so later collectives never make a
group.

Functions, not module constants, so importing never touches a device.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# NVIDIA H100 80GB HBM3 (SXM5) data-sheet figures, per card, for roofline
# estimates: dense bf16 tensor-core peak, HBM3 bandwidth, NVLink 4 bandwidth
# in one direction. The roofline numbers in PERF.md name the card and power
# limit they were measured on.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s, one direction


class Mesh:
    """A named grid of workers: ``shape`` maps axis name to size (in axis
    order, like ``jax.sharding.Mesh.shape``), ``axis_names`` is the order.
    ``group`` (a ``comm.WorkerGroup`` of exactly ``size`` workers) makes it
    a mesh of processes; without one it is a layout, whose ``rank`` is 0."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], group=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
        self.axis_names = axis_names
        self.devices_shape = shape
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        if group is not None and group.size != self.size:
            raise ValueError(f"a {shape} mesh needs {self.size} workers; the group has "
                             f"{group.size}")
        self.group = group
        self.rank = 0 if group is None else group.rank
        self._groups: Dict[Tuple[str, ...], object] = {}
        if group is not None:
            self._make_groups()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}{'' if self.group else ', layout'})"

    @property
    def coords(self) -> Dict[str, int]:
        """This worker's coordinate along each axis (row-major ranks)."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank, self.devices_shape))))

    def _order(self, axes: Sequence[str]) -> Tuple[str, ...]:
        for a in axes:
            if a not in self.shape:
                raise KeyError(f"axis {a!r} is not in the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in self._order(axes))

    def index(self, axes: Sequence[str]) -> int:
        """This worker's linear index over ``axes``, row-major in mesh order:
        its place in a tiled gather over them (``jax.lax.axis_index``)."""
        c = self.coords
        i = 0
        for a in self._order(axes):
            i = i * self.shape[a] + c[a]
        return i

    def _parts(self, axes: Tuple[str, ...]):
        """The partition of all ranks into the sets that differ only along
        ``axes``, each set in rank order (which is its row-major order)."""
        ranks = np.arange(self.size).reshape(self.devices_shape)
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        vary = [i for i, a in enumerate(self.axis_names) if a in axes]
        moved = ranks.transpose(keep + vary).reshape(
            math.prod(self.devices_shape[i] for i in keep) or 1, -1)
        return [sorted(int(r) for r in row) for row in moved]

    def _make_groups(self) -> None:
        """Every subgroup of more than one worker, made now by every worker
        in one order (subsets of the axes in mesh order); the whole mesh is
        the given group itself."""
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                size = self.axes_size(axes)
                if size <= 1:
                    continue
                key = tuple(a for a in axes if self.shape[a] > 1)
                if key in self._groups:
                    continue
                self._groups[key] = (self.group if size == self.size
                                     else self.group.split(self._parts(axes)))

    def group_of(self, axes: Sequence[str]):
        """The ``WorkerGroup`` of this worker and the workers that differ
        from it only along ``axes`` (its ranks in row-major order over the
        axes), or None where the axes hold one worker: no collective runs
        over a single worker."""
        axes = self._order(axes)
        if self.axes_size(axes) <= 1:
            return None
        if self.group is None:
            raise RuntimeError(f"{self!r} is a layout without processes: no group over {axes}")
        return self._groups[tuple(a for a in axes if self.shape[a] > 1)]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], group=None) -> Mesh:
    """A mesh of ``shape`` over ``group``'s workers (None: a layout, or one
    process when the shape holds one worker). Raises unless the group has
    exactly prod(shape) workers."""
    return Mesh(shape, axes, group)


def make_production_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``; over ``group`` (which must hold 256 or 512 workers:
    ``Mesh`` raises otherwise) or as a layout."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, group)


def parse_mesh(text: Optional[str]) -> Optional[Tuple[int, ...]]:
    """``"2x4"`` -> (2, 4) (data x model), None -> None."""
    return tuple(int(x) for x in text.split("x")) if text else None
