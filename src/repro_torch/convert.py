"""Carrying state across from the JAX package.

These functions take the JAX package's arrays as numpy (``np.asarray`` of a
``jax.Array`` works, as does any object exposing the same field names) and
build the port's objects on ``device``, so both packages can compute from
the same point: a run of the JAX package stopped at epoch t continues in the
port with ``core.frank_wolfe.fit(..., state=task_state(...),
iterate=iterate(...), start_t=epoch_counter(...))``. Nothing here imports
JAX or the JAX package.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .core import low_rank, tasks
from .kernels.mc_matvec import ops as mc_ops


def _fields(obj: Any) -> dict:
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    if isinstance(obj, dict):
        return dict(obj)
    raise TypeError(f"expected a NamedTuple or dict of arrays, got {type(obj).__name__}")


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32, copy=True)).to(device)


def task_state(state: Any, *, device: DeviceLike = None, d: int = None, m: int = None):
    """``MTLSState`` (x, y, r), ``LogisticState`` (x, y, z; int32 labels
    become int64) or ``MCState`` (rows, cols, vals, resid, weight, in the
    same entry order) from the JAX package's state of the same name. An
    ``MCState`` needs the task's ``d`` and ``m``, to build the kernel's row
    and column orders."""
    dev = resolve_device(device)
    f = _fields(state)
    if set(f) == {"rows", "cols", "vals", "resid", "weight"}:
        if d is None or m is None:
            raise TypeError("an MCState needs the task's d and m")
        rows, cols = _i32(f["rows"], dev), _i32(f["cols"], dev)
        return tasks.MCState(
            rows=rows, cols=cols, vals=_f32(f["vals"], dev), resid=_f32(f["resid"], dev),
            weight=_f32(f["weight"], dev),
            by_row=mc_ops.build_order(rows, cols, d, m),
            by_col=mc_ops.build_order(cols, rows, m, d),
        )
    if set(f) == {"x", "y", "r"}:
        return tasks.MTLSState(x=_f32(f["x"], dev), y=_f32(f["y"], dev), r=_f32(f["r"], dev))
    if set(f) == {"x", "y", "z"}:
        labels = torch.from_numpy(np.asarray(f["y"]).astype(np.int64)).to(dev)
        return tasks.LogisticState(x=_f32(f["x"], dev), y=labels, z=_f32(f["z"], dev))
    raise TypeError(f"no port state with fields {sorted(f)} (MTLS: x/y/r, logistic: x/y/z, "
                    "MC: rows/cols/vals/resid/weight)")


def iterate(it: Any, max_rank: int, *, device: DeviceLike = None) -> low_rank.FactoredIterate:
    """``FactoredIterate`` of capacity ``max_rank`` from the dict of
    ``repro.core.low_rank.pack_live`` or from a full ``FactoredIterate``
    (u, s, v, alpha, count)."""
    f = _fields(it)
    if set(f) != {"u", "s", "v", "alpha", "count"}:
        raise TypeError(f"no iterate with fields {sorted(f)} (expected u/s/v/alpha/count)")
    return low_rank.unpack_live(
        {k: np.asarray(v) for k, v in f.items()}, max_rank, device=resolve_device(device)
    )


def epoch_counter(t: Union[int, np.ndarray, Any]) -> int:
    """The epoch counter (the JAX carry's 0-d int32 ``t``) as a host int."""
    return int(np.asarray(t))
