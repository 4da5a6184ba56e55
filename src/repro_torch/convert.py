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


def _fields(obj: Any) -> dict:
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    if isinstance(obj, dict):
        return dict(obj)
    raise TypeError(f"expected a NamedTuple or dict of arrays, got {type(obj).__name__}")


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)


def task_state(state: Any, *, device: DeviceLike = None):
    """``MTLSState`` (x, y, r) or ``LogisticState`` (x, y, z; int32 labels
    become int64) from the JAX package's state of the same name."""
    dev = resolve_device(device)
    f = _fields(state)
    if set(f) == {"x", "y", "r"}:
        return tasks.MTLSState(x=_f32(f["x"], dev), y=_f32(f["y"], dev), r=_f32(f["r"], dev))
    if set(f) == {"x", "y", "z"}:
        labels = torch.from_numpy(np.asarray(f["y"]).astype(np.int64)).to(dev)
        return tasks.LogisticState(x=_f32(f["x"], dev), y=labels, z=_f32(f["z"], dev))
    raise TypeError(f"no port state with fields {sorted(f)} (MTLS: x/y/r, logistic: x/y/z)")


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
