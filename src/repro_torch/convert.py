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


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32, copy=True)).to(device)


def task_state(state: Any, *, device: DeviceLike = None, d: int = None, m: int = None):
    """``MTLSState`` (x, y, r), ``LogisticState`` (x, y, z; int32 labels
    become int64) or ``MCState`` (rows, cols, vals, resid, weight, in the
    same entry order) from the JAX package's state of the same name. An
    ``MCState`` needs the task's ``d`` and ``m``, to build the kernel's row
    and column orders and the residual's copies in them."""
    dev = resolve_device(device)
    f = _fields(state)
    if set(f) == {"rows", "cols", "vals", "resid", "weight"}:
        if d is None or m is None:
            raise TypeError("an MCState needs the task's d and m")
        return tasks.mc_state(_i32(f["rows"], dev), _i32(f["cols"], dev), _f32(f["vals"], dev),
                              _f32(f["resid"], dev), _f32(f["weight"], dev), d, m)
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


def packed_iterate(packed: Any) -> dict:
    """The serving model's weights from the JAX package: the dict of
    ``repro.core.low_rank.pack_live`` (after ``jax.device_get``) as numpy
    arrays with the port's dtypes (f32 factors and alpha, int32 count), ready
    for ``ServingEngine.load``."""
    f = _fields(packed)
    if set(f) != set(low_rank.PACKED_KEYS):
        raise TypeError(f"no packed iterate with fields {sorted(f)} (expected "
                        f"{'/'.join(low_rank.PACKED_KEYS)})")
    return {k: np.array(f[k], dtype=np.int32 if k == "count" else np.float32, copy=True)
            for k in low_rank.PACKED_KEYS}


def _float_tensor(a, device) -> torch.Tensor:
    """A float32 or bfloat16 array as a tensor on ``device``, bit for bit.
    bf16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses: it is viewed as uint16, then as bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(
            torch.bfloat16).to(device)
    if a.dtype != np.float32:
        raise TypeError(f"expected a float32 or bfloat16 leaf, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def lm_params(params: Any, cfg, *, device: DeviceLike = None) -> dict:
    """The port's parameter dict of an LM from the JAX package's (after
    ``jax.device_get``): the same names and leaves, with the stacked
    ``(L, ...)`` layer leaves unstacked into ``params["layers"][i]``, nested
    dicts (the ssm family's ``tm_cm``) included; each leaf keeps its dtype,
    so the f32 leaves of a bf16 model (``w_base``, ``u_bonus``) stay f32.
    Only the families the port runs (``models.lm.PORTED_FAMILIES``) are
    taken."""
    from .models import lm

    lm.check_family(cfg)
    dev = resolve_device(device)
    f = _fields(params)
    out = {name: _float_tensor(f[name], dev)
           for name in ("embed", "final_norm", "unembed") if name in f}
    stacked = f["layers"]

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.shape[0] != cfg.num_layers:
            raise ValueError(f"stacked leaf of shape {a.shape}: expected {cfg.num_layers} layers")
        return _float_tensor(a[i], dev)

    out["layers"] = [layer(stacked, i) for i in range(cfg.num_layers)]
    return out


def epoch_counter(t: Union[int, np.ndarray, Any]) -> int:
    """The epoch counter (the JAX carry's 0-d int32 ``t``) as a host int."""
    return int(np.asarray(t))
