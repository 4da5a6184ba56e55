"""Carrying state across from the JAX package.

These functions take the JAX package's arrays as numpy (``np.asarray`` of a
``jax.Array`` works, as does any object exposing the same field names) and
build the port's objects on ``device``, so both packages can compute from
the same point: a run of the JAX package stopped at epoch t continues in the
port with ``core.frank_wolfe.fit(..., state=task_state(...),
iterate=iterate(...), comm_state=comm_state(...),
start_t=epoch_counter(...))``; a head's ``FactoredIterate`` crosses with
``iterate``, LM weights with ``lm_params`` and a PowerSGD state with
``powersgd_state``. Nothing here imports
JAX or the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional, Union

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


_NUMPY = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64}


def _as(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device``; a tensor already there with
    that dtype is returned as it is. An array bound for the card is copied
    once, by the transfer: a writable, contiguous array of the right dtype
    (a checkpoint's, read from disk) is handed to it without a host copy.
    A read-only buffer (the JAX package's), or one bound for the CPU, is
    copied on the host, so the tensor never aliases the caller's array."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    if device.type == "cpu":
        return torch.from_numpy(np.array(a, dtype=_NUMPY[dtype], copy=True))
    # np.ascontiguousarray makes a 0-d array 1-d: keep the caller's shape
    host = np.ascontiguousarray(a, dtype=_NUMPY[dtype]).reshape(np.shape(a))
    if not host.flags.writeable:
        host = host.copy()
    return torch.from_numpy(host).to(device)


def _f32(a, device) -> torch.Tensor:
    return _as(a, torch.float32, device)


# Field sets of the task states, with each field's dtype in the port.
_STATE_DTYPES = (
    {"rows": torch.int32, "cols": torch.int32, "vals": torch.float32,
     "resid": torch.float32, "weight": torch.float32},
    {"x": torch.float32, "y": torch.float32, "r": torch.float32},
    {"x": torch.float32, "y": torch.int64, "z": torch.float32},
)


def state_tensors(state: Any, *, device: DeviceLike = None) -> dict:
    """The saved fields of a task state (the JAX package's, or a
    checkpoint's ``RunSnapshot.state``) on ``device`` with the port's dtypes
    (logistic labels int64): the host-to-device half of :func:`task_state`.
    Tensors already on ``device`` with their dtype are kept as they are."""
    dev = resolve_device(device)
    f = _fields(state)
    dtypes = next((dt for dt in _STATE_DTYPES if set(dt) == set(f)), None)
    if dtypes is None:
        raise TypeError(f"no port state with fields {sorted(f)} (MTLS: x/y/r, logistic: "
                        "x/y/z, MC: rows/cols/vals/resid/weight)")
    return {name: _as(f[name], dtypes[name], dev) for name in f}


def task_state(state: Any, *, device: DeviceLike = None, d: int = None, m: int = None):
    """``MTLSState`` (x, y, r), ``LogisticState`` (x, y, z; int32 labels
    become int64, and the label order is built) or ``MCState`` (rows, cols,
    vals, resid, weight, in the same entry order) from the JAX package's
    state of the same name or a checkpoint's saved fields. An ``MCState``
    needs the task's ``d`` and ``m``, to build the kernel's row and column
    orders and the residual's copies in them (``tasks.mc_state``)."""
    f = state_tensors(state, device=device)
    if "rows" in f:
        if d is None or m is None:
            raise TypeError("an MCState needs the task's d and m")
        return tasks.mc_state(f["rows"], f["cols"], f["vals"], f["resid"], f["weight"], d, m)
    if "r" in f:
        return tasks.MTLSState(x=f["x"], y=f["y"], r=f["r"])
    return tasks.logistic_state(f["x"], f["y"], f["z"], f["z"].shape[1])


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


def comm_state(state: Any, *, worker: Optional[int] = None, device: DeviceLike = None):
    """The reducer state of a JAX run as the port's: ``()`` stays ``()``;
    top-k's ``{"u", "v"}`` residuals become f32 tensors on ``device``. A
    multi-worker run's state carries a leading worker axis (as its
    checkpoints do): ``worker=j`` takes worker j's residuals."""
    if isinstance(state, tuple) and state == ():
        return ()
    f = _fields(state)
    if set(f) != {"u", "v"}:
        raise TypeError(f"no reducer state with fields {sorted(f)} (top-k: u/v)")
    dev = resolve_device(device)
    return {k: _f32(np.asarray(v) if worker is None else np.asarray(v)[worker], dev)
            for k, v in sorted(f.items())}


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
    # ml_dtypes' bfloat16, or the 2-byte records np.load gives for one
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(
            torch.bfloat16).to(device)
    if a.dtype != np.float32:
        raise TypeError(f"expected a float32 or bfloat16 leaf, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def lm_params(params: Any, cfg, *, device: DeviceLike = None) -> dict:
    """The port's parameter dict of an LM from the JAX package's (after
    ``jax.device_get``): the same names and leaves, with the stacked
    ``(L, ...)`` layer leaves unstacked into ``params["layers"][i]``, nested
    dicts (the ssm family's ``tm_cm``, the hybrid family's ``mamba``, the
    moe family's ``moe`` experts: ``router`` (D, E) f32, ``wg``/``wu`` (E,
    D, F), ``wd`` (E, F, D)) included; the audio family's ``frame_proj``
    and the hybrid family's ``shared`` block (one set of weights, not
    stacked) are carried as they are. Each leaf keeps its dtype, so the f32
    leaves of a bf16 model (``w_base``, ``u_bonus``; ``a_log``, ``dt_bias``,
    ``d_skip``; the moe ``router``) stay f32.
    Only the families the port runs (``models.lm.PORTED_FAMILIES``) are
    taken."""
    from .models import lm

    lm.check_family(cfg)
    dev = resolve_device(device)
    f = _fields(params)

    def carry(t):
        return {k: carry(v) for k, v in t.items()} if isinstance(t, dict) else _float_tensor(t, dev)

    out = {name: carry(f[name])
           for name in ("frame_proj", "embed", "shared", "final_norm", "unembed") if name in f}
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


def adamw_state(state: Any, cfg, *, device: DeviceLike = None):
    """The port's ``optim.adamw.AdamWState`` from the JAX package's (after
    ``jax.device_get``), or from a train checkpoint's ``{"step", "m", "v"}``
    leaves: ``step`` a 0-d int32 tensor, ``m`` and ``v`` f32 parameter trees
    laid out as ``lm_params`` lays out the weights."""
    from .optim import adamw

    f = _fields(state)
    if set(f) != {"step", "m", "v"}:
        raise TypeError(f"no AdamW state with fields {sorted(f)} (expected step/m/v)")
    dev = resolve_device(device)
    return adamw.AdamWState(step=_as(np.asarray(f["step"]).reshape(()), torch.int32, dev),
                            m=lm_params(f["m"], cfg, device=dev),
                            v=lm_params(f["v"], cfg, device=dev))


def hybrid_state(state: Any, cfg, *, device: DeviceLike = None):
    """The port's ``optim.hybrid.HybridState`` from the JAX package's (after
    ``jax.device_get``): its AdamW state as ``adamw_state`` and the FW step
    counter as a host int."""
    from .optim import hybrid

    f = _fields(state)
    if set(f) != {"adam", "fw_step"}:
        raise TypeError(f"no hybrid state with fields {sorted(f)} (expected adam/fw_step)")
    return hybrid.HybridState(adam=adamw_state(f["adam"], cfg, device=device),
                              fw_step=int(np.asarray(f["fw_step"])))


def powersgd_state(state: Any, *, device: DeviceLike = None):
    """The port's ``optim.compression.PowerSGDState`` from the JAX package's
    (after ``jax.device_get``): its ``q`` and ``error`` trees with each array
    an f32 tensor on ``device`` and each None (an uncompressed leaf) kept."""
    from .optim import compression

    f = _fields(state)
    if set(f) != {"q", "error"}:
        raise TypeError(f"no PowerSGD state with fields {sorted(f)} (expected q/error)")
    dev = resolve_device(device)

    def leaf(a):
        return None if a is None else _f32(np.asarray(a), dev)

    return compression.PowerSGDState(q=compression.tree_map(leaf, f["q"]),
                                     error=compression.tree_map(leaf, f["error"]))


def epoch_counter(t: Union[int, np.ndarray, Any]) -> int:
    """The epoch counter (the JAX carry's 0-d int32 ``t``) as a host int."""
    return int(np.asarray(t))
