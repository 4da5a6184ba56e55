"""Logical-axis sharding rules and the mesh context of the LM zoo, the port's
counterpart of ``repro.launch.sharding``.

Models name tensor dims logically ("batch", "heads", "vocab", ...); the
active rule set maps the names to mesh axes. A spec is a plain tuple with
one entry per dim: None (replicated), an axis name, or a tuple of axis
names, the reference's ``PartitionSpec`` entries.

The port runs SPMD with local shards (``launch.params``, ``comm.spmd``):
each process holds its block of every tensor, so a layout annotation has
nothing to change and :func:`shard` returns its input. The layouts are
carried by the model code itself, which places an explicit collective where
the reference's annotations change a layout. Outside a mesh context every
rule resolves to replicated, as the reference's annotations do nothing
outside a mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# Logical dim -> mesh axes. "fsdp" axes also carry the batch (ZeRO-3 style).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "batch_tp": ("pod", "data", "model"),  # batch over ALL axes (attention
    # fallback when head counts don't divide the model axis)
    "fsdp": ("pod", "data"),  # weight dim sharded over the DP axes
    "fsdp_embed": ("pod", "data"),  # embed/unembed weight dim (never "model",
    # which already carries their vocab dim)
    "seq": "data",  # context/sequence parallelism (long-context decode)
    "seq_tp": "model",  # KV-cache seq dim when kv-heads don't divide TP
    "seq_act": None,  # activation seq dim between blocks (SP profile: model)
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "embed": None,  # d_model dim of activations: replicated
    "state": None,
}

# Sharding profiles. "tp" = Megatron tensor parallelism on the model axis
# (default). "sp" = sequence parallelism: activations sharded on the
# sequence dim over the model axis, both between the blocks and inside them,
# heads and MLP columns on no axis, parameters ZeRO-3 sharded over every
# axis. "msp" = Megatron-style SP: TP inside blocks, a sequence-sharded
# residual stream between them. The port runs all three
# (``models.parallel``: the layout changes GSPMD inserts are explicit
# collectives there).
PROFILES: Dict[str, Dict[str, Axis]] = {
    "tp": {},
    "sp": {
        "heads": None,
        "kv_heads": None,
        "mlp": None,
        "seq_act": "model",
        "fsdp": ("pod", "data", "model"),
    },
    "msp": {"seq_act": "model"},
}


def rules_for(profile: str) -> Dict[str, Axis]:
    rules = dict(DEFAULT_RULES)
    rules.update(PROFILES[profile])
    return rules


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Axis] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axis]] = None):
    """Make ``mesh`` (a ``launch.mesh.Mesh``, or None) and the default rules
    updated by ``rules`` the active context of this thread."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.mesh, _CTX.rules = mesh, merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def active_mesh():
    return _CTX.mesh


def active_rules() -> Dict[str, Axis]:
    """This thread's rules (a copy)."""
    return dict(_CTX.rules)


@contextlib.contextmanager
def whole_sequence():
    """The active mesh and rules with "seq_act" on no axis: a step of one
    token holds it whole on every model shard (the reference's GSPMD pads
    that dim instead). Nothing else resolves otherwise: no parameter or
    cache spec names "seq_act"."""
    if _CTX.rules.get("seq_act") is None:
        yield
        return
    with use_mesh(_CTX.mesh, {**_CTX.rules, "seq_act": None}):
        yield


def context_key():
    """A hashable key of this thread's context: the mesh's layout (shape,
    axis names; None without a mesh) and the rules. Specs depend on nothing
    else."""
    mesh = _CTX.mesh
    layout = None if mesh is None else (mesh.devices_shape, mesh.axis_names)
    return layout, tuple(sorted(_CTX.rules.items()))


def in_context(fn):
    """``fn`` bound to this thread's mesh and rules as they are now: each
    call runs under them, whatever thread calls it (autograd recomputes a
    checkpointed layer in its device thread, where this thread's context
    is not set). Without a mesh, ``fn`` itself."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)

    return run


def _resolve(logical: Sequence[Optional[str]]) -> Spec:
    """A mesh axis appears at most once in a spec: where two logical dims
    map to one axis (msp: heads AND seq_act -> model) the EARLIER dim keeps
    it and the later resolves without it. Axes absent from the mesh drop."""
    axes_in_mesh = set(_CTX.mesh.axis_names) if _CTX.mesh is not None else set()
    out = []
    used: set = set()
    for name in logical:
        ax = _CTX.rules.get(name) if name else None
        if ax is None:
            out.append(None)
            continue
        if isinstance(ax, str):
            ax = (ax,)
        ax = tuple(a for a in ax if a in axes_in_mesh and a not in used)
        used.update(ax)
        out.append(ax if len(ax) > 1 else (ax[0] if ax else None))
    return tuple(out)


def pspec(*logical: Optional[str]) -> Spec:
    """The spec of the given logical dims under the active mesh and rules."""
    return _resolve(logical)


def shard(x, *logical: Optional[str]):
    """``x`` unchanged. The reference constrains the layout here; a local
    shard already has its layout, and the collective a change of layout
    needs is written out where it happens (``comm.spmd``)."""
    return x


def _mesh_axes(logical: str) -> Tuple[str, ...]:
    ax = _CTX.rules.get(logical)
    if ax is None or _CTX.mesh is None:
        return ()
    if isinstance(ax, str):
        ax = (ax,)
    return tuple(a for a in ax if a in _CTX.mesh.axis_names)


def data_axes() -> Tuple[str, ...]:
    """Mesh axes carrying the batch."""
    return _mesh_axes("batch")


def axes_size(logical: str) -> int:
    """Product of the mesh-axis sizes a logical dim maps to (1 without a
    mesh)."""
    n = 1
    for a in _mesh_axes(logical):
        n *= _CTX.mesh.shape[a]
    return n


def seq_axes() -> Tuple[str, ...]:
    """Mesh axes carrying the sequence dim (context parallelism)."""
    return _mesh_axes("seq")


def seq_act_axes() -> Tuple[str, ...]:
    """Mesh axes carrying the activations' sequence dim (the "sp" and "msp"
    profiles: the model axis)."""
    return _mesh_axes("seq_act")


def model_axes() -> Tuple[str, ...]:
    return _mesh_axes("expert")


def head_axes() -> Tuple[str, ...]:
    """Mesh axes splitting the attention heads and the MLP columns (none
    under "sp")."""
    return _mesh_axes("heads")


def fsdp_axes() -> Tuple[str, ...]:
    """Mesh axes of a weight's FSDP dim ("sp": every axis)."""
    return _mesh_axes("fsdp")


def spec_axes(entry: Axis) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)
