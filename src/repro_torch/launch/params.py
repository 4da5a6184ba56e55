"""Parameter specs by tree path, and the blocks each worker holds: the port's
counterpart of ``repro.launch.params``.

Logical layout (mapped to mesh axes by ``launch.sharding``'s rules):
  in-projections  (D_in, D_out_tp)  -> (fsdp, model)     Megatron column
  out-projections (D_in_tp, D_out)  -> (model, fsdp)     Megatron row
  embedding       (V, D)            -> (vocab, fsdp)
  unembedding     (D, V)            -> (fsdp, vocab)
  MoE experts     (E, D, F)/(E, F, D) -> (expert, fsdp, None)  EP x ZeRO-3
  biases          (D_out_tp,)       -> (model,)
  norms / scalars / small tables    -> replicated

The port keeps a model's layers as a list of per-layer dicts, not as leaves
stacked on a leading dim, so a layer leaf's spec is the reference's spec
of the stacked leaf without its leading None (a replicated leaf's spec is
``()`` in both). A spec is a tuple (``launch.sharding``).

A worker holds, of each leaf, the block at its mesh coordinates: along a
dim sharded over axes (a1, a2, ...), block ``mesh.index((a1, a2, ...))`` of
``mesh.axes_size(...)`` equal blocks, as GSPMD tiles an array.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from .sharding import Spec, axes_size, pspec, spec_axes

_RULES: Dict[str, Tuple] = {
    # attention / generic in-projections (column-parallel)
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wg": ("fsdp", "mlp"),
    "wu": ("fsdp", "mlp"),
    "w1": ("fsdp", "mlp"),
    "wr": ("fsdp", "mlp"),
    "ck": ("fsdp", "mlp"),
    "cr": ("fsdp", "mlp"),
    "w_in": ("fsdp", "mlp"),
    "w_lora_a": ("fsdp", None),
    # out-projections (row-parallel)
    "wo": ("heads", "fsdp"),
    "wd": ("mlp", "fsdp"),
    "w2": ("mlp", "fsdp"),
    "cv": ("mlp", "fsdp"),
    "w_out": ("mlp", "fsdp"),
    "w_lora_b": (None, "fsdp"),
    # embeddings
    "embed": ("vocab", "fsdp_embed"),
    "unembed": ("fsdp_embed", "vocab"),
    "frame_proj": (None, "fsdp_embed"),
    # biases
    "bq": ("heads",),
    "bk": ("kv_heads",),
    "bv": ("kv_heads",),
    # mamba conv (channel dim model-sharded)
    "conv_w": (None, "mlp"),
    "conv_b": ("mlp",),
}

# MoE expert tensors (E, D, F) or (E, F, D): dim 0 expert-parallel, dim 1
# gathered (ZeRO-3) inside the expert-parallel block.
_MOE_RULES: Dict[str, Tuple] = {
    "wg": ("expert", "fsdp", None),
    "wu": ("expert", "fsdp", None),
    "wd": ("expert", "fsdp", None),
    "router": (None, None),
}


def leaf_spec(names: Sequence[str], shape: Sequence[int]) -> Spec:
    """The spec of the leaf at dict-key path ``names`` (list indices left
    out) of full shape ``shape``, under the active mesh and rules. A dim
    that its axes do not divide is left replicated (hubert's 504-way
    vocab)."""
    leaf_name = names[-1]
    in_moe = "moe" in names[:-1]
    rules = _MOE_RULES if in_moe and leaf_name in _MOE_RULES else _RULES
    trailing = rules.get(leaf_name)
    if trailing is None:
        return ()
    pad = len(shape) - len(trailing)
    if pad < 0:
        return ()
    logical = [None] * pad + list(trailing)
    for i, name in enumerate(logical):
        if name is not None and shape[i] % max(axes_size(name), 1) != 0:
            logical[i] = None
    return pspec(*logical)


def param_pspecs(params: Any, names: Tuple[str, ...] = ()) -> Any:
    """The spec tree of ``params`` (dicts and lists of full-shape tensors,
    meta tensors included), under the active mesh and rules (call inside
    ``use_mesh``); ``names`` is the path's dict keys so far."""
    if isinstance(params, dict):
        return {k: param_pspecs(v, names + (k,)) for k, v in params.items()}
    if isinstance(params, list):
        return [param_pspecs(v, names) for v in params]
    return leaf_spec(names, tuple(params.shape))


def local_block(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This worker's block of ``full`` under ``spec``: a new contiguous
    tensor (blocks are updated in place: AdamW, a decode cache)."""
    out = full
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        count = mesh.axes_size(axes) if axes else 1
        if count > 1:
            if out.shape[dim] % count:
                raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over the "
                                 f"{count} workers of {axes}")
            n = out.shape[dim] // count
            out = out.narrow(dim, mesh.index(axes) * n, n)
    return out.clone(memory_format=torch.contiguous_format)


def gather_block(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from every worker's block (forward-only tiled
    all-gathers over each sharded dim's group)."""
    out = local
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        group = mesh.group_of(axes) if axes else None
        if group is not None:
            out = group.all_gather(out, dim)
    return out


def shard_params(full: Any, mesh, specs: Any = None) -> Any:
    """Each leaf of ``full`` cut to this worker's block (specs: ``specs``,
    or ``param_pspecs(full)`` under the active context)."""
    specs = param_pspecs(full) if specs is None else specs
    return map_specs(lambda leaf, spec: local_block(leaf, spec, mesh), full, specs)


def gather_params(local: Any, mesh, specs: Any) -> Any:
    """The full leaves from every worker's blocks (every worker calls it)."""
    return map_specs(lambda leaf, spec: gather_block(leaf, spec, mesh), local, specs)


def map_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a parameter tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def unsharded_axes(spec: Spec, mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """The axes among ``axes`` (of more than one worker) that ``spec`` does
    not use: a leaf's gradient is a part on each worker along the data axes
    it is replicated over, and is summed over them after the backward."""
    used = {a for entry in spec for a in spec_axes(entry)}
    return tuple(a for a in axes if a not in used and mesh.shape[a] > 1)


def init_local_params(cfg, seed: int, mesh, *, device=None, specs: Any = None) -> Any:
    """This worker's blocks of ``models.lm.init_params(cfg, seed)``: every
    leaf drawn in the one-device order and cut as soon as it is drawn (a
    layer's dict, a moe layer's expert tensors one by one), so the blocks
    hold the one-device run's values and no worker holds the whole model.
    ``specs``: ``lm.param_specs(cfg)`` under the mesh and the active rules
    (computed if None)."""
    from ..models import lm
    from .sharding import active_rules, use_mesh

    with use_mesh(mesh, active_rules()):  # the caller's profile
        specs = lm.param_specs(cfg) if specs is None else specs

    def keep(tree, names):
        spec = specs
        for k in names:  # every layer has the first layer's specs
            spec = (spec[0] if isinstance(spec, list) else spec)[k]
        return shard_params(tree, mesh, spec[0] if isinstance(spec, list) else spec)

    return lm.init_params(cfg, seed, device=device, keep=keep)
