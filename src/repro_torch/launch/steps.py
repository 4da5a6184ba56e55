"""Train, prefill and serve steps of the LM zoo, the port's counterpart of
``repro.launch.steps``: prefill and serve for every family in
``models.lm.PORTED_FAMILIES`` (an encoder-only config's prefill is its
encoder step), training for ``models.lm.TRAINED_FAMILIES``; and the specs
of their non-parameter inputs and outputs under the active mesh
(``batch_pspecs``, ``logits_pspec``, ``cache_pspecs``,
``train_state_specs``). Under a mesh the steps run on each worker's blocks
(``models.lm``); ``local_cache`` cuts a full decode cache to a worker's
block.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import lm
from ..models.config import ModelConfig, ShapeSpec
from ..optim import adamw, schedule
from .params import local_block, param_pspecs
from .sharding import Spec, active_mesh, axes_size, data_axes, pspec, spec_axes


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients by autograd through
    ``lm.loss_fn``, the learning rate of ``schedule.cosine_with_warmup`` at
    the optimizer's step, then ``adamw.update``, which updates ``params`` and
    the state's moments IN PLACE (the returned params are the dict passed
    in). Metrics ``loss``, ``ce``, ``aux`` and ``lr`` stay on the device.
    Only the families in ``lm.TRAINED_FAMILIES``."""
    lm.check_trains(cfg)

    def train_step(params, opt_state: adamw.AdamWState, batch):
        (loss, metrics), grads = lm.value_and_grad(params, batch, cfg)
        lr = schedule.cosine_with_warmup(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                                         total=total_steps)
        params, opt_state = adamw.update(grads, opt_state, params, lr=lr)
        return params, opt_state, dict(metrics, loss=loss, lr=lr)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last-position logits (B, V), cache)``:
    the forward over the prompt computes every position's logits and keeps
    the last, as the reference does (copied, so the full-sequence logits are
    freed on return). An encoder-only config (audio) has no cache: its step
    is ``encode_step(params, batch) -> (every position's logits (B, S, V),
    None)``, the bidirectional forward in "train" mode, as the reference's."""
    lm.check_family(cfg)
    if cfg.encoder_only:
        def encode_step(params, batch):
            return lm.forward(params, batch, cfg, mode="train")["logits"], None

        return encode_step

    def prefill_step(params, batch):
        out = lm.forward(params, batch, cfg, mode="prefill")
        return out["logits"][:, -1, :].clone(), out["cache"]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, batch) -> (logits (B, 1, V), cache)``, one
    decode step; ``batch["cache_pos"]`` is a 0-d integer tensor on the
    step's device (or an int), the cache is updated in place and nothing is
    read back to the host (``lm.decode_step``), so ``launch.serve.generate``
    captures the step into a CUDA graph, the counterpart of
    ``jax.jit(make_serve_step(cfg))``."""
    lm.check_family(cfg)

    def serve_step(params, cache, batch):
        return lm.decode_step(params, cache, batch, cfg)

    return serve_step


# ---------------------------------------------------------------------------
# Specs of the non-parameter inputs and outputs
# ---------------------------------------------------------------------------


def input_names(cfg: ModelConfig, shape: ShapeSpec):
    """The names of a step's batch entries (the reference's
    ``models.config.input_specs`` keys)."""
    if shape.kind == "decode":
        return ["tokens", "cache_pos"] + (["positions"] if cfg.family == "vlm" else [])
    if cfg.family == "audio":
        return ["frames", "labels"] if shape.kind == "train" else ["frames"]
    names = ["tokens", "labels"] if shape.kind == "train" else ["tokens"]
    if cfg.family == "vlm":
        names += ["vision_embeds", "positions"]
    return names


def _batch_axis(shape: ShapeSpec):
    mesh = active_mesh()
    n = 1
    for a in data_axes():
        n *= mesh.shape[a] if mesh else 1
    return "batch" if shape.global_batch % max(n, 1) == 0 else None


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """Specs of a step's batch entries (call inside ``use_mesh``). A global
    batch the data axes do not divide (batch-1 decode) is replicated; the
    cache's sequence split takes over (``cache_pspecs``)."""
    b_axis = _batch_axis(shape)
    table = {"tokens": (b_axis, None), "labels": (b_axis, None),
             "frames": (b_axis, None, None), "vision_embeds": (b_axis, None, "embed"),
             "positions": (b_axis, None, None), "cache_pos": ()}
    return {name: pspec(*table[name]) for name in input_names(cfg, shape)}


def logits_pspec(cfg: ModelConfig, shape: ShapeSpec, *, full_seq: bool = False) -> Spec:
    """Spec of the output logits, batch- and vocab-divisibility aware."""
    b_axis = _batch_axis(shape)
    v_axis = "vocab" if cfg.vocab_size % max(axes_size("vocab"), 1) == 0 else None
    if full_seq:
        return pspec(b_axis, None, v_axis)
    return pspec(b_axis, v_axis)


def cache_pspecs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """Decode-cache specs. Global batch 1 (long context): the kv cache's
    sequence dim over the data axes ("seq"; the attention combines the
    shards' partial softmaxes); else its batch dim. The kv-head dim only
    where the model axis divides it; else the batch>1 cache's sequence dim
    goes over the model axis ("seq_tp"), so the cache still spreads over
    every worker."""
    seq_sharded = shape.global_batch == 1
    b = None if seq_sharded else "batch"
    kv_div = cfg.num_kv_heads % max(axes_size("kv_heads"), 1) == 0
    kv_h = "kv_heads" if kv_div else None
    kv_s = "seq" if seq_sharded else (None if kv_div else "seq_tp")
    table = {
        "k": (None, b, kv_h, kv_s, None),  # (L, B, Hkv, S, Dh)
        "v": (None, b, kv_h, kv_s, None),
        "mamba_h": (None, b, "heads", None, None),  # (L, B, nh, hd, N)
        "mamba_conv": (None, b, None, "mlp"),  # (L, B, K-1, conv_dim)
        "s": (None, b, "heads", None, None),  # (L, B, H, dk, dv)
        "x_tm": (None, b, None),  # (L, B, D)
        "x_cm": (None, b, None),
    }
    return {name: pspec(*table[name]) for name in lm.cache_specs(cfg, 1, 8)}


def local_cache(cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """This worker's block of a full decode cache of ``shape`` (call inside
    ``use_mesh``; the cache itself without a mesh). A dim that its axes do
    not divide stays whole, as ``params.leaf_spec`` leaves such a parameter
    dim (RWKV-6 heads the model axis does not divide: every model shard
    runs them all)."""
    mesh = active_mesh()
    if mesh is None:
        return cache
    specs = cache_pspecs(cfg, shape)

    def divisible(spec, t):
        return tuple(e if t.shape[i] % mesh.axes_size(spec_axes(e)) == 0 else None
                     for i, e in enumerate(spec))

    return {k: local_block(v, divisible(specs[k], v), mesh) for k, v in cache.items()}


def train_state_specs(cfg: ModelConfig):
    """(abstract params, abstract AdamW state, param specs, state specs)
    under the active mesh; the abstract trees hold meta tensors."""
    aparams = lm.init_params(cfg, device="meta")
    pspecs = param_pspecs(aparams)
    aopt = adamw.init(aparams)
    return aparams, aopt, pspecs, adamw.AdamWState(step=(), m=pspecs, v=pspecs)
