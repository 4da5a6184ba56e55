"""Prefill and serve steps of the LM zoo, the port's counterpart of
``repro.launch.steps``. The train step and the sharding specs are not
ported yet.
"""
from __future__ import annotations

from ..models import lm
from ..models.config import ModelConfig
from ..specs import NotYetPorted


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last-position logits (B, V), cache)``:
    the forward over the prompt computes every position's logits and keeps
    the last, as the reference does (copied, so the full-sequence logits are
    freed on return). An encoder-only config (audio) has no cache and is
    not ported."""
    lm.check_family(cfg)
    if cfg.encoder_only:
        raise NotYetPorted(f"{cfg.name}: the encoder-only step (audio) is not yet ported")

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
