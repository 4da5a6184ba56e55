"""Train, prefill and serve steps of the LM zoo, the port's counterpart of
``repro.launch.steps``: prefill and serve for every family in
``models.lm.PORTED_FAMILIES`` (an encoder-only config's prefill is its
encoder step), training for ``models.lm.TRAINED_FAMILIES``. The sharding
specs (a mesh) are not ported yet.
"""
from __future__ import annotations

from ..models import lm
from ..models.config import ModelConfig
from ..optim import adamw, schedule


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
