"""Hybrid optimizer: AdamW on the backbone, DFW-Trace on the head, the
port's counterpart of ``repro.optim.hybrid``.

The paper's technique as a training-loop feature: the unembedding head W
(d_model x vocab) takes Frank-Wolfe steps inside the trace-norm ball
||W||_* <= mu, while every other parameter takes AdamW. One step:

- the loss and every gradient by autograd through ``models.lm.loss_fn``;
- the head's gradient in f32, and the LMO from ``power_iters`` two-sided
  power iterations on it (``core.power_method.power_method_dense``: the
  ``power_matvec`` kernels' ``matvec`` and ``rmatvec`` on the card) from a
  start vector v0;
- gamma = 2 / (t + 2) and W <- (1 - gamma) W - gamma mu u v^T, one
  ``rank1_update`` launch IN PLACE (its bf16 route for a bf16 head): f32
  arithmetic, rounded once to the head's dtype, as the reference computes;
- AdamW on every other leaf, in place (``optim.adamw``). The head's
  gradient goes to AdamW as None, which leaves the head, its m and its v as
  they are: the reference zeroes it, so its m and v stay zero and its AdamW
  result is thrown away, the same state.

The start vector is a seam: ``train_step(params, state, batch, key)``
takes ``key`` as an int seed or a ``repro_torch.V0Stream``, and v0 is the
stream's vector for FW step t, the counterpart of the reference's
``sphere_vector(fold_in(key, fw_step), V)``: a free run draws it from a
``torch.Generator`` seeded by (seed, t), and the tests inject the
reference's vectors with ``V0Stream.from_table``. The FW step counter
``fw_step`` is a host int, since it picks the draw.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from .. import as_v0_stream
from ..core.power_method import power_method_dense
from ..kernels.rank1_update import ops as r1_ops
from . import adamw, schedule

PyTree = Any


class HybridState(NamedTuple):
    adam: adamw.AdamWState  # over all params; the head's m and v stay zero
    fw_step: int  # FW epoch counter t


def init(params: PyTree) -> HybridState:
    return HybridState(adam=adamw.init(params), fw_step=0)


def make_hybrid_train_step(cfg, *, mu: float = 100.0, power_iters: int = 2,
                           peak_lr: float = 3e-4, warmup: int = 100, total_steps: int = 10_000,
                           head_key: str = "unembed"):
    """Returns ``train_step(params, state, batch, key) -> (params, state,
    metrics)`` for an untied head; ``params`` are updated in place. Metrics
    ``loss``, ``ce``, ``aux``, ``fw_gamma`` and ``fw_sigma`` stay on the
    device."""
    from ..models import lm

    lm.check_trains(cfg)
    if cfg.tie_embeddings:
        raise ValueError("hybrid DFW head requires an untied unembedding")

    def train_step(params: Dict, state: HybridState, batch, key):
        (loss, metrics), grads = lm.value_and_grad(params, batch, cfg)
        head = params[head_key]
        g_head = grads[head_key].float()  # (d, V)
        grads[head_key] = None  # frees the head's own-dtype gradient

        # DFW-Trace step on the head
        t = state.fw_step
        v0 = as_v0_stream(key)(t, g_head.shape[1], head.device)
        res = power_method_dense(g_head, v0, power_iters)
        del g_head
        gamma = np.float32(2.0) / (np.float32(t) + np.float32(2.0))  # f32, as the reference
        with torch.no_grad():
            r1_ops.rank1_update(head, res.u, res.v, float(np.float32(1.0) - gamma),
                                -float(gamma * np.float32(mu)), out=head)

        # AdamW on everything else
        lr = schedule.cosine_with_warmup(state.adam.step, peak_lr=peak_lr, warmup=warmup,
                                         total=total_steps)
        params, adam = adamw.update(grads, state.adam, params, lr=lr)
        metrics = dict(metrics, loss=loss, fw_sigma=res.sigma, fw_gamma=torch.full(
            (), float(gamma), dtype=torch.float32, device=head.device))
        return params, HybridState(adam=adam, fw_step=t + 1), metrics

    return train_step
