"""Deterministic, resumable, host-sharded synthetic data pipeline, the
port's counterpart of ``repro.data.pipeline``.

``SyntheticLMStream.batch_for_step(step)`` is a pure function of (seed,
step, host_id/num_hosts): a restart or a re-shard at any step reproduces
the exact stream, with no iterator state beyond the step counter. The
batches are numpy arrays made by this module's own copy of the reference's
generator, so they equal the reference's bit for bit for every family
branch, host and host count; ``device_put_batch`` moves one to the device
as torch tensors.

Under a mesh every worker makes the same global batch (a pure function of
the step, as above) and runs the rows of its data shard: ``shard_rows``
gives data shard i of n the contiguous block [i B/n, (i + 1) B/n) of every
batch entry, the block GSPMD gives data coordinate i of a batch-sharded
array.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..models.config import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 17
    # Markov-chain synthetic text: each token is the last plus a step in
    # 1..structure (mod vocab), so the model has structure to learn.
    structure: int = 8


class SyntheticLMStream:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, data_cfg: DataConfig = DataConfig(),
                 *, host_id: int = 0, num_hosts: int = 1):
        if shape.global_batch % num_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not split over "
                             f"{num_hosts} hosts")
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = shape.global_batch // num_hosts

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """This host's batch of ``step``: tokens and labels (int32), or
        frames (f32) for the audio family; the vlm family also gets vision
        embeddings and M-RoPE positions."""
        b, s, v = self.local_batch, self.shape.seq_len, self.cfg.vocab_size
        rng = np.random.default_rng((self.data_cfg.seed * 1_000_003 + step) * 4096 + self.host_id)
        if self.cfg.family == "audio":
            frames = rng.standard_normal((b, s, self.cfg.frontend_dim), np.float32)
            labels = rng.integers(0, v, (b, s)).astype(np.int32)
            return {"frames": frames, "labels": labels}

        start = rng.integers(0, v, (b, 1))
        steps = rng.integers(0, self.data_cfg.structure, (b, s)) + 1
        toks = ((np.cumsum(steps, axis=1) + start) % v).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        batch = {"tokens": toks, "labels": labels}
        if self.cfg.family == "vlm":
            sv = self.cfg.vision_tokens
            batch["tokens"] = toks[:, : s - sv]
            batch["vision_embeds"] = rng.standard_normal((b, sv, self.cfg.d_model), np.float32)
            pos = np.broadcast_to(np.arange(s)[None, None, :], (b, 3, s))
            batch["positions"] = np.ascontiguousarray(pos, np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_for_step(step)
            step += 1


def shard_rows(batch: Dict[str, object], index: int, count: int) -> Dict[str, object]:
    """Rows [index B/count, (index + 1) B/count) of each batch entry whose
    leading dim is the batch B (numpy arrays or tensors; a 0-d entry such as
    ``cache_pos`` is kept). B must divide by ``count``."""
    key = "tokens" if "tokens" in batch else "frames"
    b = batch[key].shape[0]
    if b % count:
        raise ValueError(f"a batch of {b} does not split over {count} data shards")
    n = b // count
    return {k: (v[index * n:(index + 1) * n]
                if getattr(v, "ndim", 0) >= 1 and v.shape[0] == b else v)
            for k, v in batch.items()}


def device_put_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None
                     ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as torch tensors on ``device`` (default: the card),
    with their dtypes."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
