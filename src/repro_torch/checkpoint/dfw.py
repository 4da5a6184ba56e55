"""DFW-Trace run checkpoints: the payload of one step, in the JAX package's
format 3, leaf for leaf.

One checkpoint step is one segment boundary (step id = epochs run, t). Its
leaves, in this order, with the JAX package's paths, shapes and dtypes::

    carry/state/<field>      the task state's tensor fields in declaration
                             order (MTLS x, y, r; logistic x, y as int32, z;
                             MC rows, cols, vals, resid, weight)
    carry/iterate/<key>      low_rank.pack_live: alpha, count, s, u, v
                             (the live-rank prefix only; node 0's iterate
                             on a gossip graph, as in the reference)
    carry/comm_state/<key>   the reducer's state in key order: none for
                             dense and int8; top-k's residuals u, v, (d,)
                             and (m,) from one process, (N, d) and (N, m)
                             from a run of N workers (worker 0 writes what
                             it all-gathers)
    carry/t                  int32 epoch counter
    carry/key                (2,) uint32: the run's seed in the layout of
                             jax.random.PRNGKey(seed)
    carry/probe              the block solver's (m, k) f32 warm-start probe
                             (replicated); no leaf for rank1
    history/<key>            gamma, gap (f64), k (int32), loss, sigma (f64)
    masks                    (0, 0) float32: one worker, no straggler masks

The JAX package's readers map leaves by this order (``restore_run``) or by
path (``read_iterate_packed``), so a port checkpoint is read there and a
JAX checkpoint is read here. The MC state's row and column entry orders and
the residual's copies in them are derived from its other fields and are not
written: ``init_state`` and ``convert.task_state`` rebuild them. The
manifest's ``extra`` is the run configuration; it carries ``torch_version``
where the JAX package writes ``jax_version``, and ``solver``, from which the
JAX package's ``restore_run`` sizes the reducer state (d k and m k for
"block:k") and expects the probe leaf.

Serving reads only the iterate (``read_iterate_packed``). ``RunSnapshot``
and ``restore_run`` (resume) come with the resume path.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core import low_rank
from .store import CheckpointStore, read_leaves, read_manifest

PAYLOAD_FORMAT = 3
READABLE_FORMATS = (1, 2, 3)
HISTORY_KEYS = ("loss", "gap", "sigma", "gamma", "k")

# Manifest-extra fields the JAX package's restore_run needs to rebuild its
# payload skeleton; a checkpointer without them is refused at construction.
REQUIRED_EXTRA = ("task", "d", "m", "num_workers", "comm")

Source = Union[CheckpointStore, str, Path]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s threefry layout: the high and low 32
    bits of the seed, uint32."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _state_leaves(state) -> Dict[str, torch.Tensor]:
    """The state's tensor fields in declaration order, less those derived
    from the others (``DERIVED``: the MC state's entry orders and residual
    copies); int64 labels are written as the JAX package's int32."""
    out = {}
    derived = getattr(state, "DERIVED", ())
    for name, val in zip(state._fields, state):
        if isinstance(val, torch.Tensor) and name not in derived:
            out[name] = val.to(torch.int32) if val.dtype == torch.int64 else val
    return out


def _history_arrays(history: Dict[str, list]) -> Dict[str, np.ndarray]:
    return {
        k: np.asarray(history.get(k, []), np.int32 if k == "k" else np.float64)
        for k in HISTORY_KEYS
    }


def payload(carry, history: Dict[str, list], masks=None) -> Dict[str, object]:
    """The ordered leaves of one checkpoint step (see the module doc)."""
    if carry.comm_state != () and not isinstance(carry.comm_state, dict):
        raise TypeError(f"reducer state must be () or a dict of tensors, got "
                        f"{type(carry.comm_state).__name__}")
    leaves: Dict[str, object] = {}
    for name, val in _state_leaves(carry.state).items():
        leaves[f"carry/state/{name}"] = val
    packed = low_rank.pack_live(carry.iterate)
    for key in low_rank.PACKED_KEYS:
        leaves[f"carry/iterate/{key}"] = packed[key]
    for key in sorted(carry.comm_state or {}):
        leaves[f"carry/comm_state/{key}"] = carry.comm_state[key]
    leaves["carry/t"] = np.asarray(carry.t, np.int32)
    leaves["carry/key"] = prng_key(carry.key.seed)
    if isinstance(carry.probe, torch.Tensor):
        leaves["carry/probe"] = carry.probe
    hist = _history_arrays(history)
    for key in sorted(HISTORY_KEYS):
        leaves[f"history/{key}"] = hist[key]
    leaves["masks"] = (np.zeros((0, 0), np.float32) if masks is None
                       else np.asarray(masks, np.float32))
    return leaves


def wants_save(boundary_index: int, last: bool, save_every: int) -> bool:
    """The save policy: every ``save_every``-th segment boundary, and the last."""
    return last or (boundary_index + 1) % save_every == 0


class RunCheckpointer:
    """When to save and what: the engine asks ``want(boundary_index, last)``
    at every segment boundary and, on yes, hands the carry, the history so
    far and the masks to ``save_segment``, which issues one
    ``CheckpointStore.save_async`` (the carry's leaves are copied to the host
    there, the write runs behind the next segment). ``save_every`` saves
    every Nth boundary; the last (or early-stop) boundary is always saved.
    ``extra`` is the run configuration (``run_extra``)."""

    def __init__(self, store: Source, *, save_every: int = 1,
                 keep_last: Optional[int] = 2, extra: Optional[dict] = None):
        if save_every < 1:
            raise ValueError(f"save_every={save_every}: must be >= 1")
        if not isinstance(store, CheckpointStore):
            store = CheckpointStore(store, keep_last=keep_last)
        self.store = store
        self.save_every = save_every
        self.extra = dict(extra or {})
        missing = [k for k in REQUIRED_EXTRA if k not in self.extra]
        if missing:
            raise ValueError(
                f"RunCheckpointer extra is missing {missing}: the JAX package's "
                "restore_run needs these to rebuild the payload skeleton; build "
                "extra with checkpoint.dfw.run_extra(task, ...)"
            )

    def want(self, boundary_index: int, last: bool) -> bool:
        return wants_save(boundary_index, last, self.save_every)

    def save_segment(self, *, t: int, carry, history: Dict[str, list], masks,
                     done: bool) -> None:
        extra = {**self.extra, "payload_format": PAYLOAD_FORMAT, "t": int(t),
                 "done": bool(done)}
        self.store.save_async(int(t), payload(carry, history, masks), extra=extra)

    def wait(self) -> None:
        self.store.wait()


def run_extra(task, *, num_workers: int, comm: str, num_epochs: int, schedule: str,
              mu: float, step_size: str, **more) -> dict:
    """The run-configuration record stamped into every manifest."""
    return {
        "task": type(task).__name__,
        "d": int(task.d),
        "m": int(task.m),
        "num_workers": int(num_workers),
        "comm": comm,
        "num_epochs": int(num_epochs),
        "schedule": schedule,
        "mu": float(mu),
        "step_size": step_size,
        "torch_version": torch.__version__,
        **more,
    }


def _directory(source: Source) -> Path:
    return source.dir if isinstance(source, CheckpointStore) else Path(source)


def read_run_extra(source: Source, step: Optional[int] = None) -> tuple:
    """(step, extra) of a checkpoint (default: its latest step), without
    loading any array."""
    manifest = read_manifest(_directory(source), step)
    return manifest["step"], manifest.get("extra", {})


def read_iterate_packed(source: Source, step: Optional[int] = None) -> tuple:
    """(step, packed iterate, extra): only the ``carry/iterate/*`` leaves of
    a run checkpoint (default: its latest step), the serving path's read.
    The dict is ``low_rank.pack_live`` output (numpy); re-pad it with
    ``low_rank.unpack_live``. Task state and history are never loaded."""
    step, leaves, extra = read_leaves(_directory(source), step, prefix="carry/iterate/")
    fmt = extra.get("payload_format", -1)
    if fmt not in READABLE_FORMATS:
        raise ValueError(
            f"checkpoint step {step} has payload format {fmt}; this build reads "
            f"{READABLE_FORMATS}"
        )
    packed = {path[len("carry/iterate/"):]: arr for path, arr in leaves.items()}
    missing = [k for k in low_rank.PACKED_KEYS if k not in packed]
    if missing:
        raise ValueError(
            f"checkpoint step {step} under {_directory(source)} has no packed iterate "
            f"leaves {missing} (paths {sorted(packed)}); was it written by "
            "RunCheckpointer.save_segment?"
        )
    return step, packed, extra
