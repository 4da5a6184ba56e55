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

Serving reads only the iterate (``read_iterate_packed``). A resume reads
the whole step (``restore_run``) into a host-side ``RunSnapshot``, leaf by
path; ``launch.dfw``'s ``fit_serial`` and ``fit`` rebuild the run from it.

**The run key.** ``carry/key`` holds the run's seed, and a seed is all the
port's randomness needs: the start vectors, the block solver's fresh
columns and the int8 noise are stateless functions of (seed, t)
(``repro_torch.V0Stream``, ``NoiseStream``). So ``RunSnapshot.seed``, the
key's high word shifted over its low word, continues a port run bit for
bit. A key the JAX package wrote decodes the same way (``PRNGKey(seed)``
holds the seed's two words), but the port then continues with its own
draws from that seed, not JAX's; a caller who wants JAX's hands them in
through ``V0Stream.from_table``, whose table is indexed by absolute epoch
and is kept across the resume (``fit_serial`` and ``fit`` do not replace a
table-fed key).
A table-fed run writes seed 0, so a table made from the JAX package's
``PRNGKey(0)`` gives a checkpoint that the JAX package resumes with its own
draws.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core import low_rank
from ..specs import parse_solver
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


def seed_of(key) -> int:
    """The seed of a ``carry/key`` leaf: the inverse of :func:`prng_key`."""
    words = np.asarray(key).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"carry/key has shape {np.asarray(key).shape}; expected (2,) uint32")
    return (int(words[0]) << 32) | int(words[1])


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
    ``extra`` is the run configuration (``run_extra``); ``telemetry`` (an
    ``obs.Telemetry``) goes to the store it opens."""

    def __init__(self, store: Source, *, save_every: int = 1,
                 keep_last: Optional[int] = 2, extra: Optional[dict] = None,
                 telemetry=None):
        if save_every < 1:
            raise ValueError(f"save_every={save_every}: must be >= 1")
        if not isinstance(store, CheckpointStore):
            store = CheckpointStore(store, keep_last=keep_last, telemetry=telemetry)
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


def _history_lists(arrays: Dict[str, np.ndarray]) -> Dict[str, list]:
    return {k: [int(v) for v in arrays[k]] if k == "k" else [float(v) for v in arrays[k]]
            for k in HISTORY_KEYS}


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


@dataclasses.dataclass
class RunSnapshot:
    """A run checkpoint step on the host (numpy leaves).

    ``t`` is the resume epoch (epochs run, the length of every ``history``
    list). ``state`` holds the task state's saved fields in declaration
    order (MTLS x, y, r; logistic x, y (int32, as written), z; MC rows,
    cols, vals, resid, weight, worker j's shard at ``[j p, (j+1) p)`` after
    a run of N workers); ``convert.task_state`` builds the port's state from
    them, derived fields included. ``iterate`` is the ``pack_live`` dict;
    ``comm_state`` the reducer's (``()``, or top-k's ``{"u", "v"}``, with a
    leading worker axis after a run of N workers); ``probe`` the block
    solver's (m, k) warm start, ``()`` where the step has none; ``seed`` the
    run key's seed (module doc); ``masks`` the (num_epochs, N) worker
    weights, None where the step saved none; ``extra`` the manifest's run
    record."""

    t: int
    state: Dict[str, np.ndarray]
    iterate: Dict[str, np.ndarray]
    comm_state: object
    probe: object
    seed: int
    history: Dict[str, list]
    masks: Optional[np.ndarray]
    extra: dict

    @property
    def done(self) -> bool:
        """Did the run stop on its gap certificate (or end) at this step?"""
        return bool(self.extra.get("done", False))

    def unpack_iterate(self, max_rank: int, device) -> low_rank.FactoredIterate:
        """The iterate on ``device`` in a store of ``max_rank`` factors."""
        return low_rank.unpack_live(self.iterate, max_rank, device=device)


def restore_run(source: Source, *, task, step: Optional[int] = None) -> RunSnapshot:
    """Read checkpoint step ``step`` (default: the latest) of a run of
    ``task``, every leaf by its path, into a :class:`RunSnapshot`.

    Payload formats 1 to 3 are read (a port or a JAX package checkpoint).
    The probe is ``()`` for a format-1 step (it has none) and for a probe
    of another shape than (task.m, k) of the saved solver; a resume then
    cold-starts it, as the JAX package does. Whether the snapshot belongs
    to ``task``'s problem is the caller's check (its task name, d and m in
    ``extra``)."""
    step, leaves, extra = read_leaves(_directory(source), step)
    fmt = extra.get("payload_format", -1)
    if fmt not in READABLE_FORMATS:
        raise ValueError(
            f"checkpoint step {step} has payload format {fmt}; this build reads "
            f"{READABLE_FORMATS}"
        )

    def under(prefix: str) -> Dict[str, np.ndarray]:
        return {path[len(prefix):]: arr for path, arr in leaves.items()
                if path.startswith(prefix)}

    iterate = under("carry/iterate/")
    missing = [k for k in low_rank.PACKED_KEYS if k not in iterate]
    if missing or "carry/key" not in leaves:
        raise ValueError(f"checkpoint step {step} under {_directory(source)} is no run "
                         f"checkpoint: it lacks {missing or ['carry/key']}")
    solver = parse_solver(extra.get("solver", "rank1"))
    probe = leaves.get("carry/probe", ())
    if fmt < 2 or solver.kind != "block" or np.shape(probe) != (int(task.m), solver.k):
        probe = ()
    masks = leaves.get("masks")
    return RunSnapshot(
        t=int(extra.get("t", leaves.get("carry/t", -1))),
        state=under("carry/state/"),
        iterate=iterate,
        comm_state=under("carry/comm_state/") or (),
        probe=probe,
        seed=seed_of(leaves["carry/key"]),
        history=_history_lists(under("history/")),
        masks=None if masks is None or masks.size == 0 else masks,
        extra=extra,
    )
