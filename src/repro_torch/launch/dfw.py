"""DFW-Trace execution layer, the port's counterpart of ``repro.launch.dfw``.

Two drivers, for the three paper tasks, with solver ``rank1`` or
``block:k[:adapt][:cold]``, comm ``dense``, ``int8`` or ``topk:r`` and
topology ``flat``, ``ring``, ``gossip:k`` or ``hier:g`` (``comm.make_topology``;
a flat graph hands the bare reducer to the engine, the path without a
topology; gossip takes rank1 only):

- ``fit`` is the multi-worker run (paper Alg. 2): one process per worker
  over a ``torch.distributed`` process group (``comm.WorkerGroup``), each
  holding its row block of the data on its own device, the iterate, the
  scalars and the start vectors replicated, and every aggregate an
  all-reduce through ``comm``. ``worker_schedule`` draws the sampled-worker
  (straggler) weights. ``run_workers`` starts N such processes on one host.
- ``fit_serial`` runs one worker on one device (int8 at the full 127-level
  budget, or at a ``hier:g`` graph's 127 // g; gossip the identity), the
  serial baseline of the compressed runs and graphs.

``KernelizedTask`` routes the power method's matvecs through the
hand-written ``power_matvec`` kernels (dense tasks) and ``mc_matvec`` kernel
(matrix completion), their block forms (``matmat``/``rmatmat``,
``coo_matmat``) for the block solver's (m, k) and (d, k) blocks, and the
dense tasks' update goes through ``rank1_update`` (``rankk_update``);
``verify_kernelized`` (and, for int8,
``comm.verify_quantize_kernels``) holds the kernel route to the plain
versions before a run starts. ``shard_observations`` lays out matrix
completion entries as the JAX package does.

``DFWConfig(checkpoint_dir=...)`` makes a run write checkpoints in the JAX
package's layout and payload format (``repro_torch.checkpoint``), which the
serving engine and the JAX package's readers load; in a multi-worker run
worker 0 writes the whole state and the top-k residuals of every worker
(and the block solver's replicated probe). ``DFWConfig(resume_from=...,
resume_step=...)`` continues a run from such a step (the port's or the JAX
package's), as the reference's ``fit_serial`` and ``fit`` do:

- **Bit-exact.** On the same problem with the same worker count, topology
  and comm, the resumed run gives the uninterrupted run's history, final
  loss, iterate and probe bit for bit: the state, the iterate, the epoch
  counter, the run seed, every worker's reducer state, the probe and the
  sampled-worker weights are restored, and the start vectors and noise are
  functions of (seed, t) (``checkpoint.dfw``'s module doc).
- **Elastic.** On another worker count each worker takes its rows of the
  saved (global) state, the reducer state starts fresh and the
  sampled-worker weights are drawn again; the trajectory then agrees to
  the summation order.
- **Warm restart.** ``schedule``, ``comm``, ``num_epochs`` and ``gap_tol``
  may change at the resume point (a changed comm starts fresh reducer
  state); a step at which the budget is spent or whose gap certificate
  still stands under this config returns without running an epoch.

A gossip run's checkpoint holds node 0's iterate; every node resumes from
it. The run owns its checkpoint directory from the resume point: steps
after it are removed.

``DFWConfig(telemetry=obs.Telemetry())`` records the run (a ``run.start``
event, the engine's spans and samples, the checkpoint store's writes,
``checkpoint.join`` and ``engine.final_loss``; with the handle's
``profiler_dir``, a ``torch.profiler`` trace of the fit) without changing
a bit of it; export with ``telemetry.write_jsonl(path)`` /
``write_chrome_trace(path)`` after the run. In ``fit`` the handle records
the worker of the process that holds it: a handle cannot cross
``run_workers``' spawn, so each worker builds its own.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import DeviceLike, NoiseStream, V0Stream, _mix, as_v0_stream, convert, resolve_device
from ..checkpoint import dfw as ckpt
from ..comm import (Int8Reducer, WorkerGroup, destroy_groups, make_topology, psum,
                    verify_quantize_kernels)
from ..core import engine, frank_wolfe, low_rank, tasks
from ..core.frank_wolfe import EpochAux
from ..core.power_method import sphere_vector
from ..kernels.mc_matvec import ops as mc_ops
from ..kernels.power_matvec import ops as pm_ops
from ..obs import Telemetry
from ..specs import NotYetPorted, parse_comm, parse_solver, validate

PyTree = Any


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DFWConfig:
    """Knobs of one DFW-Trace run, with the JAX package's field names.

    The port runs the fields in the first group. ``sample_prob`` < 1 turns
    on the sampled-worker (straggler) mode of ``fit``, with survivors
    reweighted to N / alive under ``reweight``; ``data_axis`` names the
    worker axis in the reference and is accepted and unused here (the
    workers are the process group's ranks). ``gossip_rounds`` overrides a
    gossip graph's mixing rounds per exchange (None: sized from its
    spectral gap, ``comm.default_gossip_rounds``). ``resume_from`` (a
    checkpoint directory) and ``resume_step`` (default: its latest step)
    resume a run (the module doc). ``engine`` is the epoch engine's mode:
    "scan" (one dispatch a segment, a CUDA graph replay on the card) or
    "legacy" (one an epoch, four blocking pulls each, the equivalence
    oracle); see ``core/engine.py``. Every field of the second group
    belongs to the Pallas path, which has no counterpart here, and must keep
    its default; anything else raises ``NotYetPorted`` when the config is
    built. The port has no ``kernelize`` switch: the run always goes
    through ``KernelizedTask``, whose ops pick the kernel or the plain
    version by the tensors' device.

    ``telemetry`` (an ``obs.Telemetry``; None: the inert no-op) records the
    run (the module doc). A handle belongs to one process: it holds a lock
    and cannot be pickled into ``run_workers``' workers, so each worker of a
    multi-worker ``fit`` builds its own (``dataclasses.replace(cfg,
    telemetry=Telemetry())`` inside the worker), which records that
    worker's run, as the reference's handle records its one process.
    """

    mu: float
    num_epochs: int
    schedule: str = "const:2"
    step_size: str = "default"
    solver: str = "rank1"
    comm: str = "dense"
    topology: str = "flat"
    verify_kernels: bool = True
    max_rank: Optional[int] = None
    gap_tol: Optional[float] = None
    block_epochs: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    checkpoint_keep: Optional[int] = 2
    data_axis: str = "data"
    sample_prob: float = 1.0
    reweight: bool = True
    gossip_rounds: Optional[int] = None
    resume_from: Optional[str] = None
    resume_step: Optional[int] = None
    engine: str = "scan"
    telemetry: Optional[Any] = None  # obs.Telemetry (None: the no-op)
    # --- the Pallas path, not ported: must keep these defaults ---
    use_pallas: Optional[bool] = None
    interpret: bool = False

    def __post_init__(self):
        validate(solver=self.solver, comm=self.comm, topology=self.topology)
        frank_wolfe.k_schedule(self.schedule)
        if self.step_size not in ("default", "linesearch"):
            raise ValueError(f"step_size={self.step_size!r}")
        if not 0.0 < self.sample_prob <= 1.0:
            raise ValueError(f"sample_prob={self.sample_prob}: must lie in (0, 1]")
        if self.engine not in engine.MODES:
            raise ValueError(f"engine={self.engine!r}: expected 'scan' or 'legacy'")
        for f in dataclasses.fields(self):
            if f.name in _UNPORTED and getattr(self, f.name) != f.default:
                raise NotYetPorted(
                    f"DFWConfig.{f.name}={getattr(self, f.name)!r}: {_UNPORTED[f.name]} "
                    "is not yet ported to PyTorch"
                )


_UNPORTED = {
    "use_pallas": "Pallas dispatch (the port picks the kernel by tensor device)",
    "interpret": "Pallas interpret mode",
}


@dataclasses.dataclass
class DFWFitResult:
    iterate: low_rank.FactoredIterate
    state: PyTree
    history: Dict[str, list]  # loss/gap/sigma/gamma/k per epoch (pre-update)
    masks: Optional[torch.Tensor]  # (epochs_run, N) worker weights; None unless sampling
    final_loss: float = float("nan")  # F at the returned iterate
    epochs_run: int = 0  # < num_epochs when gap_tol stopped the run
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    comm_state: PyTree = ()  # this worker's reducer state at the end (top-k residuals)
    probe: PyTree = ()  # the block solver's (m, k) warm start at the end; () for rank1
    timings: Dict[str, list] = dataclasses.field(default_factory=dict)  # the engine's


# ---------------------------------------------------------------------------
# Kernelized tasks: power_matvec kernels on the power-iteration hot path
# ---------------------------------------------------------------------------


class KernelizedTask:
    """Delegating task wrapper that routes the matvecs of the power
    iteration (paper Alg. 2 lines 5-10) through the kernels:
    ``power_matvec`` for the dense-state tasks, ``mc_matvec`` for the
    observed-entry (COO) completion gradient, along the state's row order
    (G v) and column order (G^T u). A 2-D operand, the block solver's (m, k)
    or (d, k) block, goes to the block forms: ``matmat``/``rmatmat`` and
    ``coo_matmat``, each reading its matrix once (the reference vmaps the
    vector kernels over the k columns). The logistic softmax P, ``P @ v``,
    ``P^T @ t`` and the label scatter stay plain PyTorch, as they stay plain
    XLA in the JAX package. Everything else, the dense MTLS state's products
    among it (as in the reference), is delegated to the base task. The
    drivers here and ``core.dfw_head`` (the ImageNet head's fits) run their
    tasks through it."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    def matvec(self, s, v: torch.Tensor) -> torch.Tensor:
        mv, rmv, coo = _routes(v)
        if isinstance(s, tasks.MTLSState):  # A = X^T R
            return rmv(s.x, mv(s.r, v))
        if isinstance(s, tasks.LogisticState):  # A = X^T (P - H)
            pv = self._base._probs(s) @ v - v[s.y]
            return rmv(s.x, pv)
        if isinstance(s, tasks.MCState):  # A = P_Omega(W - M), COO values resid
            return coo(s.by_row, s.resid_by_row, v)
        return self._base.matvec(s, v)

    def rmatvec(self, s, u: torch.Tensor) -> torch.Tensor:
        mv, rmv, coo = _routes(u)
        if isinstance(s, tasks.MTLSState):
            return rmv(s.r, mv(s.x, u))
        if isinstance(s, tasks.LogisticState):
            t = mv(s.x, u)
            return self._base._probs(s).T @ t - self._base._label_sum(s, t)
        if isinstance(s, tasks.MCState):
            return coo(s.by_col, s.resid_by_col, u)
        return self._base.rmatvec(s, u)


def _routes(x: torch.Tensor):
    """(A x, A^T x, COO) kernel wrappers for a vector or a block operand."""
    if x.dim() == 1:
        return pm_ops.matvec, pm_ops.rmatvec, mc_ops.coo_matvec
    return pm_ops.matmat, pm_ops.rmatmat, mc_ops.coo_matmat


def kernelize(task):
    """Wrap ``task`` so its power-iteration matvecs run through the kernels."""
    if isinstance(task, KernelizedTask):
        return task
    return KernelizedTask(task)


def verify_kernelized(task, ktask: KernelizedTask, state: PyTree, seed: int = 0,
                      *, tol: float = 1e-4, k: Optional[int] = None) -> float:
    """Raise ``AssertionError`` unless the kernel-routed matvec/rmatvec match
    the base task's plain operator chain on random unit probes (max error
    relative to max |reference|); with ``k`` (a block solver's width) also
    on random (m, k) and (d, k) blocks, through the block forms. Returns the
    largest relative error."""
    device = next(t for t in state if isinstance(t, torch.Tensor)).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    probes = [(sphere_vector(gen, task.m, device), sphere_vector(gen, task.d, device))]
    if k is not None:
        probes.append(tuple(torch.randn((dim, k), generator=gen, device=device)
                            for dim in (task.m, task.d)))

    def rel_err(a, b):
        return torch.max(torch.abs(a - b)) / (torch.max(torch.abs(b)) + 1e-30)

    err = float(torch.max(torch.stack([
        rel_err(got(state, x), want(state, x))
        for v, u in probes
        for got, want, x in ((ktask.matvec, task.matvec, v), (ktask.rmatvec, task.rmatvec, u))
    ])))
    if not err <= tol:
        raise AssertionError(
            f"kernelized matvec diverges from the plain operator chain: rel err "
            f"{err:.3e} > tol {tol:.1e} (task={type(task).__name__})"
        )
    return err


# ---------------------------------------------------------------------------
# Matrix-completion data layout
# ---------------------------------------------------------------------------


def shard_observations(rows, cols, vals, num_workers: int, d: int, *,
                       m: Optional[int] = None, weight=None):
    """Partition matrix-completion observations into row-block worker shards,
    as the JAX package's ``shard_observations`` does.

    Worker j owns the contiguous row block ``[j*ceil(d/nw), (j+1)*ceil(d/nw))``
    and each observed entry goes to its row's owner, in its original order.
    Every shard is padded to the largest one with zero-weight entries at
    (0, 0), exact no-ops in every reduction (``MCState`` pre-masks the
    residual). Returns ``(idx, yw)`` as ``tasks.pack_observations`` does (CPU
    tensors), worker j's shard at rows ``[j*p_max, (j+1)*p_max)``. Pass
    ``m`` to range-check the column indices too. Runs on the host (numpy):
    one-time data layout, not epoch work.
    """
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    rows_np = host(rows).astype(np.int64)
    cols_np = host(cols).astype(np.int64)
    vals_np = host(vals).astype(np.float32)
    w_np = np.ones_like(vals_np) if weight is None else host(weight).astype(np.float32)
    if not (rows_np.shape == cols_np.shape == vals_np.shape == w_np.shape):
        raise ValueError("rows/cols/vals/weight must have identical shapes")
    if rows_np.size and (rows_np.min() < 0 or rows_np.max() >= d):
        raise ValueError(f"row indices must lie in [0, {d})")
    if cols_np.size and cols_np.min() < 0:
        raise ValueError("column indices must be nonnegative")
    if m is not None and cols_np.size and cols_np.max() >= m:
        raise ValueError(f"column indices must lie in [0, {m})")

    block = -(-d // num_workers)  # ceil: worker j owns rows [j*block, (j+1)*block)
    owner = np.minimum(rows_np // block, num_workers - 1)
    sizes = np.bincount(owner, minlength=num_workers)
    p_max = max(int(sizes.max(initial=0)), 1)

    order = np.argsort(owner, kind="stable")
    owner_sorted = owner[order]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    slot = owner_sorted * p_max + (np.arange(order.size) - starts[owner_sorted])

    idx = np.zeros((num_workers * p_max, 2), np.int32)
    yw = np.zeros((num_workers * p_max, 2), np.float32)  # weight-0 padding
    idx[slot, 0] = rows_np[order]
    idx[slot, 1] = cols_np[order]
    yw[slot, 0] = vals_np[order]
    yw[slot, 1] = w_np[order]
    return torch.from_numpy(idx), torch.from_numpy(yw)


# ---------------------------------------------------------------------------
# Sampled-worker (straggler) schedule
# ---------------------------------------------------------------------------


def worker_schedule(key, num_epochs: int, num_workers: int, sample_prob: float, *,
                    reweight: bool = True, table=None) -> torch.Tensor:
    """(num_epochs, num_workers) float32 per-epoch worker weights, on the host.

    Each worker takes part in an epoch independently with ``sample_prob``
    (the paper's sampled-worker/straggler-timeout model); when a draw leaves
    no worker, one drawn uniformly is kept, so the LMO stays defined. With
    ``reweight`` the survivors weigh num_workers / alive, so the summed
    loss, gap and line-search terms are unbiased estimates of their
    full-data values under equal shard sizes. The draws come from a CPU
    ``torch.Generator`` seeded from ``key`` (an int seed or a ``V0Stream``),
    so every worker computes the same table. ``table`` injects a (T, N)
    table instead (the parity tests hand in the JAX run's).
    """
    if table is not None:
        table = torch.as_tensor(table, dtype=torch.float32).cpu()
        if tuple(table.shape) != (num_epochs, num_workers):
            raise ValueError(f"masks table has shape {tuple(table.shape)}; want "
                             f"({num_epochs}, {num_workers})")
        return table
    gen = torch.Generator()
    gen.manual_seed(_mix(as_v0_stream(key).seed, 0x1A5C))
    alive = torch.rand((num_epochs, num_workers), generator=gen) < sample_prob
    force = torch.randint(0, num_workers, (num_epochs,), generator=gen)
    none = ~alive.any(dim=1)
    alive[none, force[none]] = True
    w = alive.to(torch.float32)
    if reweight:
        alive_count = w.sum(dim=1, keepdim=True)
        w = w * (torch.full_like(alive_count, float(num_workers)) / alive_count)
    return w


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _make_checkpointer(task, cfg: DFWConfig, comm_spec: str, num_workers: int = 1,
                       start_t: int = 0) -> Optional[ckpt.RunCheckpointer]:
    """The run's checkpointer, or None without a dir. The run owns the dir
    from its first epoch ``start_t`` on: steps after it (all of them, for a
    fresh run) are removed, so a later latest-step read never splices
    another timeline onto this one."""
    if cfg.checkpoint_dir is None:
        return None
    checkpointer = ckpt.RunCheckpointer(
        cfg.checkpoint_dir,
        save_every=cfg.checkpoint_every,
        keep_last=cfg.checkpoint_keep,
        telemetry=cfg.telemetry,
        extra=ckpt.run_extra(
            task, num_workers=num_workers, comm=parse_comm(comm_spec).spec,
            num_epochs=cfg.num_epochs,
            schedule=cfg.schedule, mu=cfg.mu, step_size=cfg.step_size,
            sample_prob=cfg.sample_prob, reweight=cfg.reweight, solver=cfg.solver,
            topology=cfg.topology,
        ),
    )
    checkpointer.store.discard_after(start_t)
    return checkpointer


class _WorkerCheckpointer:
    """A multi-worker run's checkpointer. Every worker asks ``want`` at the
    same boundaries (``RunCheckpointer``'s policy); at a saved one every
    worker hands in its rows of the state and its reducer state (one
    all-gather a saved field) and worker 0, which holds ``inner``, writes
    the whole state, in rank order (the reference's global row layout), the
    reducer state with a leading worker axis (the top-k residuals (N, d)
    and (N, m)), its own iterate (node 0's, on a gossip graph) and the
    engine's (num_epochs, N) worker weights: ones without sampling, as the
    reference saves them."""

    def __init__(self, inner: Optional[ckpt.RunCheckpointer], group: Optional[WorkerGroup],
                 save_every: int, num_epochs: int, workers: int):
        self.inner, self.group, self.save_every = inner, group, save_every
        self.unsampled = np.ones((num_epochs, workers), np.float32)

    def want(self, boundary_index: int, last: bool) -> bool:
        return ckpt.wants_save(boundary_index, last, self.save_every)

    def save_segment(self, *, t: int, carry, history, masks, done: bool) -> None:
        state, comm_state = carry.state, carry.comm_state
        if self.group is not None:
            derived = getattr(state, "DERIVED", ())
            state = state._replace(**{
                name: self.group.all_gather(val) for name, val in zip(state._fields, state)
                if isinstance(val, torch.Tensor) and name not in derived})
            if comm_state != ():
                comm_state = {k: self.group.all_gather(v[None])
                              for k, v in sorted(comm_state.items())}
        if self.inner is not None:
            self.inner.save_segment(t=t, carry=carry._replace(state=state, comm_state=comm_state),
                                    history=history,
                                    masks=self.unsampled if masks is None else masks, done=done)

    def wait(self) -> None:
        if self.inner is not None:
            self.inner.wait()


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device`` with its dtype kept (int32 COO indices stay int32)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor or numpy array, got {type(a).__name__}")
    return a.to(device)


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------


def _check_epoch_path(task) -> None:
    """``fit_serial`` and ``fit`` run tasks with an epoch path; the dense
    MTLS operator (``tasks.MultiTaskLeastSquaresDense``) has none, as in the
    reference."""
    missing = [name for name in ("local_loss", "inner_w_grad") if not hasattr(task, name)]
    if missing:
        raise TypeError(
            f"{type(task).__name__} has no epoch path: it lacks {', '.join(missing)}, which "
            "every DFW-Trace epoch reads (the loss and the gap certificate); it is an "
            "operator (matvec, rmatvec, update, local_grad) only"
        )


def _check_problem(snap: ckpt.RunSnapshot, task) -> None:
    """A checkpoint resumes only the problem it was saved from: the same task
    type and dimensions (the worker count, comm and schedule may change:
    elastic resume, warm restart)."""
    ext = snap.extra
    want = (type(task).__name__, int(task.d), int(task.m))
    got = (ext.get("task"), int(ext.get("d", -1)), int(ext.get("m", -1)))
    if want != got:
        raise ValueError(
            f"checkpoint was saved by task {got} but resume targets {want}; "
            "resume_from must point at a checkpoint of the same problem"
        )


def _resume_complete(snap: ckpt.RunSnapshot, cfg: DFWConfig) -> bool:
    """Does the checkpoint already satisfy this config? Yes when the epoch
    budget is spent, or when its saved early stop still stands under
    ``cfg.gap_tol``; a warm restart that extends ``num_epochs`` or loosens
    or drops ``gap_tol`` runs on (the saved ``done`` records the old
    certificate, not this one)."""
    if snap.t >= cfg.num_epochs:
        return True
    if not snap.done:
        return False
    gaps = snap.history.get("gap", [])
    return bool(gaps) and cfg.gap_tol is not None and gaps[-1] <= cfg.gap_tol


@dataclasses.dataclass
class _Start:
    """A resumed run's start on this worker: the carry of epoch ``t`` on the
    device, where the engine takes it. ``comm_state`` and ``probe`` are None
    where the run starts them fresh (the reducer's ``init_state``, the cold
    probe); ``masks`` the saved worker weights where they apply."""

    state: PyTree
    iterate: low_rank.FactoredIterate
    comm_state: PyTree
    t: int
    history: Dict[str, list]
    probe: Any
    key: V0Stream
    masks: Optional[np.ndarray]
    complete: bool


def _resume(task, cfg: DFWConfig, key: V0Stream, dev: torch.device, *, rank: int = 0,
            workers: int = 1, serial: bool = True) -> _Start:
    """Read ``cfg.resume_from`` and rebuild this worker's start from it.

    Worker ``rank`` of ``workers`` takes rows ``[rank n/N, (rank+1) n/N)``
    of every saved state field (matrix completion: its part of the saved
    ``shard_observations`` layout; padding entries weigh zero). The
    reducer state is restored where it belongs to this run's encoding: in
    ``fit_serial`` from a one-worker run with the same comm, in ``fit``
    from a run with the same worker count, topology and comm (worker j's
    row of the saved (N, ...) residuals); elsewhere it starts fresh. A
    table-fed ``key`` is kept (its rows are indexed by absolute epoch);
    otherwise the run continues with the checkpoint's seed."""
    snap = ckpt.restore_run(cfg.resume_from, task=task, step=cfg.resume_step)
    _check_problem(snap, task)
    if snap.t > cfg.num_epochs:
        raise ValueError(
            f"checkpoint is at epoch {snap.t} but num_epochs={cfg.num_epochs}; "
            "extend num_epochs to resume past it"
        )
    return _place(snap, task, cfg, key, dev, rank=rank, workers=workers, serial=serial)


def _place(snap: ckpt.RunSnapshot, task, cfg: DFWConfig, key: V0Stream, dev: torch.device, *,
           rank: int = 0, workers: int = 1, serial: bool = True) -> _Start:
    """``_resume``'s placement of a snapshot read elsewhere (``core.dfw_head``
    takes one): worker ``rank``'s rows of the saved state, the iterate in a
    store of ``resolve_max_rank(cfg.max_rank, cfg.num_epochs)`` factors, the
    reducer state, probe, key and masks where they apply."""
    ext = snap.extra
    n = next(iter(snap.state.values())).shape[0]
    if n % workers:
        raise ValueError(
            f"leading dim {n} of the checkpointed state not divisible by {workers} workers; "
            "pad or trim the sample axis before sharding"
        )
    lo, hi = rank * (n // workers), (rank + 1) * (n // workers)
    state = convert.task_state({name: val[lo:hi] for name, val in snap.state.items()},
                               device=dev, d=task.d, m=task.m)
    sspec = parse_solver(cfg.solver)
    k_block = sspec.k if sspec.kind == "block" else 1
    iterate = snap.unpack_iterate(
        engine.resolve_max_rank(cfg.max_rank, cfg.num_epochs, k_block), dev)
    same_workers = int(ext.get("num_workers", -1)) == workers
    same_encoding = same_workers and ext.get("comm") == parse_comm(cfg.comm).spec and (
        serial or ext.get("topology", "flat") == cfg.topology)
    comm_state = None
    if same_encoding:
        saved = snap.comm_state
        stacked = saved != () and np.ndim(saved["u"]) == 2  # (N, ...) from N workers
        comm_state = convert.comm_state(saved, worker=rank if stacked else None, device=dev)
    probe = None
    if sspec.kind == "block" and np.shape(snap.probe) == (task.m, sspec.k):
        probe = torch.from_numpy(np.array(snap.probe, np.float32)).to(dev)
    same_sampling = (float(ext.get("sample_prob", -1.0)) == cfg.sample_prob
                     and bool(ext.get("reweight", not cfg.reweight)) == cfg.reweight)
    masks = snap.masks
    if not (same_workers and same_sampling and masks is not None
            and masks.shape == (cfg.num_epochs, workers)):
        masks = None
    return _Start(state=state, iterate=iterate, comm_state=comm_state, t=snap.t,
                  history=snap.history, probe=probe,
                  key=key if key.tabled else V0Stream(snap.seed), masks=masks,
                  complete=_resume_complete(snap, cfg))


def _finished(task, start: _Start, group: Optional[WorkerGroup], masks) -> DFWFitResult:
    """The result of a resume with nothing left to run: the restored carry,
    and the full-data loss of its state (summed over the group)."""
    final_loss = float(psum(task.local_loss(start.state), group))
    return DFWFitResult(
        iterate=start.iterate, state=start.state, history=start.history,
        masks=None if masks is None else masks[:start.t], final_loss=final_loss,
        epochs_run=start.t,
        stats={"segments_planned": 0, "segments_run": 0, "dispatches": 1, "host_syncs": 1},
        comm_state=() if start.comm_state is None else start.comm_state,
        probe=() if start.probe is None else start.probe,
    )


def _run(task, x, y, *, cfg: DFWConfig, key, noise, callback, dev, group, masks, checkpointer,
         num_workers: int, probe=None, start: Optional[_Start] = None) -> DFWFitResult:
    """The run ``fit_serial`` and ``fit`` share, on this worker's rows ``x``,
    ``y``, from epoch 0 or from a resumed ``start`` (whose restored state
    replaces the one ``x``, ``y`` would build).

    The graph comes from ``make_topology`` (with a group, every worker
    builds hier's subgroups here in the same order); a flat graph's bare
    reducer goes to the engine."""
    tel = cfg.telemetry if cfg.telemetry is not None else Telemetry.noop()
    tel.event("run.start", "run", driver="launch.dfw.fit_serial" if group is None else
              "launch.dfw.fit", task=type(task).__name__, d=int(task.d), m=int(task.m),
              num_workers=num_workers, rank=0 if group is None else group.rank, comm=cfg.comm,
              topology=cfg.topology, schedule=cfg.schedule, num_epochs=cfg.num_epochs,
              solver=cfg.solver, engine=cfg.engine)
    ktask = kernelize(task)
    topo = make_topology(cfg.topology, num_workers=num_workers, comm=cfg.comm,
                         rounds=cfg.gossip_rounds, group=group)
    reducer = topo.reducer
    comm_obj = reducer if cfg.topology == "flat" else topo
    sspec = parse_solver(cfg.solver)
    k_block = sspec.k if sspec.kind == "block" else None
    if cfg.verify_kernels:
        rows = min(x.shape[0], 64)
        verify_kernelized(task, ktask, task.init_state(x[:rows], y[:rows]), seed=0x5EED,
                          k=k_block)
        if isinstance(reducer, Int8Reducer):  # at the budget of the hop it encodes
            verify_quantize_kernels(num_workers=reducer.num_workers, device=dev)
    resumed = {}
    if start is None:
        state = ktask.init_state(x, y)
    else:
        state = start.state
        resumed = dict(iterate=start.iterate, comm_state=start.comm_state, start_t=start.t,
                       initial_history=start.history)
        if start.probe is not None:
            probe = start.probe
    before = None if group is None else group.tally.snapshot()
    with tel.profiler():
        res = frank_wolfe.fit(
            ktask,
            state,
            mu=cfg.mu,
            num_epochs=cfg.num_epochs,
            key=key,
            schedule=cfg.schedule,
            step_size=cfg.step_size,
            callback=callback,
            reducer=comm_obj,
            max_rank=engine.resolve_max_rank(cfg.max_rank, cfg.num_epochs, k_block or 1),
            gap_tol=cfg.gap_tol,
            block_epochs=cfg.block_epochs,
            solver=cfg.solver,
            noise=noise,
            checkpointer=checkpointer,
            device=dev,
            group=group,
            masks=masks,
            probe=probe,
            mode=cfg.engine,
            telemetry=tel,
            **resumed,
        )
    if checkpointer is not None:
        with tel.span("checkpoint.join", "checkpoint"):
            checkpointer.wait()
    if group is not None:
        after = group.tally.snapshot()
        res.stats["all_reduces"] = after["calls"]["all_reduce"] - before["calls"]["all_reduce"]
        for kind, nbytes in after["bytes"].items():
            res.stats[f"bytes_{kind}"] = nbytes - before["bytes"][kind]
        if not getattr(comm_obj, "replicated", True):
            # the workers' iterates part (gossip's per-node estimates, or
            # int8 across hier groups): every worker returns node 0's, the
            # reference's convention (every worker ran as many epochs, so
            # the count is the same)
            for t in res.iterate:
                group.broadcast(t)
        if checkpointer is not None:
            # worker 0 has joined its last write: every worker returns with the
            # run's checkpoints durable, so any of them may resume from them
            group.all_reduce(torch.zeros(1, device=dev))
    return DFWFitResult(
        iterate=res.iterate, state=res.state, history=res.history, masks=res.masks,
        final_loss=res.final_loss, epochs_run=res.epochs_run, stats=res.stats,
        comm_state=res.comm_state, probe=res.probe, timings=res.timings,
    )


def fit(
    task,
    x,
    y,
    *,
    cfg: DFWConfig,
    key=0,
    noise: Optional[NoiseStream] = None,
    group: Optional[WorkerGroup] = None,
    device: DeviceLike = None,
    masks=None,
    callback: Optional[Callable[[int, EpochAux], None]] = None,
    probe=None,
) -> DFWFitResult:
    """Multi-worker DFW-Trace: this process's part of a run over ``group``
    (a ``comm.WorkerGroup``; None: one process), on ``device`` (CUDA unless
    "cpu" is given). Every worker calls ``fit`` with the same arguments.

    ``x``/``y`` are the whole data set (torch tensors or numpy arrays):
    the samples and targets of the dense tasks, or matrix completion's
    ``(idx, yw)`` from ``shard_observations(..., N, d)``. Their leading
    dimension n must be divisible by the N workers (``ValueError``
    otherwise, as in the reference); worker j takes rows ``[j n/N, (j+1)
    n/N)`` (for ``shard_observations``' layout, its own shard) and moves
    only those to ``device``. The iterate, the scalars and the start
    vectors (``key``: an int seed or a ``V0Stream``) are replicated; every
    aggregate is summed over the group (``comm``): per power iteration two
    vector exchanges, per epoch one all-reduce of the loss and <W, grad>
    and, with the line search, one of its two terms. ``noise`` is this
    worker's int8 noise (default ``NoiseStream(seed, worker=j)``).
    ``cfg.topology`` picks the graph of the vector exchanges
    (``comm.make_topology``): on ``ring``/``gossip:k`` each worker keeps its
    own iterate and the history's gap and sigma are the workers' largest;
    on ``hier:g`` the exchange sums inside each group, then encodes across
    groups. Where the workers' iterates part (gossip, or int8 across hier
    groups) every worker returns worker 0's, the reference's convention.
    ``stats`` add, over the group, ``all_reduces`` and ``bytes_<kind>``,
    the bytes of this worker's collectives by kind (``comm.base.KINDS``),
    from the group's ``tally``: the collectives called, so a fit captured
    into CUDA graphs (an NCCL group) counts each captured one once, when
    captured (the engine's analytic ``comm_*`` stats count the epochs run).

    ``cfg.sample_prob`` < 1 samples the workers per epoch
    (``worker_schedule``, or the injected (num_epochs, N) ``masks``
    table): a worker left out contributes zero, the others N / alive under
    ``cfg.reweight``; ``masks`` of the epochs run come back in the result.
    With ``cfg.verify_kernels`` each worker first holds the kernel route to
    the plain operator chain on its first 64 rows (and under int8 the
    quantize pair at the budget 127 // N). ``final_loss`` is the full-data
    loss at the returned iterate, never weighted. With
    ``cfg.checkpoint_dir`` worker 0 writes the run's checkpoints with the
    whole state (gathered from the workers at each saved boundary), in the
    reference's layout.

    ``cfg.solver`` "block:k[:adapt][:cold]" runs the block tier on flat and
    hier graphs: every exchange carries the flattened (d k,) or (m k,)
    block, and the (m, k) warm-start probe is replicated, the same on every
    worker (``probe``: the start one, default ``frank_wolfe.init_probe``;
    every worker must pass the same).

    ``cfg.resume_from`` resumes a run (the module doc): every worker reads
    the step and keeps its rows of the saved state (``x``, ``y`` then only
    feed the start-up checks); with the same worker count, topology and
    comm each worker takes its own saved reducer state, and with the same
    sampling the saved masks. With a checkpoint dir, every worker returns
    once worker 0's last write has landed.
    """
    _check_epoch_path(task)
    dev = resolve_device(device)
    workers, rank = (1, 0) if group is None else (group.size, group.rank)
    n = x.shape[0]
    if n % workers:
        raise ValueError(
            f"leading dim {n} not divisible by {workers} workers; pad or trim the sample "
            "axis before sharding"
        )
    lo, hi = rank * (n // workers), (rank + 1) * (n // workers)
    x, y = _as_tensor(x[lo:hi], dev), _as_tensor(y[lo:hi], dev)
    key = as_v0_stream(key)
    sampling = cfg.sample_prob < 1.0
    if masks is not None and not sampling:
        raise ValueError("masks= injects the straggler schedule; it needs sample_prob < 1")
    start = None
    if cfg.resume_from is not None:
        start = _resume(task, cfg, key, dev, rank=rank, workers=workers, serial=False)
        key = start.key
        if masks is None:
            masks = start.masks
    if noise is None:
        noise = NoiseStream(key.seed, worker=None if group is None else rank)
    table = (worker_schedule(key, cfg.num_epochs, workers, cfg.sample_prob,
                             reweight=cfg.reweight, table=masks) if sampling else None)
    if start is not None and start.complete:
        return _finished(task, start, group, table)
    checkpointer = None
    if cfg.checkpoint_dir is not None:
        checkpointer = _WorkerCheckpointer(
            _make_checkpointer(task, cfg, cfg.comm, workers, 0 if start is None else start.t)
            if rank == 0 else None, group, cfg.checkpoint_every, cfg.num_epochs, workers,
        )
    return _run(task, x, y, cfg=cfg, key=key, noise=noise, callback=callback, dev=dev,
                group=group, masks=table, checkpointer=checkpointer, num_workers=workers,
                probe=probe, start=start)


def fit_serial(
    task,
    x,
    y,
    *,
    cfg: DFWConfig,
    key=0,
    noise: Optional[NoiseStream] = None,
    callback: Optional[Callable[[int, EpochAux], None]] = None,
    device: DeviceLike = None,
    probe=None,
) -> DFWFitResult:
    """Single-worker DFW-Trace run on ``device`` (CUDA unless "cpu" is given).

    ``x``/``y`` are torch tensors or numpy arrays (moved to ``device``): the
    samples and targets of the dense tasks, or matrix completion's ``(idx,
    yw)`` from ``tasks.pack_observations``/``shard_observations``. ``key`` is
    an int seed or a ``repro_torch.V0Stream``; ``noise`` is the int8
    reducer's ``repro_torch.NoiseStream`` (default: seeded like ``key``).
    ``cfg.comm`` is honoured with a one-worker reducer: int8 runs at the
    full 127-level budget, top-k with one worker's error feedback, the
    serial baseline of the compressed runs. ``cfg.topology`` likewise: a
    one-worker gossip exchange is the identity and a one-worker ``hier:g``
    encodes at group width g (int8's budget 127 // g), as in the reference.
    ``cfg.sample_prob`` < 1 is rejected, as in the reference: the straggler
    model samples workers, and a serial run has one.

    ``cfg.solver`` "block:k[:adapt][:cold]" runs the block tier; ``probe``
    is its (m, k) start probe (default ``frank_wolfe.init_probe``; the
    parity tests hand in the reference's).

    The power method runs through the kernels, and with ``cfg.verify_kernels``
    that route is first held to the plain operator chain on the first 64
    rows (for matrix completion: the first 64 entries, with the full d and
    m), for the block solver also on random (m, k) and (d, k) blocks, and
    under int8 the quantize pair to its plain version. ``stats``
    count the run itself (see ``core/engine.py``), not these set-up checks.

    With ``cfg.checkpoint_dir`` the run owns that directory from its first
    epoch: steps after it left by an earlier run are removed, every
    ``cfg.checkpoint_every``-th segment boundary (and the last) is saved, the
    newest ``cfg.checkpoint_keep`` are kept, and the writer is joined before
    this returns. ``cfg.resume_from`` continues a run from a step (the
    module doc); the reducer state is restored from a one-worker run with
    the same comm, and a finished run returns without running an epoch.
    """
    if cfg.sample_prob < 1.0:
        raise ValueError(
            f"sample_prob={cfg.sample_prob} needs multiple workers to sample "
            "from; fit_serial runs exactly one. Use fit(..., group=WorkerGroup()) "
            "in each of N worker processes (run_workers) for the straggler mode, "
            "or set sample_prob=1.0"
        )
    _check_epoch_path(task)
    dev = resolve_device(device)
    x, y = _as_tensor(x, dev), _as_tensor(y, dev)
    key = as_v0_stream(key)
    start = None
    if cfg.resume_from is not None:
        start = _resume(task, cfg, key, dev)
        if start.complete:
            return _finished(task, start, None, None)
        key = start.key
    return _run(task, x, y, cfg=cfg, key=key, noise=noise, callback=callback, dev=dev,
                group=None, masks=None,
                checkpointer=_make_checkpointer(task, cfg, cfg.comm, 1,
                                                0 if start is None else start.t),
                num_workers=1, probe=probe, start=start)


# ---------------------------------------------------------------------------
# Worker processes on one host
# ---------------------------------------------------------------------------


# How long a worker waits in one collective for the others before it fails.
_COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def _worker_main(rank: int, num_workers: int, tmp: str, backend: str, device_type: str,
                 fn, boxed: list) -> None:
    """One worker. ``boxed`` holds the arguments, and ``fn`` takes them out
    of it: once ``fn`` returns, nothing here refers to them, so the CUDA
    tensors received through IPC are freed before the process ends (the
    spawn machinery holds its arguments until exit, and a received tensor
    still alive then keeps the caller's memory pinned for good)."""
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            # the workers share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_workers))
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), num_workers), rank=rank,
            world_size=num_workers, timeout=_COLLECTIVE_TIMEOUT)
        try:
            result = fn(WorkerGroup(), device, *boxed.pop())
        finally:
            destroy_groups()  # also collects the garbage: the received tensors go
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException as e:
        try:
            blob = pickle.dumps((e, traceback.format_exc()))
        except Exception:
            blob = pickle.dumps((RuntimeError(repr(e)), traceback.format_exc()))
        with open(os.path.join(tmp, f"error{rank}.pkl"), "wb") as f:
            f.write(blob)
        raise


# How long the other workers get to end on their own once one has failed.
_FAILURE_GRACE_S = 5.0


def _join_workers(procs) -> Optional[Dict[int, int]]:
    """Wait for every worker; None if all exited with 0. Otherwise, once one
    has failed, give the others ``_FAILURE_GRACE_S`` to end on their own,
    note the exit code of each that did (rank -> code), and only then stop
    the rest, so that the codes say who ended first and how."""
    from multiprocessing.connection import wait

    waiting = {p.sentinel: p for p in procs}
    while waiting:
        for sentinel in wait(list(waiting)):
            waiting.pop(sentinel).join()
        if any(p.exitcode not in (None, 0) for p in procs):
            break
    else:
        return None
    deadline = time.monotonic() + _FAILURE_GRACE_S
    while waiting and time.monotonic() < deadline:
        for sentinel in wait(list(waiting), timeout=max(0.0, deadline - time.monotonic())):
            waiting.pop(sentinel).join()
    ended = {rank: p.exitcode for rank, p in enumerate(procs) if p.exitcode is not None}
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.kill()
            p.join()
    return ended


def _raise_worker_failure(ended: Dict[int, int], num_workers: int, tmp: str) -> None:
    """Raise the failure of a run whose workers ended with ``ended`` (rank ->
    exit code, before the rest were stopped). A worker that died on a signal
    is the cause, whatever its peers raised after it (they fail in their
    collectives or their teardown once it is gone); else the first error
    file written."""
    died = sorted(rank for rank, code in ended.items() if code < 0)
    if died:  # a native death: no error file, no traceback
        rank = died[0]
        try:
            signal_name = signal.Signals(-ended[rank]).name
        except ValueError:
            signal_name = f"signal {-ended[rank]}"
        written = os.path.exists(os.path.join(tmp, f"result{rank}.pkl"))
        raise RuntimeError(
            f"worker {rank} of {num_workers} died on {signal_name} "
            + ("after its result was written (in its teardown)" if written
               else "before its result was written"))
    # The first worker to fail is the cause; the others then fail in their
    # collectives (a peer closed the connection).
    errors = sorted((os.stat(os.path.join(tmp, f"error{rank}.pkl")).st_mtime_ns, rank)
                    for rank in range(num_workers)
                    if os.path.exists(os.path.join(tmp, f"error{rank}.pkl")))
    if not errors:
        rank, code = min((r, c) for r, c in ended.items() if c != 0)
        raise RuntimeError(f"worker {rank} of {num_workers} exited with code {code}")
    rank = errors[0][1]
    with open(os.path.join(tmp, f"error{rank}.pkl"), "rb") as f:
        exc, tb = pickle.load(f)
    exc.add_note(f"raised in worker {rank} of {num_workers}:\n{tb}")
    raise exc


def run_workers(num_workers: int, fn: Callable, *args, backend: str = "gloo",
                device: DeviceLike = None) -> List[Any]:
    """Run ``fn(group, device, *args)`` in ``num_workers`` processes, one
    worker each, and return each worker's result in rank order.

    The processes are started with ``torch.multiprocessing`` (spawn) and
    joined through a ``torch.distributed.FileStore`` in a temporary
    directory (no TCP port). ``group`` is the ``comm.WorkerGroup`` of all of
    them over ``backend`` ("gloo", or "nccl" with one card a worker);
    ``device`` is CUDA unless "cpu" is given, worker j on card ``j % cards``.
    ``fn`` must be importable by name (a module-level function) and return
    host data (it is pickled back). ``args`` are pickled to every worker;
    torch tensors among them are shared, CUDA tensors through CUDA IPC, so
    the workers can read one copy of a data set made by the caller. If a
    worker raises, the others are stopped and its exception is raised here,
    with its traceback as a note; if one dies on a signal, a RuntimeError
    names its rank, the signal and whether its result had been written. A
    worker waits at most 600 s in a collective. Each worker tears its groups
    down (``comm.destroy_groups``) before it writes its result, with the
    tensors it received freed, and the caller's memory they shared is
    released once the workers have ended (``torch.cuda.ipc_collect``).
    """
    import torch.multiprocessing as mp

    device_type = resolve_device(device).type
    if backend == "nccl" and (device_type != "cuda" or torch.cuda.device_count() < num_workers):
        raise ValueError(
            f"nccl needs one card a worker: {num_workers} workers, "
            f"{torch.cuda.device_count() if device_type == 'cuda' else 0} cards"
        )
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_worker_main, nprocs=num_workers, join=False,
                       args=(num_workers, tmp, backend, device_type, fn, [args]))
        ended = _join_workers(ctx.processes)
        if device_type == "cuda":  # free what the workers received and released
            torch.cuda.ipc_collect()
        if ended is not None:
            _raise_worker_failure(ended, num_workers, tmp)
        results = []
        for rank in range(num_workers):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
