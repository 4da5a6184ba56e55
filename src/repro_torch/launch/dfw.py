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
(and the block solver's replicated probe). Resuming and telemetry come with
later slices; a ``DFWConfig`` that asks for them is rejected.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import DeviceLike, NoiseStream, _mix, as_v0_stream, resolve_device
from ..checkpoint import dfw as ckpt
from ..comm import Int8Reducer, WorkerGroup, make_topology, verify_quantize_kernels
from ..core import engine, frank_wolfe, low_rank, tasks
from ..core.frank_wolfe import EpochAux
from ..core.power_method import sphere_vector
from ..kernels.mc_matvec import ops as mc_ops
from ..kernels.power_matvec import ops as pm_ops
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
    spectral gap, ``comm.default_gossip_rounds``). Every field of the second
    group belongs to a path not yet ported (Pallas, resume, telemetry) and
    must keep its default; anything else raises
    ``NotYetPorted`` when the config is built. The port has no
    ``kernelize`` switch: the run always goes through ``KernelizedTask``,
    whose ops pick the kernel or the plain version by the tensors' device.
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
    # --- not yet ported: must keep these defaults ---
    use_pallas: Optional[bool] = None
    interpret: bool = False
    engine: str = "scan"
    resume_from: Optional[str] = None
    resume_step: Optional[int] = None
    telemetry: Optional[Any] = None

    def __post_init__(self):
        validate(solver=self.solver, comm=self.comm, topology=self.topology)
        frank_wolfe.k_schedule(self.schedule)
        if self.step_size not in ("default", "linesearch"):
            raise ValueError(f"step_size={self.step_size!r}")
        if not 0.0 < self.sample_prob <= 1.0:
            raise ValueError(f"sample_prob={self.sample_prob}: must lie in (0, 1]")
        for f in dataclasses.fields(self):
            if f.name in _UNPORTED and getattr(self, f.name) != f.default:
                raise NotYetPorted(
                    f"DFWConfig.{f.name}={getattr(self, f.name)!r}: {_UNPORTED[f.name]} "
                    "is not yet ported to PyTorch"
                )


_UNPORTED = {
    "use_pallas": "Pallas dispatch (the port picks the kernel by tensor device)",
    "interpret": "Pallas interpret mode",
    "engine": "the legacy per-epoch engine",
    "resume_from": "checkpoint resume",
    "resume_step": "checkpoint resume",
    "telemetry": "telemetry",
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
    XLA in the JAX package. Everything else is delegated to the base task."""

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


def _make_checkpointer(task, cfg: DFWConfig, comm_spec: str, num_workers: int = 1
                       ) -> Optional[ckpt.RunCheckpointer]:
    """The run's checkpointer, or None without a dir. The run owns the dir:
    steps an earlier run left there are removed."""
    if cfg.checkpoint_dir is None:
        return None
    checkpointer = ckpt.RunCheckpointer(
        cfg.checkpoint_dir,
        save_every=cfg.checkpoint_every,
        keep_last=cfg.checkpoint_keep,
        extra=ckpt.run_extra(
            task, num_workers=num_workers, comm=parse_comm(comm_spec).spec,
            num_epochs=cfg.num_epochs,
            schedule=cfg.schedule, mu=cfg.mu, step_size=cfg.step_size,
            sample_prob=cfg.sample_prob, reweight=cfg.reweight, solver=cfg.solver,
            topology=cfg.topology,
        ),
    )
    checkpointer.store.discard_after(0)
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
                name: self.group.all_gather_rows(val) for name, val in zip(state._fields, state)
                if isinstance(val, torch.Tensor) and name not in derived})
            if comm_state != ():
                comm_state = {k: self.group.all_gather_rows(v[None])
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


def _run(task, x, y, *, cfg: DFWConfig, key, noise, callback, dev, group, masks, checkpointer,
         num_workers: int, probe=None) -> DFWFitResult:
    """The run both drivers share, on this worker's rows ``x``, ``y``.

    The graph comes from ``make_topology`` (with a group, every worker
    builds hier's subgroups here in the same order); a flat graph's bare
    reducer goes to the engine."""
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
    state = ktask.init_state(x, y)
    before = None if group is None else group.tally.snapshot()
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
    )
    if checkpointer is not None:
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
    return DFWFitResult(
        iterate=res.iterate, state=res.state, history=res.history, masks=res.masks,
        final_loss=res.final_loss, epochs_run=res.epochs_run, stats=res.stats,
        comm_state=res.comm_state, probe=res.probe,
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
    the bytes of this worker's collectives by kind (``comm.base.KINDS``).

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
    """
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
    if noise is None:
        noise = NoiseStream(key.seed, worker=None if group is None else rank)
    sampling = cfg.sample_prob < 1.0
    if masks is not None and not sampling:
        raise ValueError("masks= injects the straggler schedule; it needs sample_prob < 1")
    table = (worker_schedule(key, cfg.num_epochs, workers, cfg.sample_prob,
                             reweight=cfg.reweight, table=masks) if sampling else None)
    checkpointer = None
    if cfg.checkpoint_dir is not None:
        checkpointer = _WorkerCheckpointer(
            _make_checkpointer(task, cfg, cfg.comm, workers) if rank == 0 else None, group,
            cfg.checkpoint_every, cfg.num_epochs, workers,
        )
    return _run(task, x, y, cfg=cfg, key=key, noise=noise, callback=callback, dev=dev,
                group=group, masks=table, checkpointer=checkpointer, num_workers=workers,
                probe=probe)


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

    With ``cfg.checkpoint_dir`` the run owns that directory: steps left there
    by an earlier run are removed, every ``cfg.checkpoint_every``-th segment
    boundary (and the last) is saved, the newest ``cfg.checkpoint_keep`` are
    kept, and the writer is joined before this returns.
    """
    if cfg.sample_prob < 1.0:
        raise ValueError(
            f"sample_prob={cfg.sample_prob} needs multiple workers to sample "
            "from; fit_serial runs exactly one. Use fit(..., group=WorkerGroup()) "
            "in each of N worker processes (run_workers) for the straggler mode, "
            "or set sample_prob=1.0"
        )
    dev = resolve_device(device)
    x, y = _as_tensor(x, dev), _as_tensor(y, dev)
    return _run(task, x, y, cfg=cfg, key=as_v0_stream(key), noise=noise, callback=callback,
                dev=dev, group=None, masks=None, checkpointer=_make_checkpointer(task, cfg, cfg.comm),
                num_workers=1, probe=probe)


# ---------------------------------------------------------------------------
# Worker processes on one host
# ---------------------------------------------------------------------------


# How long a worker waits in one collective for the others before it fails.
_COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def _worker_main(rank: int, num_workers: int, tmp: str, backend: str, device_type: str,
                 fn, args) -> None:
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
            result = fn(WorkerGroup(), device, *args)
        finally:
            dist.destroy_process_group()
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
    with its traceback as a note; a worker waits at most 600 s in a
    collective.
    """
    import torch.multiprocessing as mp

    device_type = resolve_device(device).type
    if backend == "nccl" and (device_type != "cuda" or torch.cuda.device_count() < num_workers):
        raise ValueError(
            f"nccl needs one card a worker: {num_workers} workers, "
            f"{torch.cuda.device_count() if device_type == 'cuda' else 0} cards"
        )
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(_worker_main, nprocs=num_workers, join=True,
                     args=(num_workers, tmp, backend, device_type, fn, args))
        except Exception as failure:
            # The first worker to fail is the cause; the others then fail in
            # their collectives (a peer closed the connection).
            errors = sorted((os.stat(os.path.join(tmp, f"error{rank}.pkl")).st_mtime_ns, rank)
                            for rank in range(num_workers)
                            if os.path.exists(os.path.join(tmp, f"error{rank}.pkl")))
            if not errors:
                raise
            rank = errors[0][1]
            with open(os.path.join(tmp, f"error{rank}.pkl"), "rb") as f:
                exc, tb = pickle.load(f)
            exc.add_note(f"raised in worker {rank} of {num_workers}:\n{tb}")
            raise exc from failure
        results = []
        for rank in range(num_workers):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
