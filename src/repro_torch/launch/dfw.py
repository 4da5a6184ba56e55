"""DFW-Trace execution layer, the port's counterpart of ``repro.launch.dfw``.

This slice ports the serial driver: ``fit_serial`` runs one worker on one
device for the three paper tasks, with solver ``rank1``, topology ``flat``
and comm ``dense`` or ``int8`` (a one-worker int8 reducer, the serial
baseline of the compressed runs). ``KernelizedTask`` routes the power
method's matvecs through the hand-written ``power_matvec`` kernels (dense
tasks) and ``mc_matvec`` kernel (matrix completion), and the dense tasks'
update goes through ``rank1_update``; ``verify_kernelized`` (and, for int8,
``comm.verify_quantize_kernels``) holds the kernel route to the plain
versions before a run starts. ``shard_observations`` lays out matrix
completion entries as the JAX package does.

``DFWConfig(checkpoint_dir=...)`` makes ``fit_serial`` write run checkpoints
in the JAX package's layout and payload format (``repro_torch.checkpoint``),
which the serving engine and the JAX package's readers load. The sharded
driver, the straggler schedule, resuming and telemetry come with later
slices; a ``DFWConfig`` that asks for them is rejected.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import DeviceLike, NoiseStream, as_v0_stream, resolve_device
from ..checkpoint import dfw as ckpt
from ..comm import Int8Reducer, make_reducer, verify_quantize_kernels
from ..core import engine, frank_wolfe, low_rank, tasks
from ..core.frank_wolfe import EpochAux
from ..core.power_method import sphere_vector
from ..kernels.mc_matvec import ops as mc_ops
from ..kernels.power_matvec import ops as pm_ops
from ..specs import NotYetPorted, validate

PyTree = Any


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DFWConfig:
    """Knobs of one DFW-Trace run, with the JAX package's field names.

    The port runs the fields in the first group. Every field of the second
    group belongs to a path not yet ported (multi-worker sampling, other
    solvers/encodings/graphs, Pallas, resume, telemetry) and must keep
    its default; anything else raises ``NotYetPorted`` when the config is
    built. The port has no ``kernelize`` switch: the run always goes through
    ``KernelizedTask``, whose ops pick the kernel or the plain version by the
    tensors' device.
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
    # --- not yet ported: must keep these defaults ---
    gossip_rounds: Optional[int] = None
    data_axis: str = "data"
    sample_prob: float = 1.0
    reweight: bool = True
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
        for f in dataclasses.fields(self):
            if f.name in _UNPORTED and getattr(self, f.name) != f.default:
                raise NotYetPorted(
                    f"DFWConfig.{f.name}={getattr(self, f.name)!r}: {_UNPORTED[f.name]} "
                    "is not yet ported to PyTorch"
                )


_UNPORTED = {
    "gossip_rounds": "gossip topology",
    "data_axis": "the multi-worker mesh",
    "sample_prob": "the straggler (sampled-worker) mode",
    "reweight": "the straggler (sampled-worker) mode",
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
    masks: Optional[torch.Tensor]  # straggler masks; None (one worker)
    final_loss: float = float("nan")  # F at the returned iterate
    epochs_run: int = 0  # < num_epochs when gap_tol stopped the run
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Kernelized tasks: power_matvec kernels on the power-iteration hot path
# ---------------------------------------------------------------------------


class KernelizedTask:
    """Delegating task wrapper that routes the matvecs of the power
    iteration (paper Alg. 2 lines 5-10) through the kernels:
    ``power_matvec`` for the dense-state tasks, ``mc_matvec`` for the
    observed-entry (COO) completion gradient, along the state's row order
    (G v) and column order (G^T u). The logistic softmax P, ``P @ v``,
    ``P^T @ t`` and the label scatter stay plain PyTorch, as they stay plain
    XLA in the JAX package. Everything else is delegated to the base task."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    def matvec(self, s, v: torch.Tensor) -> torch.Tensor:
        if isinstance(s, tasks.MTLSState):  # A = X^T R
            return pm_ops.rmatvec(s.x, pm_ops.matvec(s.r, v))
        if isinstance(s, tasks.LogisticState):  # A = X^T (P - H)
            pv = self._base._probs(s) @ v - v[s.y]
            return pm_ops.rmatvec(s.x, pv)
        if isinstance(s, tasks.MCState):  # A = P_Omega(W - M), COO values resid
            return mc_ops.coo_matvec(s.by_row, s.resid_by_row, v)
        return self._base.matvec(s, v)

    def rmatvec(self, s, u: torch.Tensor) -> torch.Tensor:
        if isinstance(s, tasks.MTLSState):
            return pm_ops.rmatvec(s.r, pm_ops.matvec(s.x, u))
        if isinstance(s, tasks.LogisticState):
            t = pm_ops.matvec(s.x, u)
            return self._base._probs(s).T @ t - self._base._label_sum(s, t)
        if isinstance(s, tasks.MCState):
            return mc_ops.coo_matvec(s.by_col, s.resid_by_col, u)
        return self._base.rmatvec(s, u)


def kernelize(task):
    """Wrap ``task`` so its power-iteration matvecs run through the kernels."""
    if isinstance(task, KernelizedTask):
        return task
    return KernelizedTask(task)


def verify_kernelized(task, ktask: KernelizedTask, state: PyTree, seed: int = 0,
                      *, tol: float = 1e-4) -> float:
    """Raise ``AssertionError`` unless the kernel-routed matvec/rmatvec match
    the base task's plain operator chain on random unit probes (max error
    relative to max |reference|). Returns the largest relative error."""
    device = next(t for t in state if isinstance(t, torch.Tensor)).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v = sphere_vector(gen, task.m, device)
    u = sphere_vector(gen, task.d, device)

    def rel_err(a, b):
        return torch.max(torch.abs(a - b)) / (torch.max(torch.abs(b)) + 1e-30)

    err = float(torch.maximum(
        rel_err(ktask.matvec(state, v), task.matvec(state, v)),
        rel_err(ktask.rmatvec(state, u), task.rmatvec(state, u)),
    ))
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
# Drivers
# ---------------------------------------------------------------------------


def _make_checkpointer(task, cfg: DFWConfig, comm_spec: str
                       ) -> Optional[ckpt.RunCheckpointer]:
    """The serial run's checkpointer (one worker), or None without a dir."""
    if cfg.checkpoint_dir is None:
        return None
    return ckpt.RunCheckpointer(
        cfg.checkpoint_dir,
        save_every=cfg.checkpoint_every,
        keep_last=cfg.checkpoint_keep,
        extra=ckpt.run_extra(
            task, num_workers=1, comm=comm_spec, num_epochs=cfg.num_epochs,
            schedule=cfg.schedule, mu=cfg.mu, step_size=cfg.step_size,
            sample_prob=cfg.sample_prob, reweight=cfg.reweight, solver=cfg.solver,
            topology=cfg.topology,
        ),
    )


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device`` with its dtype kept (int32 COO indices stay int32)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor or numpy array, got {type(a).__name__}")
    return a.to(device)


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
) -> DFWFitResult:
    """Single-worker DFW-Trace run on ``device`` (CUDA unless "cpu" is given).

    ``x``/``y`` are torch tensors or numpy arrays (moved to ``device``): the
    samples and targets of the dense tasks, or matrix completion's ``(idx,
    yw)`` from ``tasks.pack_observations``/``shard_observations``. ``key`` is
    an int seed or a ``repro_torch.V0Stream``; ``noise`` is the int8
    reducer's ``repro_torch.NoiseStream`` (default: seeded like ``key``).
    ``cfg.comm`` is honoured with a one-worker reducer: int8 runs at the
    full 127-level budget, the serial baseline of the compressed runs.

    The power method runs through the kernels, and with ``cfg.verify_kernels``
    that route is first held to the plain operator chain on the first 64
    rows (for matrix completion: the first 64 entries, with the full d and
    m), and under int8 the quantize pair to its plain version. ``stats``
    count the run itself (see ``core/engine.py``), not these set-up checks.

    With ``cfg.checkpoint_dir`` the run owns that directory: steps left there
    by an earlier run are removed, every ``cfg.checkpoint_every``-th segment
    boundary (and the last) is saved, the newest ``cfg.checkpoint_keep`` are
    kept, and the writer is joined before this returns.
    """
    dev = resolve_device(device)
    ktask = kernelize(task)
    x, y = _as_tensor(x, dev), _as_tensor(y, dev)
    reducer = make_reducer(cfg.comm, num_workers=1)
    if cfg.verify_kernels:
        rows = min(x.shape[0], 64)
        verify_kernelized(task, ktask, task.init_state(x[:rows], y[:rows]), seed=0x5EED)
        if isinstance(reducer, Int8Reducer):
            verify_quantize_kernels(num_workers=reducer.num_workers, device=dev)
    state = ktask.init_state(x, y)
    checkpointer = _make_checkpointer(task, cfg, reducer.spec)
    if checkpointer is not None:
        checkpointer.store.discard_after(0)
    res = frank_wolfe.fit(
        ktask,
        state,
        mu=cfg.mu,
        num_epochs=cfg.num_epochs,
        key=as_v0_stream(key),
        schedule=cfg.schedule,
        step_size=cfg.step_size,
        callback=callback,
        reducer=reducer,
        max_rank=engine.resolve_max_rank(cfg.max_rank, cfg.num_epochs),
        gap_tol=cfg.gap_tol,
        block_epochs=cfg.block_epochs,
        solver=cfg.solver,
        noise=noise,
        checkpointer=checkpointer,
        device=dev,
    )
    if checkpointer is not None:
        checkpointer.wait()
    return DFWFitResult(
        iterate=res.iterate, state=res.state, history=res.history, masks=None,
        final_loss=res.final_loss, epochs_run=res.epochs_run, stats=res.stats,
    )
