"""Factor-form serving engine, the port's counterpart of ``repro.serve.engine``.

Training keeps the model as the factor triple ``W = alpha * U^T diag(s) V``
of rank <= T; this engine scores requests against those factors,
``x @ W = alpha * ((x @ U^T) * s) @ V``, through the hand-written
``factor_matvec`` kernel, so scoring costs O(batch * rank * (d + m)) and
the dense d x m matrix is never formed.

The reference's three serving contracts carry over:

- **Padded static batches.** Every dispatch scores exactly ``max_batch``
  rows (zero padding; callers get their rows back), so the work per
  dispatch does not depend on the batch fill.
- **Live-rank buckets.** A model loads through ``low_rank.pack_live``: a
  t-epoch iterate ships t factors, padded with s = 0 rows up to the next
  ``rank_block`` multiple, exact no-ops in the kernel. Each bucket has
  static factor slots at its capacity and, on CUDA, one captured scorer: a
  CUDA graph of ``factor_matvec`` (the hand-written kernel) on those slots
  and the engine's static padded input, the counterpart of the reference's
  ahead-of-time executable per bucket. ``stats["compilations"]`` counts the
  buckets prepared (on CUDA, the graphs captured); a swap inside a prepared
  bucket adds none.
- **Hot-swap.** ``load`` stages the new factors on the device, copies them
  into their bucket's slots on the serving stream (the current stream,
  which every dispatch's staging and replay go on too), then republishes
  the engine's model reference. A batch already dispatched finishes against
  the factors it was dispatched with: the stream runs in order, so its
  replay, and the copy of its scores out of the bucket's static output,
  come before the slots are overwritten.

``score_async`` makes no implicit device-to-host sync (``contract()``): the
request goes to the static input from pinned memory without waiting, the
bucket's graph is replayed, and the scores are copied on the device into a
fresh tensor, so a later dispatch cannot overwrite them;
``PendingScores.block()`` is the one device-to-host copy. The engine runs
on CUDA unless it is given ``device="cpu"`` (the plain PyTorch version,
uncaptured, for tests). On the first load ``verify_factor_kernels`` holds
the kernel route to the dense product.

Each bucket keeps the op log (``analysis.recorder``) of its scorer: on CUDA
the capture, which every replay runs; on the CPU one run of the scorer on
the bucket's fresh (zero) slots when the bucket is made.
``check_contract()`` holds every bucket's log to ``contract()``'s
``forbid_shapes`` (no d x m or m x d tensor) and ``stats`` to its caps.

``ServeConfig(telemetry=obs.Telemetry())`` records the reference's events:
``serve.compile`` (a bucket's preparation: its capture on CUDA),
``serve.executable`` (what the bucket's op log shows, with
``telemetry.wants_hlo``), ``serve.load``, ``serve.hot_swap`` (every load
after the first), and for each batch a ``serve.dispatch`` span from
``score_async`` to the end of its ``block()``, with the ``serve.latency_us``
histogram, stamped on the host. ``stats`` is a view of the registry's
``serve.*`` counters (the handle's; a private registry when telemetry is
off, so engines never share counters).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..analysis.contracts import Contract
from ..checkpoint import dfw as ckpt
from ..checkpoint.store import CheckpointStore
from ..core import cuda_graph, low_rank
from ..kernels.factor_matvec import ops as fm_ops
from ..analysis.recorder import OpRecorder
from ..kernels.factor_matvec import ref as fm_ref
from ..obs import MetricsRegistry, Telemetry

ModelSource = Union[low_rank.FactoredIterate, Dict[str, Any], CheckpointStore, str, Path]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of one serving engine, with the reference's field names.

    ``max_batch`` is the padded static batch of every dispatch;
    ``rank_block`` the live-rank bucket width. ``transpose=False`` scores
    ``x @ W`` (d-vectors in, m scores out); ``transpose=True`` scores
    ``x @ W^T`` (m -> d). ``verify_kernels`` runs ``verify_factor_kernels``
    at the first load. The reference's ``use_pallas``/``interpret``/
    ``block_o`` have no counterpart (the tensors' device picks kernel or
    plain version, and the kernel has no out-axis tile). ``telemetry`` (an
    ``obs.Telemetry``; None: the inert no-op) records the engine (the
    module doc).
    """

    max_batch: int = 64
    rank_block: int = 32
    transpose: bool = False
    verify_kernels: bool = True
    telemetry: Optional[Any] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch}: must be >= 1")
        if self.rank_block < 1:
            raise ValueError(f"rank_block={self.rank_block}: must be >= 1")


class Model:
    """One loaded model version: capacity-padded device factors and metadata.
    Never changed after it is built; a swap builds a new one."""

    __slots__ = ("u", "s", "v", "alpha", "s_alpha", "live_rank", "capacity", "version",
                 "step")

    def __init__(self, *, u, s, v, alpha, live_rank, capacity, version, step):
        self.u = u  # (capacity, d) on the device
        self.s = s  # (capacity,); rows >= live_rank are 0
        self.v = v  # (capacity, m)
        self.alpha = alpha  # () on the device
        self.s_alpha = s * alpha  # what a dispatch scales by, taken once
        self.live_rank = int(live_rank)
        self.capacity = int(capacity)
        self.version = int(version)
        self.step = step  # checkpoint step or None


class PendingScores:
    """A dispatched batch, on the device until ``block()``.

    ``raw`` is the (max_batch, n_out) result; ``block()`` copies the
    caller's ``n`` rows to the host once (cached) and releases the model
    the batch was scored against. ``version``/``step`` name that model.
    With an enabled ``telemetry`` the first ``block()`` records the batch's
    ``serve.dispatch`` span from ``t0_us`` and its latency in ``latency``
    (the ``serve.latency_us`` histogram).
    """

    __slots__ = ("raw", "n", "version", "step", "_model", "_host", "_tel", "_t0", "_hist")

    def __init__(self, raw: torch.Tensor, n: int, model: Model,
                 telemetry: Optional[Telemetry] = None, t0_us: float = 0.0, latency=None):
        self.raw = raw
        self.n = n
        self.version = model.version
        self.step = model.step
        self._model: Optional[Model] = model
        self._host: Optional[np.ndarray] = None
        self._tel = telemetry
        self._t0 = t0_us
        self._hist = latency

    def block(self) -> np.ndarray:
        if self._host is None:
            self._host = self.raw[: self.n].cpu().numpy()
            self._model = None
            tel = self._tel
            if tel is not None and tel.enabled:
                dur = tel.now_us() - self._t0
                tel.complete("serve.dispatch", "serve", self._t0, dur, n=self.n,
                             version=self.version)
                self._hist.observe(dur)
        return self._host


class _Bucket:
    """One rank capacity's scorer: static factor slots ``a`` (capacity,
    n_in), ``s`` (capacity,) and ``b`` (capacity, n_out) that ``load``
    copies a model into (u, s * alpha, v; v and u when transposed), and on
    CUDA the captured ``factor_matvec`` on them and the engine's static
    input, which writes ``out``; ``log`` is the scorer's op log (the
    capture's on CUDA)."""

    __slots__ = ("a", "s", "b", "graph", "out", "log")

    def __init__(self, capacity: int, n_in: int, n_out: int, device: torch.device):
        self.a = torch.zeros((capacity, n_in), dtype=torch.float32, device=device)
        self.s = torch.zeros((capacity,), dtype=torch.float32, device=device)
        self.b = torch.zeros((capacity, n_out), dtype=torch.float32, device=device)
        self.graph = self.out = self.log = None


def rank_bucket(live_rank: int, rank_block: int) -> int:
    """Smallest ``rank_block`` multiple >= max(live_rank, 1): the capacity
    serving this live rank. Rank 0 shares the first bucket (all s are 0, so
    it scores exact zeros)."""
    return rank_block * max(1, -(-live_rank // rank_block))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _as_packed(source: ModelSource, step: Optional[int]):
    """A model source as (host packed dict, step, extra)."""
    if isinstance(source, low_rank.FactoredIterate):
        return low_rank.pack_live(source), None, {}
    if isinstance(source, dict):
        missing = [k for k in low_rank.PACKED_KEYS if k not in source]
        if missing:
            raise ValueError(f"packed iterate dict is missing {missing}")
        return {k: _host(source[k]) for k in low_rank.PACKED_KEYS}, None, {}
    if isinstance(source, (CheckpointStore, str, Path)):
        step, packed, extra = ckpt.read_iterate_packed(source, step)
        return packed, step, extra
    raise TypeError(
        f"cannot load a model from {type(source).__name__}; pass a FactoredIterate, "
        "a pack_live dict, or a checkpoint store/directory"
    )


class ServingEngine:
    """Score request batches against a hot-swappable factored model of a
    fixed shape (d, m) on ``device`` (CUDA unless "cpu" is given).

    ``load`` is both first load and hot-swap. ``score``/``score_async``
    take 1..max_batch requests of dimension ``n_in`` (d, or m when
    ``transpose``) and return ``n_out`` scores each. ``stats`` has the
    reference's counters: ``compilations`` (rank buckets prepared: on CUDA
    the scorers captured), ``dispatches``, ``loads`` and ``requests``
    (caller rows, padding excluded), read from the ``serve.*`` counters of
    the telemetry's registry (a private one when telemetry is off).
    ``timings`` holds each capture's host ms (``capture_ms``) and the bytes
    of graph pool it reserved (``pool_bytes``), in the order the buckets
    were prepared.
    """

    def __init__(self, d: int, m: int, cfg: ServeConfig = ServeConfig(), *,
                 device: DeviceLike = None):
        self.d, self.m = int(d), int(m)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_in = self.m if cfg.transpose else self.d
        self.n_out = self.d if cfg.transpose else self.m
        self._model: Optional[Model] = None
        self._buckets: Dict[int, _Bucket] = {}
        self._verified = not cfg.verify_kernels
        self.telemetry = cfg.telemetry if cfg.telemetry is not None else Telemetry.noop()
        # the disabled handle's registry is the shared no-op one: counting
        # there would merge every engine's counters, so each gets its own
        reg = self.telemetry.registry if self.telemetry.enabled else MetricsRegistry()
        self._counters = {k: reg.counter(f"serve.{k}")
                          for k in ("compilations", "dispatches", "loads", "requests")}
        self._latency = reg.histogram("serve.latency_us")
        self.timings: Dict[str, list] = {"capture_ms": [], "pool_bytes": []}
        # the static padded input every bucket's scorer reads
        self._x = torch.zeros((cfg.max_batch, self.n_in), dtype=torch.float32,
                              device=self.device)
        self._stream = self._pool = None  # the captures' stream and graph pool

    @property
    def stats(self) -> Dict[str, int]:
        """The registry's counters, as ints (the reference's four keys)."""
        return {k: int(c.value) for k, c in self._counters.items()}

    def _prepare(self, capacity: int) -> _Bucket:
        """The rank bucket of ``capacity``, made the first time a model lands
        in it: its slots, its scorer's op log and, on CUDA, its captured
        scorer."""
        bucket = self._buckets.get(capacity)
        if bucket is None:
            tel = self.telemetry
            t0 = tel.now_us()
            bucket = _Bucket(capacity, self.n_in, self.n_out, self.device)
            rec = OpRecorder()
            if self.device.type == "cuda":
                self._capture(bucket, rec)
            else:
                with rec:
                    fm_ops.factor_matvec(self._x, bucket.a, bucket.s, bucket.b)
            bucket.log = rec.analyze()
            self._buckets[capacity] = bucket
            self._counters["compilations"].inc()
            tel.complete("serve.compile", "serve", t0, tel.now_us() - t0, capacity=capacity,
                         max_batch=self.cfg.max_batch,
                         capture_ms=self.timings["capture_ms"][-1] if bucket.graph else None)
            if tel.wants_hlo:
                tel.event("serve.executable", "serve", capacity=capacity,
                          captured=bucket.graph is not None, ops=bucket.log["ops"],
                          op_count=bucket.log["op_count"],
                          largest_output=max((int(np.prod(s)) for s in bucket.log["shapes"]),
                                             default=0))
        return bucket

    def _capture(self, bucket: _Bucket, rec: OpRecorder) -> None:
        """Capture ``factor_matvec`` on the bucket's slots and the static
        input into one CUDA graph (under ``rec``, which logs the capture),
        after one launch outside the capture (the kernel's attributes are
        set on its first launch at a shape)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

        def score():
            return fm_ops.factor_matvec(self._x, bucket.a, bucket.s, bucket.b)

        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            score()
        out = []
        with rec:
            graph, capture_ms, pool_bytes = cuda_graph.capture(
                lambda: out.append(score()), stream=self._stream, pool=self._pool)
        bucket.graph, bucket.out = graph, out[0]
        self.timings["capture_ms"].append(capture_ms)
        self.timings["pool_bytes"].append(pool_bytes)

    # --------------------------------------------------------------- load
    def load(self, source: ModelSource, *, step: Optional[int] = None) -> Model:
        """Publish a model (first load or hot-swap) from a ``FactoredIterate``,
        a ``pack_live`` dict, or a run-checkpoint directory/store (``step``
        None: its latest step). The factors reach the device, their bucket
        is prepared and they are copied into its slots on the serving stream
        before the model reference flips; batches already dispatched keep
        the old factors (the stream runs in order)."""
        tel = self.telemetry
        t0 = tel.now_us()
        packed, ck_step, extra = _as_packed(source, step)
        if extra:
            got = (int(extra.get("d", -1)), int(extra.get("m", -1)))
            if got != (self.d, self.m):
                raise ValueError(
                    f"checkpoint model is {got[0]}x{got[1]} but this engine serves "
                    f"{self.d}x{self.m}"
                )
        live = int(np.asarray(packed["count"]))
        capacity = rank_bucket(live, self.cfg.rank_block)
        padded = low_rank.unpack_live(packed, capacity, device=self.device)
        if padded.u.shape[1] != self.d or padded.v.shape[1] != self.m:
            raise ValueError(
                f"model factors are {padded.u.shape[1]}x{padded.v.shape[1]} but this "
                f"engine serves {self.d}x{self.m}"
            )
        model = Model(
            u=padded.u, s=padded.s, v=padded.v, alpha=padded.alpha, live_rank=live,
            capacity=capacity, version=(self._model.version + 1) if self._model else 0,
            step=ck_step,
        )
        self._verify_once()
        bucket = self._prepare(capacity)
        a, b = (model.v, model.u) if self.cfg.transpose else (model.u, model.v)
        bucket.a.copy_(a)
        bucket.s.copy_(model.s_alpha)
        bucket.b.copy_(b)
        self._model = model
        self._counters["loads"].inc()
        tel.complete("serve.load", "serve", t0, tel.now_us() - t0, version=model.version,
                     step=model.step, live_rank=live, capacity=capacity)
        if model.version > 0:
            tel.event("serve.hot_swap", "serve", version=model.version, step=model.step,
                      live_rank=live, capacity=capacity)
        return model

    @classmethod
    def from_checkpoint(cls, store: Union[CheckpointStore, str, Path],
                        cfg: ServeConfig = ServeConfig(), *, step: Optional[int] = None,
                        device: DeviceLike = None) -> "ServingEngine":
        """An engine sized from a run checkpoint's manifest, with that
        checkpoint loaded."""
        _, extra = ckpt.read_run_extra(store, step)
        eng = cls(int(extra["d"]), int(extra["m"]), cfg, device=device)
        eng.load(store, step=step)
        return eng

    # -------------------------------------------------------------- score
    @property
    def model(self) -> Model:
        if self._model is None:
            raise RuntimeError("no model loaded; call load() first")
        return self._model

    def score_async(self, x) -> PendingScores:
        """Dispatch one padded batch; returns without waiting for the device.

        ``x`` is (b, n_in) with 1 <= b <= max_batch, or one (n_in,) request.
        The handle is bound to the model of this moment: a later ``load``
        cannot retarget it. The rows go through pinned memory into the
        static input (zero padding), the model's bucket scores them (a graph
        replay on CUDA) and the scores are copied into a fresh device
        tensor, all enqueued on the current stream without waiting.
        """
        model = self.model
        xh = np.asarray(x, np.float32)
        if xh.ndim == 1:
            xh = xh[None, :]
        b, n_in = xh.shape
        if n_in != self.n_in:
            raise ValueError(
                f"requests have dim {n_in}; this engine scores "
                f"{'m' if self.cfg.transpose else 'd'}={self.n_in}-vectors"
            )
        if not 1 <= b <= self.cfg.max_batch:
            raise ValueError(
                f"batch of {b} exceeds max_batch={self.cfg.max_batch}; split it "
                "(serve.MicroBatcher does this)"
            )
        bucket = self._buckets[model.capacity]
        cuda = self.device.type == "cuda"
        pad = torch.empty((self.cfg.max_batch, self.n_in), dtype=torch.float32, pin_memory=cuda)
        staged = pad.numpy()
        staged[:b] = xh
        staged[b:] = 0.0
        t0 = self.telemetry.now_us()
        self._x.copy_(pad, non_blocking=cuda)
        if bucket.graph is not None:
            bucket.graph.replay()
            raw = bucket.out.clone()
        else:
            raw = fm_ops.factor_matvec(self._x, bucket.a, bucket.s, bucket.b)
        self._counters["dispatches"].inc()
        self._counters["requests"].inc(b)
        return PendingScores(raw, b, model, self.telemetry, t0, self._latency)

    def score(self, x) -> np.ndarray:
        """``score_async(x).block()``."""
        return self.score_async(x).block()

    # ----------------------------------------------------------- contract
    def contract(self, *, max_compilations: Optional[int] = None) -> Contract:
        """The serving layer's declared invariant (``analysis.contracts``):
        no scorer makes a d x m (or m x d) tensor, so scoring stays factored,
        O(rank (d + m)) a request; the request path makes no implicit
        device-to-host transfer (``score_async`` under ``Contract.guard()``
        raises on one); ``max_compilations`` optionally pins the
        no-recapture guarantee, one scorer a rank bucket."""
        return Contract(name=f"serve.never_materialize[{self.d}x{self.m}]",
                        forbid_shapes=((self.d, self.m), (self.m, self.d)),
                        max_compilations=max_compilations, no_host_transfers=True)

    def check_contract(self, contract: Optional[Contract] = None) -> Contract:
        """Assert ``contract`` (default: ``self.contract()``) against every
        bucket's scorer log (its op-log clauses) and the engine's counters.
        Raises ``ContractViolation`` naming the op or counter on failure."""
        c = contract if contract is not None else self.contract()
        for bucket in self._buckets.values():
            c.check_ops(bucket.log)
        c.check_stats(self.stats)
        return c

    # ------------------------------------------------------------- verify
    def _verify_once(self) -> None:
        if self._verified:
            return
        verify_factor_kernels(d=self.d, m=self.m, device=self.device)
        self._verified = True


def verify_factor_kernels(*, d: int, m: int, device: DeviceLike = None, rank: int = 6,
                          batch: int = 4, seed: int = 0x5E12, tol: float = 1e-4) -> float:
    """Raise ``AssertionError`` unless ``factor_matvec`` on ``device`` matches
    the dense materialised product on a random probe triple of min(d, 96) x
    min(m, 96), in both scoring directions (max error relative to max
    |dense|). Returns the largest relative error."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dd, mm = min(d, 96), min(m, 96)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    a, s, b = rn(rank, dd), rn(rank), rn(rank, mm)
    x_d, x_m = rn(batch, dd), rn(batch, mm)

    def rel_err(got, want):
        return torch.max(torch.abs(got - want)) / (torch.max(torch.abs(want)) + 1e-30)

    err = float(torch.maximum(
        rel_err(fm_ops.factor_matvec(x_d, a, s, b), fm_ref.dense_matvec(x_d, a, s, b)),
        rel_err(fm_ops.factor_matvec(x_m, b, s, a), fm_ref.dense_matvec(x_m, b, s, a)),
    ))
    if not err <= tol:
        raise AssertionError(
            f"factor_matvec diverges from the dense product: rel err {err:.3e} > tol {tol:.1e}"
        )
    return err
