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
  ``rank_block`` multiple, exact no-ops in the kernel. ``stats
  ["compilations"]`` counts the buckets the engine has prepared (the
  counterpart of the reference's ahead-of-time executables); a swap inside
  a prepared bucket adds none.
- **Hot-swap.** ``load`` stages the new factors on the device, then
  republishes the engine's model reference. A batch already dispatched
  finishes against the factors it was dispatched with: everything runs on
  one stream in order, and its ``PendingScores`` holds a reference to its
  ``Model`` until ``block()``, so the caching allocator cannot hand the old
  factors' memory to anything else meanwhile.

``score_async`` makes no implicit device-to-host sync: the request goes to
the device from pinned memory without waiting, and ``PendingScores.block()``
is the one device-to-host copy. The engine runs on CUDA unless it is given
``device="cpu"`` (the plain PyTorch version, for tests). On the first load
``verify_factor_kernels`` holds the kernel route to the dense product.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..checkpoint import dfw as ckpt
from ..checkpoint.store import CheckpointStore
from ..core import low_rank
from ..kernels.factor_matvec import ops as fm_ops
from ..kernels.factor_matvec import ref as fm_ref
from ..specs import NotYetPorted

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
    plain version, and the kernel has no out-axis tile); ``telemetry`` is
    not yet ported and must stay None.
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
        if self.telemetry is not None:
            raise NotYetPorted("ServeConfig.telemetry: telemetry is not yet ported to PyTorch")


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
    """

    __slots__ = ("raw", "n", "version", "step", "_model", "_host")

    def __init__(self, raw: torch.Tensor, n: int, model: Model):
        self.raw = raw
        self.n = n
        self.version = model.version
        self.step = model.step
        self._model: Optional[Model] = model
        self._host: Optional[np.ndarray] = None

    def block(self) -> np.ndarray:
        if self._host is None:
            self._host = self.raw[: self.n].cpu().numpy()
            self._model = None
        return self._host


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
    reference's counters: ``compilations`` (rank buckets prepared),
    ``dispatches``, ``loads`` and ``requests`` (caller rows, padding
    excluded).
    """

    def __init__(self, d: int, m: int, cfg: ServeConfig = ServeConfig(), *,
                 device: DeviceLike = None):
        self.d, self.m = int(d), int(m)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_in = self.m if cfg.transpose else self.d
        self.n_out = self.d if cfg.transpose else self.m
        self._model: Optional[Model] = None
        self._buckets: set = set()
        self._verified = not cfg.verify_kernels
        self._stats = dict.fromkeys(("compilations", "dispatches", "loads", "requests"), 0)

    @property
    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def _prepare(self, capacity: int) -> None:
        """Count a rank bucket the first time a model lands in it."""
        if capacity not in self._buckets:
            self._buckets.add(capacity)
            self._stats["compilations"] += 1

    # --------------------------------------------------------------- load
    def load(self, source: ModelSource, *, step: Optional[int] = None) -> Model:
        """Publish a model (first load or hot-swap) from a ``FactoredIterate``,
        a ``pack_live`` dict, or a run-checkpoint directory/store (``step``
        None: its latest step). The factors reach the device and their
        bucket is prepared before the model reference flips; batches already
        dispatched keep the old factors."""
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
        self._prepare(capacity)
        self._model = model
        self._stats["loads"] += 1
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
        cannot retarget it.
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
        pad = torch.zeros((self.cfg.max_batch, self.n_in), dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        pad[:b] = torch.from_numpy(xh)
        xd = pad.to(self.device, non_blocking=True)
        if self.cfg.transpose:
            raw = fm_ops.factor_matvec(xd, model.v, model.s_alpha, model.u)
        else:
            raw = fm_ops.factor_matvec(xd, model.u, model.s_alpha, model.v)
        self._stats["dispatches"] += 1
        self._stats["requests"] += b
        return PendingScores(raw, b, model)

    def score(self, x) -> np.ndarray:
        """``score_async(x).block()``."""
        return self.score_async(x).block()

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
