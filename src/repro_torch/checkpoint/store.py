"""Checkpoint store with atomic steps and an asynchronous writer, in the JAX
package's on-disk layout:

    <dir>/step_<N:08d>/
        manifest.json    format, step, extra, treedef (null), and per leaf
                         its file, path, shape and dtype, in payload order
        leaf_<i:05d>.npy one numpy file per leaf

A payload is an ordered mapping of leaf path ("carry/iterate/u") to array
(numpy arrays, torch tensors on any device, or scalars; a list of tensors
is stacked on the host along a new first axis, as the JAX package's LM
layers are stacked); the order of the mapping is the order of the leaves.
A bfloat16 leaf is written as the JAX package writes one (raw 2-byte
records, manifest dtype "bfloat16") and read back as such records
(``convert`` turns them into bf16 tensors). ``treedef`` is written as null: the JAX
package encodes it with jax, and its readers of run checkpoints map leaves by
order and path, never through it.

- **Atomic steps.** A step is assembled under ``.tmp_step_<N>`` and renamed
  into place, so ``steps``/``latest_step`` and every reader only see
  complete steps. Saving a step id again renames the durable copy aside
  (``.old_step_<N>``), the new one in, then drops the aside; opening a store
  puts back an aside whose replacement never landed.
- **Async writes.** ``save_async`` copies every leaf to host memory at once
  (the only wait on the device) and writes on one daemon thread; at most
  one write is in flight. A failed write is raised again, with its step and
  path, by the next ``wait()`` (which every save calls first).
- **Retention.** ``keep_last=N`` prunes older complete steps after each
  write, on the writer thread.

Readers (``read_leaves``, and ``checkpoint.dfw``'s readers given a path)
list and load steps without opening a store, so a serving process that
follows a training run's directory never renames anything in it; a resume
reads its step the same way (``checkpoint.dfw.restore_run``).

``telemetry`` (an ``obs.Telemetry``; the inert no-op when None) records the
reference's events: a ``checkpoint.snapshot`` span around the copy to the
host, a ``checkpoint.write`` span (step, bytes) with the
``checkpoint.write_us`` histogram and the ``checkpoint.saves`` and
``checkpoint.bytes`` counters once a write has landed (on the writer
thread, through the handle's thread-safe append), a ``checkpoint.prune``
event (steps, keep) and a ``checkpoint.restore`` span (``restore``).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..obs import Telemetry

# Manifest schema version, the JAX package's: readers reject a newer one.
MANIFEST_FORMAT = 1

Leaves = Mapping[str, object]


def step_dir(directory: Union[str, Path], step: int) -> Path:
    return Path(directory) / f"step_{step:08d}"


def list_steps(directory: Union[str, Path]) -> List[int]:
    """Sorted complete steps under ``directory`` (``.tmp_``/``.old_`` steps
    never match); empty when the directory does not exist."""
    return sorted(
        int(p.name.split("_")[1]) for p in Path(directory).glob("step_*") if p.is_dir()
    )


def read_manifest(directory: Union[str, Path], step: Optional[int] = None) -> dict:
    """The manifest of ``step`` (default: the latest complete step)."""
    if step is None:
        steps = list_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    manifest = json.loads((step_dir(directory, step) / "manifest.json").read_text())
    fmt = manifest.get("format", 0)
    if fmt > MANIFEST_FORMAT:
        raise ValueError(
            f"checkpoint {step_dir(directory, step)} has manifest format {fmt}; this "
            f"build reads <= {MANIFEST_FORMAT}"
        )
    return manifest


def read_leaves(
    directory: Union[str, Path], step: Optional[int] = None, *, prefix: str = ""
) -> Tuple[int, Dict[str, np.ndarray], dict]:
    """(step, {path: array} of the leaves whose path starts with ``prefix``,
    in payload order, extra) of ``step`` (default: the latest)."""
    manifest = read_manifest(directory, step)
    src = step_dir(directory, manifest["step"])
    leaves = {
        rec["path"]: np.load(src / rec["file"])
        for rec in manifest["leaves"]
        if rec["path"].startswith(prefix)
    }
    return manifest["step"], leaves, manifest.get("extra", {})


BF16_RECORD = np.dtype("V2")  # how numpy stores (and np.load reads) a bfloat16 leaf


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot change."""
    if isinstance(leaf, (list, tuple)):
        return np.stack([_host(part) for part in leaf])
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_RECORD)
        return host.numpy()
    return np.array(leaf, copy=True)


def _dtype_name(leaf: np.ndarray) -> str:
    return "bfloat16" if leaf.dtype == BF16_RECORD else str(leaf.dtype)


class CheckpointStore:
    def __init__(self, directory: Union[str, Path], *, keep_last: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last={keep_last}: must be >= 1 (or None)")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.telemetry = telemetry if telemetry is not None else Telemetry.noop()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Tuple[int, Path, BaseException]] = None
        # A crash inside _write's overwrite window leaves .old_step_X with
        # no step_X: the aside copy is complete, so it goes back. Beside a
        # step_X it is garbage.
        for old in self.dir.glob(".old_step_*"):
            target = self.dir / old.name[len(".old_"):]
            if old.is_dir() and not target.exists():
                old.rename(target)
            else:
                shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, leaves: Leaves, *, extra: Optional[dict] = None) -> Path:
        """Write ``step`` now; returns its directory."""
        self.wait()
        host = self._snapshot(step, leaves)
        t0 = self.telemetry.now_us()
        out = self._write(step, host, extra or {})
        self._record_write(step, host, t0)
        self._prune(keep=step)
        return out

    def _snapshot(self, step: int, leaves: Leaves) -> Dict[str, np.ndarray]:
        with self.telemetry.span("checkpoint.snapshot", "checkpoint", step=step):
            return {path: _host(leaf) for path, leaf in leaves.items()}

    def _record_write(self, step: int, host: Dict[str, np.ndarray], t0_us: float) -> None:
        """Stamp one landed write (on the thread that wrote it): the span from
        ``t0_us``, when the write began, the latency histogram, the counters."""
        tel = self.telemetry
        if not tel.enabled:
            return
        dur = tel.now_us() - t0_us
        nbytes = sum(int(a.nbytes) for a in host.values())
        tel.complete("checkpoint.write", "checkpoint", t0_us, dur, step=step, bytes=nbytes)
        tel.registry.histogram("checkpoint.write_us").observe(dur)
        tel.registry.counter("checkpoint.saves").inc()
        tel.registry.counter("checkpoint.bytes").inc(nbytes)

    def save_async(self, step: int, leaves: Leaves, *, extra: Optional[dict] = None) -> None:
        """Copy the leaves to host memory now, write them on a background
        thread. A write failure is raised by the next ``wait()`` (or save):
        call ``wait()`` once after the last save."""
        self.wait()
        host = self._snapshot(step, leaves)

        def _run():
            try:
                t0 = self.telemetry.now_us()
                self._write(step, host, extra or {})
                self._record_write(step, host, t0)
                self._prune(keep=step)
            except BaseException as e:  # noqa: BLE001 - handed to wait()
                self._error = (step, step_dir(self.dir, step), e)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; raise its failure with step and path
        (the original exception rides as ``__cause__``)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            (step, path, err), self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write for step {step} failed at {path}: "
                f"{type(err).__name__}: {err}"
            ) from err

    def _prune(self, keep: int) -> None:
        """Drop complete steps older than the ``keep_last`` newest, always
        keeping ``keep`` (the step just written)."""
        if self.keep_last is None:
            return
        steps = [s for s in self.steps() if s != keep]
        dropped = steps[: max(0, len(steps) + 1 - self.keep_last)]
        for s in dropped:
            shutil.rmtree(step_dir(self.dir, s), ignore_errors=True)
        if dropped:
            self.telemetry.event("checkpoint.prune", "checkpoint", steps=dropped, keep=keep)

    def _write(self, step: int, host: Dict[str, np.ndarray], extra: dict) -> Path:
        out = step_dir(self.dir, step)
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            for f in tmp.iterdir():
                f.unlink()
        tmp.mkdir(parents=True, exist_ok=True)
        manifest = {"format": MANIFEST_FORMAT, "step": step, "extra": extra,
                    "treedef": None, "leaves": []}
        for i, (path, leaf) in enumerate(host.items()):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, leaf)
            manifest["leaves"].append(
                {"file": fname, "path": path, "shape": list(leaf.shape),
                 "dtype": _dtype_name(leaf)}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if out.exists():
            # POSIX cannot swap two non-empty directories atomically: rename
            # the durable copy aside, the complete replacement in, then drop
            # the aside. Both copies exist on disk throughout.
            old = self.dir / f".old_step_{step:08d}"
            if old.exists():
                shutil.rmtree(old)
            out.rename(old)
            tmp.rename(out)
            shutil.rmtree(old, ignore_errors=True)
        else:
            tmp.rename(out)
        return out

    # ------------------------------------------------------------------ read
    def steps(self) -> List[int]:
        """Sorted complete steps; a ``.tmp_`` step is invisible here."""
        return list_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, prefix: str = ""
                ) -> Tuple[int, Dict[str, np.ndarray], dict]:
        """``read_leaves`` of ``step`` (default: the latest) in this store,
        as a ``checkpoint.restore`` span."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with self.telemetry.span("checkpoint.restore", "checkpoint", step=step):
            return read_leaves(self.dir, step, prefix=prefix)

    def discard_after(self, step: int) -> None:
        """Remove complete steps newer than ``step``: a run that writes into
        this directory from epoch ``step`` owns it from there, so a later
        default (latest-step) read never sees another run's tail."""
        self.wait()
        for s in self.steps():
            if s > step:
                shutil.rmtree(step_dir(self.dir, s), ignore_errors=True)
