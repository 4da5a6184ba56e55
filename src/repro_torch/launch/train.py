"""Training driver: data -> train step -> async checkpoints -> restart, the
port's counterpart of ``repro.launch.train``.

- Restart-safe: the data stream is a pure function of the step counter
  (``data.SyntheticLMStream``), and a checkpoint holds the parameters and
  the AdamW state, so a run resumed at step k gives the uninterrupted run's
  bits (the embedding's and the loss's gradients are summed without
  atomics on the card; ``models.lm``).
- Async checkpoints through ``checkpoint.store.CheckpointStore``:
  ``save_async`` every ``ckpt_every`` steps, ``save`` at the end. The leaves
  are written in the reference's layout: ``opt/step``, ``opt/m/<path>``,
  ``opt/v/<path>``, ``params/<path>``, parameter paths in sorted key order
  and each layer leaf stacked over the layers, so this store reads a JAX
  ``train`` checkpoint (f32 or bf16 leaves) and the JAX package reads this
  one.
- ``--mesh`` (the reference's elastic, sharded run) waits with the sharded
  LM paths (ROADMAP section 1, Sharded LM paths) and raises ``NotYetPorted``.

Runs on the card unless ``device="cpu"`` (``--device cpu``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import DeviceLike, convert, resolve_device
from ..checkpoint import CheckpointStore
from ..configs import get_config
from ..data import SyntheticLMStream, device_put_batch
from ..models import lm
from ..models.config import ModelConfig, ShapeSpec
from ..optim import adamw
from ..specs import NotYetPorted
from .steps import make_train_step


def build(cfg: ModelConfig, shape: ShapeSpec, mesh=None, *, peak_lr: float = 3e-4,
          seed: int = 0, device: DeviceLike = None):
    """Returns ``(init_fn, step_fn, shardings)``: ``init_fn() -> (params,)``
    draws the weights from ``seed`` on the device, ``step_fn`` is
    ``make_train_step``'s, ``shardings`` None (no mesh)."""
    if mesh is not None:
        raise NotYetPorted("a sharded (mesh) train run is not yet ported to PyTorch "
                           "(ROADMAP section 1, Sharded LM paths)")
    dev = resolve_device(device)
    step = make_train_step(cfg, peak_lr=peak_lr)
    return (lambda: (lm.init_params(cfg, seed, device=dev),), step, None)


def _tree_paths(tree, prefix: str) -> Dict[str, object]:
    """``{path: leaf}`` in the reference's leaf order (dict keys sorted); the
    per-layer list ``layers`` becomes one list of layer tensors a path, which
    the store stacks on the host."""
    out: Dict[str, object] = {}
    for k in sorted(tree):
        sub = tree[k]
        if k == "layers":
            for path in _tree_paths(sub[0], ""):
                parts = path.split("/")

                def pick(lp, parts=parts):
                    for part in parts:
                        lp = lp[part]
                    return lp

                out[f"{prefix}{k}/{path}"] = [pick(lp) for lp in sub]
        elif isinstance(sub, dict):
            out.update(_tree_paths(sub, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = sub
    return out


def train_leaves(params, opt: adamw.AdamWState) -> Dict[str, object]:
    """The checkpoint payload of a train run, in the reference's order."""
    return {"opt/step": opt.step, **_tree_paths(opt.m, "opt/m/"),
            **_tree_paths(opt.v, "opt/v/"), **_tree_paths(params, "params/")}


def _nest(leaves: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, a in leaves.items():
        node = tree
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = a
    return tree


def restore(store: CheckpointStore, cfg: ModelConfig, *, step: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[int, dict, adamw.AdamWState]:
    """``(step, params, opt)`` of a train checkpoint (the latest by default),
    written by this module or by the JAX package's ``train``."""
    dev = resolve_device(device)
    at, leaves, _ = store.restore(step)
    tree = _nest(leaves)
    return (at, convert.lm_params(tree["params"], cfg, device=dev),
            convert.adamw_state(tree["opt"], cfg, device=dev))


def train(*, arch: str, steps: int, smoke: bool = True, seq_len: int = 128,
          global_batch: int = 8, mesh_shape: Optional[Tuple[int, int]] = None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50, peak_lr: float = 3e-4,
          log_every: int = 10, resume: bool = True, device: DeviceLike = None,
          cfg: Optional[ModelConfig] = None, params: Optional[dict] = None,
          seed: int = 0, callback: Optional[Callable[[int, dict], None]] = None):
    """Train ``arch`` (its smoke config unless ``smoke=False``; ``cfg`` in
    its place, e.g. a depth cut) for ``steps`` steps of ``global_batch`` x
    ``seq_len`` tokens. Returns ``(params, opt, history)``, history the
    ``(step, loss)`` pairs logged every ``log_every`` steps and at the
    first. ``params`` are the starting weights (default: drawn from
    ``seed``; a resume reads the checkpoint's instead). ``callback(step,
    metrics)``, when given, sees each step's metrics (on the device)."""
    if mesh_shape is not None:
        raise NotYetPorted("--mesh: a sharded train run is not yet ported to PyTorch "
                           "(ROADMAP section 1, Sharded LM paths)")
    cfg = cfg if cfg is not None else get_config(arch, smoke=smoke)
    lm.check_trains(cfg)
    dev = resolve_device(device)
    shape = ShapeSpec("train_custom", "train", seq_len, global_batch)
    init_fn, step_fn, _ = build(cfg, shape, peak_lr=peak_lr, seed=seed, device=dev)
    stream = SyntheticLMStream(cfg, shape)
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None

    start = 0
    if store is not None and resume and store.latest_step() is not None:
        start, params, opt = restore(store, cfg, device=dev)
        print(f"[train] resumed from step {start}")
    else:
        if params is None:
            (params,) = init_fn()
        opt = adamw.init(params)

    history = []
    t0 = time.time()
    for step in range(start, steps):
        batch = device_put_batch(stream.batch_for_step(step), dev)
        params, opt, metrics = step_fn(params, opt, batch)
        if callback is not None:
            callback(step, metrics)
        if (step + 1) % log_every == 0 or step == start:
            loss = float(metrics["loss"])
            print(f"[train] step={step + 1:5d} loss={loss:.4f} "
                  f"({(time.time() - t0) / max(step - start + 1, 1) * 1e3:.0f} ms/step)")
            history.append((step + 1, loss))
        if store is not None and (step + 1) % ckpt_every == 0:
            store.save_async(step + 1, train_leaves(params, opt))
    if store is not None:
        store.save(steps, train_leaves(params, opt))
    return params, opt, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model); not yet ported")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cpu to run the plain versions (default: "
                    "the card)")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    train(arch=args.arch, steps=args.steps, smoke=not args.full, seq_len=args.seq_len,
          global_batch=args.global_batch, mesh_shape=mesh_shape, ckpt_dir=args.ckpt_dir,
          peak_lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
