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
- Sharded and elastic: ``mesh_shape=(data, model)`` (``--mesh 2x4``) runs
  the step on a ``launch.mesh.Mesh`` over the process group's workers
  (``group``, default the initialized world; ``launch.multihost train``
  sets it up). Each worker draws the weights leaf by leaf from ``seed``
  and keeps its block (``launch.params``), so the sharded run starts from
  the unsharded run's weights and no worker holds the whole model; AdamW
  runs on the blocks unchanged (it is elementwise). Every worker makes the
  same global batch and runs its data shard's rows. A checkpoint gathers
  the full leaves and worker 0 writes them in the layout above; a restore
  reads the full leaves and cuts them for the current mesh, whatever mesh
  (or none) wrote them, this package's or the JAX package's. The sharding
  profile is the rules active where ``build``, ``restore`` or ``train`` is
  called (``with sharding.use_mesh(None, sharding.rules_for("sp")):``, as
  the reference's steps take it from ``use_mesh``'s rules); a checkpoint
  holds full leaves, so one written under one profile restores under any
  other.

Runs on the card unless ``device="cpu"`` (``--device cpu``).
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, Optional, Tuple

from .. import DeviceLike, convert, resolve_device
from ..checkpoint import CheckpointStore
from ..configs import get_config
from ..data import SyntheticLMStream, device_put_batch
from ..models import lm, parallel
from ..models.config import ModelConfig, ShapeSpec
from ..optim import adamw
from . import params as P
from .mesh import make_mesh, parse_mesh
from .sharding import active_rules, use_mesh
from .steps import batch_pspecs, make_train_step


def build(cfg: ModelConfig, shape: ShapeSpec, mesh=None, *, peak_lr: float = 3e-4,
          seed: int = 0, device: DeviceLike = None):
    """Returns ``(init_fn, step_fn, shardings)``: ``init_fn() -> (params,)``
    draws the weights from ``seed`` on the device, ``step_fn`` is
    ``make_train_step``'s, ``shardings`` None without a mesh, else the spec
    trees ``{"params", "batch"}``. Under a mesh ``init_fn`` keeps this
    worker's block of each leaf as it is drawn, and ``step_fn`` runs in the
    mesh's context with the rules active here (so a profile's
    ``use_mesh(None, rules_for(p))`` around the call picks it)."""
    dev = resolve_device(device)
    step = make_train_step(cfg, peak_lr=peak_lr)
    if mesh is None:
        return (lambda: (lm.init_params(cfg, seed, device=dev),), step, None)
    rules = active_rules()
    with use_mesh(mesh, rules):
        parallel.check_mesh(cfg, shape.seq_len)
        specs = lm.param_specs(cfg)
        shardings = {"params": specs, "batch": batch_pspecs(cfg, shape)}

    def init_fn():
        return (P.init_local_params(cfg, seed, mesh, device=dev, specs=specs),)

    def step_fn(params, opt, batch):
        with use_mesh(mesh, rules):
            return step(params, opt, batch)

    return init_fn, step_fn, shardings


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
            device: DeviceLike = None, mesh=None) -> Tuple[int, dict, adamw.AdamWState]:
    """``(step, params, opt)`` of a train checkpoint (the latest by default),
    written by this module or by the JAX package's ``train``, with or
    without a mesh. With ``mesh`` each leaf is cut on the host to this
    worker's block under the mesh's specs with the active rules before it
    goes to the device (elastic: any mesh and profile, or none, may have
    written it)."""
    dev = resolve_device(device)
    at, leaves, _ = store.restore(step)
    tree = _nest(leaves)
    if mesh is None:
        return (at, convert.lm_params(tree["params"], cfg, device=dev),
                convert.adamw_state(tree["opt"], cfg, device=dev))
    with use_mesh(mesh, active_rules()):
        specs = lm.param_specs(cfg)
    host = convert.adamw_state(tree["opt"], cfg, device="cpu")

    def cut(full):
        return P.map_specs(lambda leaf, spec: P.local_block(leaf, spec, mesh).to(dev),
                          full, specs)

    return (at, cut(convert.lm_params(tree["params"], cfg, device="cpu")),
            adamw.AdamWState(step=host.step.to(dev), m=cut(host.m), v=cut(host.v)))


def gathered_leaves(params, opt: adamw.AdamWState, mesh, specs) -> Optional[Dict[str, object]]:
    """The checkpoint payload of a sharded run: every leaf gathered (every
    worker calls this), kept on the host by worker 0 alone; None on the
    other workers."""
    def full(tree):
        def one(leaf, spec):
            whole = P.gather_block(leaf, spec, mesh)
            return whole.cpu() if mesh.rank == 0 else None
        return P.map_specs(one, tree, specs)

    p, m, v = full(params), full(opt.m), full(opt.v)
    if mesh.rank != 0:
        return None
    return train_leaves(p, adamw.AdamWState(step=opt.step.cpu(), m=m, v=v))


def train(*, arch: str, steps: int, smoke: bool = True, seq_len: int = 128,
          global_batch: int = 8, mesh_shape: Optional[Tuple[int, ...]] = None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50, peak_lr: float = 3e-4,
          log_every: int = 10, resume: bool = True, device: DeviceLike = None,
          cfg: Optional[ModelConfig] = None, params: Optional[dict] = None,
          seed: int = 0, callback: Optional[Callable[[int, dict], None]] = None,
          group=None):
    """Train ``arch`` (its smoke config unless ``smoke=False``; ``cfg`` in
    its place, e.g. a depth cut) for ``steps`` steps of ``global_batch`` x
    ``seq_len`` tokens. Returns ``(params, opt, history)``, history the
    ``(step, loss)`` pairs logged every ``log_every`` steps and at the
    first. ``params`` are the starting weights, full leaves (default: drawn
    from ``seed``; a resume reads the checkpoint's instead). ``callback(step,
    metrics)``, when given, sees each step's metrics (on the device).

    ``mesh_shape`` (data, model) runs sharded over ``group`` (a
    ``comm.WorkerGroup``; default the initialized world group; a shape of
    one worker needs none): the returned params and AdamW state are this
    worker's blocks, the losses the global ones, and only worker 0 prints
    and writes checkpoints (module doc); the sharding profile is the active
    rules'."""
    cfg = cfg if cfg is not None else get_config(arch, smoke=smoke)
    lm.check_trains(cfg)
    dev = resolve_device(device)
    shape = ShapeSpec("train_custom", "train", seq_len, global_batch)
    mesh = None
    if mesh_shape is not None:
        if group is None and math.prod(mesh_shape) > 1:
            from ..comm import WorkerGroup
            group = WorkerGroup()
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), group)
    init_fn, step_fn, shardings = build(cfg, shape, mesh, peak_lr=peak_lr, seed=seed,
                                        device=dev)
    stream = SyntheticLMStream(cfg, shape)
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    lead = mesh is None or mesh.rank == 0

    def payload():
        if mesh is None:
            return train_leaves(params, opt)
        return gathered_leaves(params, opt, mesh, shardings["params"])

    start = 0
    if store is not None and resume and store.latest_step() is not None:
        start, params, opt = restore(store, cfg, device=dev, mesh=mesh)
        if lead:
            print(f"[train] resumed from step {start}")
    else:
        if params is None:
            (params,) = init_fn()
        elif mesh is not None:
            params = P.shard_params(params, mesh, shardings["params"])
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
            if lead:
                print(f"[train] step={step + 1:5d} loss={loss:.4f} "
                      f"({(time.time() - t0) / max(step - start + 1, 1) * 1e3:.0f} ms/step)")
            history.append((step + 1, loss))
        if store is not None and (step + 1) % ckpt_every == 0:
            leaves = payload()
            if lead:
                store.save_async(step + 1, leaves)
    if store is not None:
        leaves = payload()
        if lead:
            store.save(steps, leaves)
    return params, opt, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model), over the "
                    "initialized process group (launch.multihost train)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cpu to run the plain versions (default: "
                    "the card)")
    args = ap.parse_args(argv)
    mesh_shape = parse_mesh(args.mesh)
    train(arch=args.arch, steps=args.steps, smoke=not args.full, seq_len=args.seq_len,
          global_batch=args.global_batch, mesh_shape=mesh_shape, ckpt_dir=args.ckpt_dir,
          peak_lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
