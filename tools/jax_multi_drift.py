#!/usr/bin/env python3
"""How far the JAX reference's multi-worker matrix-completion fit drifts from
its own one-process fit on the same ratings, epoch by epoch, on the CPU.

    python3 tools/jax_multi_drift.py [--workers 4] [--d 48000] [--m 1777]
        [--entries 1000000] [--epochs 30] [--seed 0] [--out PATH]

The counterpart of ``tools/torch_multi_drift.py --device cpu`` for the
reference: the ratings are the same (``chip_smoke.make_mc_data`` with a CPU
generator seeded with --seed, drawn in PyTorch and handed over as numpy).
``repro.launch.dfw.fit_serial`` runs on ``pack_observations``' layout,
``repro.launch.dfw.fit`` on ``shard_observations``' at --workers fake CPU
devices, and ``fit_serial`` once more on the same ratings in a random order
(a one-process run whose sums only take another order). Both use the log
schedule and the line search, with mu the planted matrix's trace norm.
Prints, for every epoch, |other - serial| / |serial| of the loss, the gap
and sigma for the multi-worker and the shuffled run, and W's largest
difference at the held-out entries over max|W| there; --out writes them as
JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--d", type=int, default=48_000)
    ap.add_argument("--m", type=int, default=1_777)
    ap.add_argument("--entries", type=int, default=1_000_000)
    ap.add_argument("--held-out", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # the fake device count locks at the first jax import
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={args.workers}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import numpy as np
    import torch

    import chip_smoke

    gen = torch.Generator()
    gen.manual_seed(args.seed)
    idx, yw, (te_rows, te_cols, _), mu = chip_smoke.make_mc_data(
        torch, gen, torch.device("cpu"), args.entries, args.held_out, d=args.d, m=args.m)
    rows, cols, vals = idx[:, 0].numpy(), idx[:, 1].numpy(), yw[:, 0].numpy()
    te_rows, te_cols = te_rows.numpy(), te_cols.numpy()
    del idx, yw

    import jax
    import jax.numpy as jnp

    from repro.core import low_rank, tasks
    from repro.launch import dfw

    task = tasks.MatrixCompletion(d=args.d, m=args.m)
    cfg = dfw.DFWConfig(mu=mu, num_epochs=args.epochs, schedule="log", step_size="linesearch")
    key = jax.random.PRNGKey(args.seed)

    def at_heldout(res):
        return np.asarray(low_rank.gather_entries(res.iterate, jnp.asarray(te_rows),
                                                  jnp.asarray(te_cols)))

    idx, yw = tasks.pack_observations(rows, cols, vals)
    ser = dfw.fit_serial(task, idx, yw, cfg=cfg, key=key)
    perm = np.random.default_rng(args.seed).permutation(rows.shape[0])
    idx_s, yw_s = tasks.pack_observations(rows[perm], cols[perm], vals[perm])
    shuf = dfw.fit_serial(task, idx_s, yw_s, cfg=cfg, key=key)
    idx_n, yw_n = dfw.shard_observations(rows, cols, vals, args.workers, args.d, m=args.m)
    multi = dfw.fit(task, idx_n, yw_n, cfg=cfg, key=key, num_workers=args.workers)

    w_ser = at_heldout(ser)
    report = dict(vars(args), ks=[int(k) for k in ser.history["k"]], card="cpu (JAX reference)")
    for side, res in (("multi", multi), ("shuffled", shuf)):
        for name in ("loss", "gap", "sigma"):
            a = np.asarray(res.history[name], np.float64)
            b = np.asarray(ser.history[name], np.float64)
            report[f"{side} {name}"] = (np.abs(a - b) / np.abs(b)).tolist()
        report[f"{side} W"] = float(np.max(np.abs(at_heldout(res) - w_ser)) /
                                    np.max(np.abs(w_ser)))
    report["sigma"] = [float(s) for s in ser.history["sigma"]]
    print(f"JAX reference: {args.workers} fake devices and one process on shuffled ratings, "
          f"each against one process, {args.d} x {args.m}, {args.entries} ratings, "
          f"{args.epochs} epochs, jax {jax.__version__} on the CPU:")
    for t in range(args.epochs):
        print(f"  epoch {t:2d} (K={report['ks'][t]}): " + "; ".join(
            f"{side}: loss {report[side + ' loss'][t]:.2e}, gap {report[side + ' gap'][t]:.2e}, "
            f"sigma {report[side + ' sigma'][t]:.2e}" for side in ("multi", "shuffled")))
    print(f"  W at the held-out entries: multi {report['multi W']:.2e}, shuffled "
          f"{report['shuffled W']:.2e} of max|W|")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
