#!/usr/bin/env python3
"""How far a multi-worker matrix-completion fit drifts from the one-process
fit on the same ratings, epoch by epoch, beside a one-process fit on the
same ratings in another order.

    python3 tools/torch_multi_drift.py [--device cpu|cuda] [--workers 4] [--d 48000]
        [--m 1777] [--entries 1000000] [--epochs 30] [--seed 0] [--smoke-data]
        [--out PATH]

Ratings come from ``chip_smoke.make_mc_data`` (the Netflix-like popularity
laws and planted rank-10 matrix, at the given d, m and count; the defaults
are a hundredth of the Netflix ratings). ``--smoke-data`` draws instead the
ratings of ``chip_smoke.py`` phases 21-22: the Netflix shapes, from a
generator seeded with --seed that first drew the ImageNet-shaped least-squares
data and labels (1,281,167 x 2048 on the device; use it on the card).
``fit_serial`` runs on them in this process, and again on the ratings in a
random order (a one-process run whose sums only take another order);
``launch.dfw.fit`` runs on ``shard_observations``' layout in --workers gloo
processes (``run_workers``; on CUDA they share the one card and the data
through CUDA IPC). All use the log schedule and the line search, with mu the
planted matrix's trace norm. Prints, for every epoch, |other - serial| /
|serial| of the loss, the gap and sigma for the multi-worker and the shuffled
run, the three runs' sigma, and W's largest difference at the held-out
entries over max|W| there, with the device's name (and, on CUDA, the card's
power limit); --out writes them as JSON. ``tools/jax_multi_drift.py`` makes
the same comparison for the JAX reference on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def worker(group, device, task, idx4, yw4, kw, seed, te_rows, te_cols):
    """One worker's fit; W at the held-out entries back on the host."""
    from repro_torch.core import low_rank
    from repro_torch.launch import dfw

    res = dfw.fit(task, idx4, yw4, cfg=dfw.DFWConfig(**kw), key=seed, group=group, device=device)
    return dict(history=res.history, w=low_rank.gather_entries(
        res.iterate, te_rows.to(device), te_cols.to(device)).cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--d", type=int, default=48_000)
    ap.add_argument("--m", type=int, default=1_777)
    ap.add_argument("--entries", type=int, default=1_000_000)
    ap.add_argument("--held-out", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke-data", action="store_true",
                    help="the ratings of chip_smoke.py phases 21-22 (Netflix shapes)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.core import low_rank, tasks
    from repro_torch.launch import dfw

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    if args.smoke_data:
        args.d, args.m = chip_smoke.NF_D, chip_smoke.NF_M
        args.entries, args.held_out = chip_smoke.NF_P, chip_smoke.NF_TEST
        X, _ = chip_smoke.dense_data(torch, gen, dev, chip_smoke.PAPER_N)
        chip_smoke.planted_labels(torch, gen, dev, X)
        del X
    idx, yw, (te_rows, te_cols, _), mu = chip_smoke.make_mc_data(
        torch, gen, dev, args.entries, args.held_out, d=args.d, m=args.m)
    task = tasks.MatrixCompletion(args.d, args.m)
    kw = dict(mu=mu, num_epochs=args.epochs, schedule="log", step_size="linesearch")

    def serial(i, y):
        res = dfw.fit_serial(task, i, y, cfg=dfw.DFWConfig(**kw), key=args.seed, device=dev)
        return dict(history=res.history, w=low_rank.gather_entries(
            res.iterate, te_rows, te_cols).cpu().numpy())

    ser = serial(idx, yw)
    perm = torch.randperm(idx.shape[0], generator=torch.Generator().manual_seed(args.seed))
    shuf = serial(idx[perm.to(dev)], yw[perm.to(dev)])
    del perm
    idx4, yw4 = dfw.shard_observations(idx[:, 0], idx[:, 1], yw[:, 0], args.workers, args.d,
                                       m=args.m)
    del idx, yw
    multi = dfw.run_workers(args.workers, worker, task, idx4.to(dev), yw4.to(dev), kw,
                            args.seed, te_rows, te_cols, backend="gloo", device=dev)[0]
    report = dict(vars(args), ks=ser["history"]["k"])
    for side, run in (("multi", multi), ("shuffled", shuf)):
        for name in ("loss", "gap", "sigma"):
            a, b = np.asarray(run["history"][name]), np.asarray(ser["history"][name])
            report[f"{side} {name}"] = (np.abs(a - b) / np.abs(b)).tolist()
        report[f"{side} W"] = float(np.max(np.abs(run["w"] - ser["w"])) /
                                    np.max(np.abs(ser["w"])))
    report["sigmas"] = {side: run["history"]["sigma"] for side, run in (
        ("serial", ser), ("multi", multi), ("shuffled", shuf))}
    if dev.type == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    else:
        report["card"] = "cpu"
    print(f"{args.workers} workers and one process on shuffled ratings, each against one "
          f"process, {args.d} x {args.m}, {args.entries} ratings, {args.epochs} epochs, on "
          f"{report['card']}:")
    for t in range(args.epochs):
        print(f"  epoch {t:2d} (K={report['ks'][t]}): " + "; ".join(
            f"{side}: loss {report[side + ' loss'][t]:.2e}, gap {report[side + ' gap'][t]:.2e}, "
            f"sigma {report[side + ' sigma'][t]:.2e}" for side in ("multi", "shuffled"))
            + "; sigma " + ", ".join(f"{side} {v[t]:.6g}" for side, v in report["sigmas"].items()))
    print(f"  W at the held-out entries: multi {report['multi W']:.2e}, shuffled "
          f"{report['shuffled W']:.2e} of max|W|")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
