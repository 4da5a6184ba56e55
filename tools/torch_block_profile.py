#!/usr/bin/env python3
"""Device time by kernel of the block:k solver's fits at full size, on the card.

    python3 tools/torch_block_profile.py [--seed 0] [--epochs 3] [--src OTHER/src]
                                         [--task mc|mtls|logistic ...]

Makes ``chip_smoke.py``'s data on the card from --seed: matrix completion at
the Netflix shapes (480,189 x 17,770, 100,480,507 ratings), least squares
and multinomial logistic regression at the ImageNet shapes (1,281,167 x 2048
-> 1000). Runs --epochs epochs of ``fit_serial``, each once to warm up and
once under ``torch.profiler`` (``chip_smoke.profile_fit``): the wall time, the
device's busy and idle share, the port's kernels against the rest (plain
PyTorch, cuBLAS), and the ten kernels with the most device time. Matrix
completion: ``block:8`` and ``block:8:adapt`` at const:2 with the line
search; least squares: ``block:32`` at const:2 with the line search;
logistic: ``block:8`` (log_half, as phase 25). Least squares and logistic
also run phase 25's own fits unprofiled (``chip_smoke.block_fit``: MTLS
``block:32:adapt`` const:8, 10 epochs; logistic ``block:8``, 3 epochs): ms an
epoch by segment, launches as the path implies, and the loss history in hex,
so that two trees' bits can be compared. --src profiles another checkout's
``repro_torch`` with this checkout's script (run two trees in turns: old,
new, new, old). Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TASKS = ("mc", "mtls", "logistic")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run (default: this checkout's)")
    ap.add_argument("--task", action="append", choices=TASKS,
                    help="the tasks to run (default: all three)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels, resolve_device
    from repro_torch.core import tasks
    from repro_torch.kernels import _build
    from repro_torch.launch import dfw

    if not torch.cuda.is_available():
        print("needs CUDA: device times come from the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"repro_torch from {Path(tasks.__file__).resolve().parents[1]}")
    which = args.task or TASKS
    dev = resolve_device("cuda")
    _build.build_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    if "mc" in which:
        idx, yw, _, mu = cs.make_mc_data(torch, gen, dev, cs.NF_P, cs.NF_TEST)
        task = tasks.MatrixCompletion(cs.NF_D, cs.NF_M)
        for solver in ("block:8", "block:8:adapt"):
            cfg = dfw.DFWConfig(mu=mu, num_epochs=args.epochs, schedule="const:2",
                                step_size="linesearch", solver=solver, verify_kernels=False)
            dfw.fit_serial(task, idx, yw, cfg=cfg, key=args.seed, device=dev)  # warm-up
            cs.profile_fit(torch, f"mc {solver}", lambda: dfw.fit_serial(
                task, idx, yw, cfg=cfg, key=args.seed, device=dev))
        del idx, yw
        torch.cuda.empty_cache()
    if "mtls" not in which and "logistic" not in which:
        return 0
    X, Y = cs.dense_data(torch, gen, dev, cs.PAPER_N)
    fits = []
    if "mtls" in which:
        mtls = tasks.MultiTaskLeastSquares(cs.PAPER_D, cs.PAPER_M)
        fits.append(("mtls", mtls, Y, dfw.DFWConfig(
            mu=1.0, num_epochs=args.epochs, schedule="const:2", step_size="linesearch",
            solver="block:32", verify_kernels=False), dfw.DFWConfig(
            mu=1.0, num_epochs=10, schedule="const:8", step_size="linesearch",
            solver="block:32:adapt", block_epochs=5)))
    if "logistic" in which:
        labels = cs.planted_labels(torch, gen, dev, X)
        fits.append(("logistic", tasks.MultinomialLogistic(cs.PAPER_D, cs.PAPER_M), labels,
                     dfw.DFWConfig(mu=10.0, num_epochs=args.epochs, schedule="log_half",
                                   solver="block:8", verify_kernels=False),
                     dfw.DFWConfig(mu=10.0, num_epochs=3, schedule="log_half",
                                   solver="block:8")))
    for kind, task, target, cfg, phase25 in fits:
        dfw.fit_serial(task, X, target, cfg=cfg, key=args.seed, device=dev)  # warm-up
        cs.profile_fit(torch, f"{kind} {cfg.solver}", lambda: dfw.fit_serial(
            task, X, target, cfg=cfg, key=args.seed, device=dev))
        torch.cuda.empty_cache()
        _, _, rep = cs.block_fit(torch, kernels, dfw, kind, task, X, target, phase25,
                                 args.seed, dev)
        print(f"{kind} {phase25.solver} loss bits: " + " ".join(v.hex() for v in rep["loss"]))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
