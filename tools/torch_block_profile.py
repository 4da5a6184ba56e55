#!/usr/bin/env python3
"""Device time by kernel of the block:k solver's fits at full size, on the card.

    python3 tools/torch_block_profile.py [--seed 0] [--epochs 3]

Makes ``chip_smoke.py``'s data on the card from --seed: matrix completion at
the Netflix shapes (480,189 x 17,770, 100,480,507 ratings) and least squares
at the ImageNet shapes (1,281,167 x 2048 -> 1000). Runs --epochs epochs of
``fit_serial`` at const:2 with the line search, ``block:8`` and
``block:8:adapt`` on matrix completion and ``block:32`` on least squares,
each once to warm up and once under ``torch.profiler`` (``chip_smoke.
profile_fit``): the wall time, the device's busy and idle share, the port's
kernels against the rest (plain PyTorch, cuBLAS), and the ten kernels with
the most device time. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.core import tasks
    from repro_torch.kernels import _build
    from repro_torch.launch import dfw

    if not torch.cuda.is_available():
        print("needs CUDA: device times come from the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = resolve_device("cuda")
    _build.build_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
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
    X, Y = cs.dense_data(torch, gen, dev, cs.PAPER_N)
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=args.epochs, schedule="const:2",
                        step_size="linesearch", solver="block:32", verify_kernels=False)
    mtls = tasks.MultiTaskLeastSquares(cs.PAPER_D, cs.PAPER_M)
    dfw.fit_serial(mtls, X, Y, cfg=cfg, key=args.seed, device=dev)  # warm-up
    cs.profile_fit(torch, "mtls block:32", lambda: dfw.fit_serial(
        mtls, X, Y, cfg=cfg, key=args.seed, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
