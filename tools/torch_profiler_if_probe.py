#!/usr/bin/env python3
"""Does the CUDA profiler name the kernels of a graph's IF-node bodies right? On the card.

    python3 tools/torch_profiler_if_probe.py [--epochs 24]

Runs one small least-squares fit with the ``block:4:adapt`` solver and the
line search (n = 512, d = 48, m = 40, const:4, ``gap_tol`` at the gap an
unstopped run reaches at 60% of its epochs, so the certificate fires inside
the one segment) three ways: captured (the engine's CUDA graphs, IF nodes
for ``gap_tol`` and ``:adapt``), the same programs uncaptured, and legacy.
Each run is counted three ways at once: the wrappers' calls
(``kernels.launches()``), the device's counters (``kernels.Executed``) and
``torch.profiler``'s kernel records by name (the block solver's three
kernels: ``ring_matmat_kernel<.., false>`` for matmat,
``rmatmat_finish_kernel`` for rmatmat, ``rankk_kernel<.., true>`` for the
rank-k update), the latter between two marker kernels (``spin_kernel``)
launched around the run, with the record count outside them. All three
runs have the same bits; uncaptured, the three counts agree. Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = {"matmat": r"\bring_matmat_kernel<\d+, false>", "rmatmat": r"\brmatmat_finish_kernel\b",
         "rankk_update_axpy": r"\brankk_kernel<\d+, \d+, true>"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=24)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.core import engine, tasks
    from repro_torch.kernels import _build
    from repro_torch.launch import dfw

    if not torch.cuda.is_available():
        print("needs CUDA: the profiler's records come from the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    n, d, m = 512, 48, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, m))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x_t = torch.from_numpy(x).to(dev)
    y_t = torch.from_numpy((x @ w).astype(np.float32)).to(dev)
    task = tasks.MultiTaskLeastSquares(d, m)
    kw = dict(mu=1.0, num_epochs=args.epochs, schedule="const:4", solver="block:4:adapt",
              step_size="linesearch", verify_kernels=False)

    def run(cfg_kw, captured=True):
        capturable = engine._capturable
        if not captured:
            engine._capturable = lambda *a: False
        try:
            kernels.reset_launches()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                with kernels.Executed() as ex:
                    res = dfw.fit_serial(task, x_t, y_t, cfg=dfw.DFWConfig(**cfg_kw), key=5,
                                         device=dev)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        finally:
            engine._capturable = capturable
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spins = [e.time_range.start for e in evs if "spin_kernel" in e.name]
        lo, hi = (spins[0], spins[-1]) if len(spins) == 2 else (float("-inf"), float("inf"))
        inside = [e.name for e in evs if lo < e.time_range.start < hi]
        named = {k: sum(1 for nm in inside if re.search(p, nm)) for k, p in NAMES.items()}
        calls = {k: kernels.launches()[k] for k in NAMES}
        dev_count = {k: ex.launches[k] for k in NAMES}
        return res, calls, dev_count, named, len(evs) - len(inside) - len(spins)

    full = run(kw)[0]
    tol = full.history["gap"][int(0.6 * args.epochs)]
    out = {}
    for label, cfg_kw, captured in (("captured", dict(kw, gap_tol=tol), True),
                                    ("uncaptured", dict(kw, gap_tol=tol), False),
                                    ("legacy", dict(kw, gap_tol=tol, engine="legacy"), True)):
        res, calls, dev_count, named, outside = out[label] = run(cfg_kw, captured)
        print(f"{label}: {res.epochs_run} epochs, {res.stats['graph_replays']} graph replays; "
              f"wrapper calls {calls}; device counters {dev_count}; profiler records by name "
              f"{named} ({outside} records outside the markers)")
    same = all(out[k][0].history == out["captured"][0].history for k in out)
    print(f"the same history in all three runs: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
