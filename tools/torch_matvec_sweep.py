#!/usr/bin/env python3
"""The port's ``power_matvec`` matvec against ``torch.mv`` over the row
length, at a fixed matrix size, on one GPU.

    python3 tools/torch_matvec_sweep.py [--src OTHER/src ...] [--gb 5.12] [--m M ...]

For each row length m (250, 500, 1000, 1001, 2000, 2048, 4096 columns, or
those given with --m) the matrix A (n, m) f32 holds about --gb GB (n =
bytes / 4m), so every shape moves the same bytes and only the work per row
changes: R of the power method is 1,281,167 x 1000 (5.12 GB), X is
1,281,167 x 2048 (10.49 GB: --m 2048 --gb 10.49). It prints, per
m, the time of one call (CUDA events, the median of --reps calls, timed in
order and then in reverse order, the mean of the two) of the kernel of each
source tree given (``src`` of this checkout first, then every --src in
turn, so that an older version of the kernel is timed in the same run) and
of ``torch.mv``, the rate in TB/s and each kernel's ratio to ``torch.mv``;
then the card's name and power limit. m = 1001 takes the kernel's 4-byte
path. Every kernel result is held to ``torch.mv``'s at 1e-4 of max. It
exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROW_LENGTHS = (250, 500, 1000, 1001, 2000, 2048, 4096)


def time_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def load_ops(src: Path):
    """``repro_torch.kernels.power_matvec.ops`` of the tree ``src``; the
    package imported before is dropped from ``sys.modules`` first (its
    modules live on through the objects returned for it), so that two trees
    load side by side. Each builds its libraries into its own checkout's
    ``build/kernels``."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(src))
    try:
        return importlib.import_module("repro_torch.kernels.power_matvec.ops")
    finally:
        sys.path.remove(str(src))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="another checkout's src directory whose matvec is timed too")
    ap.add_argument("--gb", type=float, default=5.12, help="bytes of A, in GB")
    ap.add_argument("--m", type=int, action="append", help="row lengths (default: the sweep)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_matvec_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    trees = [ROOT / "src"] + [Path(s).resolve() for s in args.src]
    ops = [load_ops(t) for t in trees]
    for op in ops:
        op.kernel._build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print("m, n, " + ", ".join(f"kernel ms ({t})" for t in trees) + ", torch.mv ms, "
          "TB/s of each kernel, kernel / torch.mv")
    for m in args.m or ROW_LENGTHS:
        n = int(args.gb * 1e9 / (4 * m))
        a = torch.randn(n, m, generator=gen, device=dev)
        v = torch.randn(m, generator=gen, device=dev)
        want = torch.mv(a, v)
        scale = float(want.abs().max())
        for op in ops:
            err = float((op.matvec(a, v) - want).abs().max()) / scale
            if not err <= 1e-4:
                print(f"torch_matvec_sweep: m {m}: error {err:.3e} > 1e-4", file=sys.stderr)
                return 1
        fns = [lambda op=op: op.matvec(a, v) for op in ops] + [lambda: torch.mv(a, v)]
        # in turns: each in order, then in reverse order; the mean of the two
        first = [time_ms(torch, f, args.reps) for f in fns]
        second = [time_ms(torch, f, args.reps) for f in reversed(fns)][::-1]
        *ms, lib = [(x + y) / 2 for x, y in zip(first, second)]
        nbytes = 4 * (n * m + n + m)
        print(f"{m}, {n}, " + ", ".join(f"{t:.4f}" for t in ms) + f", {lib:.4f}, "
              + ", ".join(f"{nbytes / t / 1e9:.3f}" for t in ms) + ", "
              + ", ".join(f"{t / lib:.4f}" for t in ms))
        del a, v, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
