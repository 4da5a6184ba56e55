#!/usr/bin/env python3
"""The port's ``power_matvec`` rmatvec (A^T u) against ``torch.mv(A.T, u)``
at the hybrid head's f32 gradient (4096 x 92,416, codeqwen1.5-7b's head),
in alternating rounds, on one GPU.

    python3 tools/torch_rmatvec_turns.py [--rounds 8] [--calls 200] [--n 4096] [--m 92416]

Each round times both, in the order kernel, library on even rounds and
library, kernel on odd ones (so that neither always goes first): the median
of --calls calls by CUDA events, then the device time per call over
--calls more calls (torch.profiler, the kernels' own time). It prints every
round, then for each side the median over the rounds of both numbers and
their spread (the least and the largest round), and the kernel's ratio to
the library by round; then the bound (A, u and the output read or written
once at 3.35 TB/s) and the card's name and power limit. The kernel's
result is held to ``torch.mv``'s at 1e-4 of max. It exits non-zero without
CUDA.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BW = 3.35e12  # H100 SXM memory rate (data sheet)


def events_ms(torch, fn, calls: int) -> float:
    """Median of ``calls`` calls, each between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(torch, fn, calls: int):
    """Device time per call over ``calls`` calls (every kernel the profiler
    saw), or None if it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return total / calls / 1e3 if total else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=92_416)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available; this tool times the kernel on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import power_matvec as pm

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    a = torch.randn(args.n, args.m, generator=gen, device=dev)
    u = torch.randn(args.n, generator=gen, device=dev)
    got, want = pm.rmatvec(a, u), torch.mv(a.t(), u)
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= 1e-4:
        print(f"rmatvec differs from torch.mv by {err:.3e} of max", file=sys.stderr)
        return 1
    sides = {"kernel": lambda: pm.rmatvec(a, u), "torch.mv": lambda: torch.mv(a.t(), u)}
    rounds = []
    for r in range(args.rounds):
        order = list(sides) if r % 2 == 0 else list(sides)[::-1]
        row = {}
        for name in order:
            row[name] = (events_ms(torch, sides[name], args.calls),
                         device_ms(torch, sides[name], args.calls))
        rounds.append(row)
        print(f"round {r} ({' then '.join(order)}): " + ", ".join(
            f"{name} {row[name][0]:.4f} ms (device {row[name][1]})" for name in sides))
    bound = 1e3 * 4 * (args.n * args.m + args.n + args.m) / BW
    print(f"rmatvec at {args.n} x {args.m} f32, {args.rounds} rounds of {args.calls} calls; "
          f"bound {bound:.4f} ms (bytes at 3.35 TB/s); rel err {err:.2e}")
    for name in sides:
        ev = [row[name][0] for row in rounds]
        dv = [row[name][1] for row in rounds if row[name][1] is not None]
        dv_text = (f"device median {statistics.median(dv):.4f} (rounds {min(dv):.4f}-"
                   f"{max(dv):.4f})" if dv else "device not measured")
        print(f"{name}: events median {statistics.median(ev):.4f} ms (rounds {min(ev):.4f}-"
              f"{max(ev):.4f}); {dv_text}")
    ratios = [row["kernel"][0] / row["torch.mv"][0] for row in rounds]
    print("kernel / torch.mv by round (events): " + ", ".join(f"{x:.4f}" for x in ratios)
          + f"; median {statistics.median(ratios):.4f}")
    dratios = [row["kernel"][1] / row["torch.mv"][1] for row in rounds
               if row["kernel"][1] and row["torch.mv"][1]]
    if dratios:
        print("kernel / torch.mv by round (device): " + ", ".join(f"{x:.4f}" for x in dratios)
              + f"; median {statistics.median(dratios):.4f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
