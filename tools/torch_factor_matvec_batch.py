#!/usr/bin/env python3
"""``factor_matvec`` at tall batches (the head's ``top_k_error`` chunks) on
one GPU: CUDA events, host time and the profiler's device time by kernel.

    python3 tools/torch_factor_matvec_batch.py

For each (b, r) of (65536, 10) (``low_rank.RIGHT_MULTIPLY_ROWS`` rows at the
ImageNet head's rank after 10 epochs), (65536, 64), (16384, 10) and the
serving shape (64, 64), at 2048 -> 1000, f32: the wrapper (``ops``, which
folds alpha into s), the bare kernel (``kernel``) and the one library call
``torch.einsum("bi,ki,k,kj->bj")``, each as the median of 20 calls between
CUDA events, the host time of a call, and the device time per call of every
kernel the profiler names over 10 calls; then the kernel's launch plan. It
prints the card's name and power limit last and exits non-zero without
CUDA.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((65536, 10), (65536, 64), (16384, 10), (64, 64))
N_IN, N_OUT = 2048, 1000


def events_ms(torch, fn, reps=20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_ms(torch, fn, reps=20) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def device_ms_by_kernel(torch, fn, n=10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: round(ev.self_device_time_total / n / 1e3, 4)
            for ev in prof.key_averages()
            if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.self_device_time_total}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this tool times a kernel on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import factor_matvec as fm

    _build.build_all()
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for b, r in SHAPES:
        x, u, s, v = rn(b, N_IN), rn(r, N_IN), rn(r), rn(r, N_OUT)
        alpha = torch.full((), 0.5, device=dev)
        sa = s * alpha
        out = torch.empty(b, N_OUT, device=dev)
        calls = (("ops", lambda: fm.factor_matvec(x, u, s, v, alpha=alpha)),
                 ("kernel", lambda: fm.kernel.factor_matvec(x, u, sa, v, out)),
                 ("einsum", lambda: torch.einsum("bi,ki,k,kj->bj", x, u, sa, v)))
        for label, fn in calls:
            print(f"b={b} r={r} {label}: events {events_ms(torch, fn):.4f} ms, host "
                  f"{host_ms(torch, fn):.4f} ms, device by kernel "
                  f"{device_ms_by_kernel(torch, fn)}", flush=True)
        print(f"b={b} r={r} plan {fm.kernel.launch_plan(b, N_IN, r, N_OUT)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
