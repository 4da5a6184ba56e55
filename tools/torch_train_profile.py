#!/usr/bin/env python3
"""Where a training step's device time goes, on the card.

    python3 tools/torch_train_profile.py [--seed 0] [--batch 4] [--seq 2048]

Runs ``chip_smoke.py`` phase 30's three configurations (qwen2-1.5b whole;
codeqwen1.5-7b at 16 of 32 layers; rwkv6-7b at 8 of 32 layers; bf16,
weights drawn on the card from --seed), one AdamW step of ``launch.steps.
make_train_step`` each to warm up, then once more in its two halves under
``torch.profiler``: the loss and gradients (``lm.value_and_grad``: forward,
the layers' recomputation and backward) and ``adamw.update``. For each half:
its wall ms, the device's busy ms and idle share, the device ms of the
bf16 GEMMs, of the f32 GEMMs (the reference's attention products, taken in
f32 on the CUDA cores with TF32 off) and of the rest (elementwise, softmax,
reductions, copies), and the ten kernels with the most device time. Prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = (("qwen2_1_5b", None), ("codeqwen1_5_7b", 16), ("rwkv6_7b", 8))
GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet")


def kind(name: str) -> str:
    low = name.lower()
    if not any(m in low for m in GEMM_MARKS):
        return "other"
    return "f32 gemm" if ("f32f32_f32f32" in low or "sgemm" in low) else "bf16 gemm"


def profiled(torch, fn):
    """(result, wall ms, {kernel: device ms}) of ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev[ev.key] = dev.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return out, wall, dev


def report(label, wall, dev) -> None:
    busy = sum(dev.values())
    if not busy:
        print(f"{label}: wall {wall:.1f} ms; the profiler recorded no device time (not measured)")
        return
    groups = {}
    for k, t in dev.items():
        groups[kind(k)] = groups.get(kind(k), 0.0) + t
    print(f"{label}: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall:.3f}); " + ", ".join(
              f"{g} {t:.1f} ms ({100 * t / busy:.1f}%)" for g, t in sorted(groups.items())))
    for k, t in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t:9.2f} ms  {kind(k):9s}  {k[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream, device_put_batch
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, schedule

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.build_all()
    dev = resolve_device("cuda")
    for arch, layers in CONFIGS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = lm.init_params(cfg, args.seed, device=dev)
        opt = adamw.init(params)
        stream = SyntheticLMStream(cfg, ShapeSpec("t", "train", args.seq, args.batch))
        batch = device_put_batch(stream.batch_for_step(0), dev)
        params, opt, _ = steps.make_train_step(cfg)(params, opt, batch)  # warm-up
        (_, grads), wall_g, dev_g = profiled(
            torch, lambda: lm.value_and_grad(params, batch, cfg))
        lr = schedule.cosine_with_warmup(opt.step, peak_lr=3e-4, warmup=100, total=10_000)
        _, wall_a, dev_a = profiled(torch, lambda: adamw.update(grads, opt, params, lr=lr))
        print(f"{cfg.name} ({cfg.num_layers} layers, {lm.param_count(params) / 1e9:.3f} B "
              f"parameters, {cfg.dtype}), {args.batch} x {args.seq} tokens:")
        report("  loss and gradients", wall_g, dev_g)
        report("  adamw.update", wall_a, dev_a)
        del params, opt, grads, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
