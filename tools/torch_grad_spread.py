#!/usr/bin/env python3
"""How far the port's LM gradient moves when every weight moves by one f32
rounding, leaf by leaf, on one GPU: the spread that ``chip_smoke.py``
phase 33 holds a sharded gradient within.

    python3 tools/torch_grad_spread.py [--seed 0] [--batch 4] [--seq 1024]

For rwkv6-7b at full width cut to 2 of 32 layers and qwen2-1.5b cut to 4 of
28 (phase 33's (b) and (c) models, f32, random weights from --seed), it
takes the gradient of ``lm.value_and_grad`` on the synthetic stream's step
0 batch, then again with every weight multiplied by 1 + 6e-8 N(0, 1) and by
1 + 1e-6 N(0, 1), and prints, for the five leaves that moved most, the max
|difference| over the leaf's max |gradient| and the relative Frobenius
norm, with the leaf's path; then whether the unperturbed gradient repeats
its bits, and the card's name and power limit. It exits non-zero without
CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_grad_spread: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import data, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim.compression import tree_leaves, tree_map

    dev = resolve_device("cuda")
    for arch, layers in ((cs.SSM_ARCH, cs.MESH_SSM_LAYERS), (cs.LM_ARCH, cs.MESH_DENSE_LAYERS)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32")
        batch = data.device_put_batch(data.SyntheticLMStream(cfg, ShapeSpec(
            "t", "train", args.seq, args.batch)).batch_for_step(0), dev)
        params = lm.init_params(cfg, args.seed, device=dev)
        paths = cs._leaf_paths(params)
        base = [t.cpu() for t in tree_leaves(lm.value_and_grad(params, batch, cfg)[1])]
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        for scale in (cs.MESH_ROUNDING, 1e-6):
            moved_params = tree_map(lambda t: (t.double() * (1 + scale * torch.randn(
                t.shape, generator=gen, device=dev, dtype=torch.float64))).float(), params)
            moved = [t.cpu() for t in tree_leaves(lm.value_and_grad(moved_params, batch, cfg)[1])]
            rows = []
            for a, b, name in zip(moved, base, paths, strict=True):
                d = a.double() - b.double()
                rows.append((float(d.abs().max() / b.double().abs().max()),
                             float(d.norm() / b.double().norm()), name))
            rows.sort(reverse=True)
            print(f"{arch} ({layers} layers), weights x (1 + {scale:g} N(0, 1)): the leaves "
                  f"that moved most (max-relative, Frobenius-relative, path): {rows[:5]}")
            del moved_params, moved
        again = [t.cpu() for t in tree_leaves(lm.value_and_grad(params, batch, cfg)[1])]
        print(f"{arch}: the unperturbed gradient repeats its bits: "
              f"{all(torch.equal(a, b) for a, b in zip(again, base))}")
        del params, base, again
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
