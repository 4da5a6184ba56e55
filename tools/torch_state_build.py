#!/usr/bin/env python3
"""The matrix-completion state build and the MC fits of ``chip_smoke.py``
(phases 7-9), timed for this checkout's port and for older trees in one run,
on one GPU.

    python3 tools/torch_state_build.py [--src OTHER/src ...] [--reps 5] [--out PATH]

For every source tree (``src`` of this checkout first, then every --src), in
turns (the trees in order, then in reverse order, so that neither version
has the better place in the run), one process makes chip_smoke.py's ratings
at the Netflix shapes on the card from --seed (--mc-entries training
ratings, 100,480,507 by default), builds ``MatrixCompletion.init_state``
--reps times (wall time to a sync, and the device memory a build adds at
its peak over what was allocated before it) and runs the dense MC fit of
phase 8 (30 epochs) and the int8 fit of phase 9 (10 epochs) as
chip_smoke.py runs them: wall time, ms per epoch of each segment, the fit's
peak device memory. Every field of each tree's state (its orders' fields
too) is reduced to a fingerprint on the card (a position-weighted sum of its
32-bit words, which any one changed word moves) and held to the first
tree's. Prints the card's name and power limit, and writes every number to
--out as JSON. It exits non-zero without CUDA or if a state differs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build_times(torch, tasks, d, m, idx, yw, reps):
    """Wall times (s) of ``reps`` state builds and the largest device memory
    (GB) a build added over what was allocated before it."""
    times, extra = [], 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = tasks.MatrixCompletion(d, m).init_state(idx, yw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        extra = max(extra, (torch.cuda.max_memory_allocated() - base) / 1e9)
        del state
    return times, extra


def fingerprint(torch, state) -> dict:
    """Per field of an MC state (its orders' fields by name too): the sum of
    its 32- or 64-bit words each times (its position mod 2^20) + 1, in int64
    (wrapping), with its dtype and shape."""
    def leaves(state):
        for name in state._fields:
            value = getattr(state, name)
            if dataclasses.is_dataclass(value):
                for f in dataclasses.fields(value):
                    yield f"{name}.{f.name}", getattr(value, f.name)
            else:
                yield name, value
    out = {}
    for name, t in leaves(state):
        if not isinstance(t, torch.Tensor):
            out[name] = t
            continue
        words = t.reshape(-1).view(torch.int64 if t.element_size() == 8 else torch.int32)
        weight = torch.arange(words.numel(), device=t.device, dtype=torch.int64) % (1 << 20) + 1
        out[name] = [str(t.dtype), list(t.shape), int(torch.sum(words.to(torch.int64) * weight))]
    return out


def fit(torch, cs, tasks, dfw, d, m, idx, yw, mu, comm, epochs, seed):
    cfg = dfw.DFWConfig(mu=mu, num_epochs=epochs, schedule="log", step_size="linesearch",
                        comm=comm)
    seg_log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dfw.fit_serial(tasks.MatrixCompletion(d, m), idx, yw, cfg=cfg, key=seed,
                         device=idx.device, callback=cs.segment_timer(torch, seg_log))
    torch.cuda.synchronize()
    return dict(wall_s=time.perf_counter() - t0, segments=seg_log,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                loss=res.history["loss"], final_loss=res.final_loss)


def one_tree(args) -> int:
    """The measurements of one tree (--one), in this process, to --out."""
    import torch

    if not torch.cuda.is_available():
        print("torch_state_build: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, args.one)
    from repro_torch.core import tasks
    from repro_torch.kernels import _build
    from repro_torch.launch import dfw

    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    p = args.mc_entries or cs.NF_P
    d, m = cs.NF_D, cs.NF_M
    idx, yw, _, mu = cs.make_mc_data(torch, gen, dev, p, cs.NF_TEST)
    torch.cuda.synchronize()
    times, extra = build_times(torch, tasks, d, m, idx, yw, args.reps)
    run = dict(tree=args.one, entries=p, build_s=times, build_extra_gb=extra)
    for comm, epochs in (("dense", 30), ("int8", 10)):
        run[comm] = fit(torch, cs, tasks, dfw, d, m, idx, yw, mu, comm, epochs, args.seed)
    run["fingerprint"] = fingerprint(torch, tasks.MatrixCompletion(d, m).init_state(idx, yw))
    print(f"{args.one}: state build median {statistics.median(times):.4f} s of "
          f"{[round(t, 4) for t in times]}, adds {extra:.3f} GB at its peak; "
          + "; ".join(f"{comm} fit {run[comm]['wall_s']:.3f} s (peak {run[comm]['peak_gb']:.2f} "
                      f"GB, ms/epoch {[round(s['ms_per_epoch'], 2) for s in run[comm]['segments']]})"
                      for comm in ("dense", "int8")), flush=True)
    Path(args.out).write_text(json.dumps(run))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", default=[], help="another tree's src directory")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mc-entries", type=int, default=None,
                    help="training ratings (default: chip_smoke.py's full count)")
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one_tree(args)

    trees = [str(ROOT / "src")] + [str(Path(s).resolve()) for s in args.src]
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    runs = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for turn, i in enumerate(order):
            out = Path(tmp) / f"{turn}.json"
            cmd = [sys.executable, __file__, "--one", trees[i], "--out", str(out),
                   "--reps", str(args.reps), "--seed", str(args.seed)]
            if args.mc_entries:
                cmd += ["--mc-entries", str(args.mc_entries)]
            if subprocess.run(cmd).returncode != 0:
                return 1
            runs.append(json.loads(out.read_text()))
    same = {run["tree"]: run["fingerprint"] == runs[0]["fingerprint"] for run in runs}
    for tree, ok in same.items():
        print(f"state of {tree}: every field {'the same bits as' if ok else 'DIFFERS from'} "
              f"this checkout's")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi, runs=runs, same_bits=same),
                                             indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
