#!/usr/bin/env python3
"""Host microseconds of one serving dispatch, by part, on the card.

    python3 tools/torch_serve_dispatch.py [--src OTHER/src] [--n 2000] [--report PATH]

Builds a ``ServingEngine`` at ``chip_smoke.py`` phase 12's shapes (d = 2048,
m = 1000, batches of 64, rank buckets of 32) on a random model of live rank
30 and times with ``time.perf_counter`` (median and p99 over --n
dispatches, the device drained every 32 dispatches outside the timed
ones):

* the engine's own ``score_async`` (returns without waiting) and
  ``score`` (dispatch and ``block()``, the round trip a client sees);
* a dispatch spelled out step by step, each step's time taken inside the
  sequence: the numpy conversion (``np.asarray`` and the shape checks), the
  staging, the copy to the card, the scoring, the handle, then ``block()``.
  Three spellings: the eager path (a zeroed pinned buffer filled through a
  tensor slice, copied to a fresh device tensor, the ``factor_matvec``
  wrapper's checks and launch), the captured path (a pinned buffer from the
  host allocator written through its numpy view, copied into the engine's
  static input, the bucket's graph replayed and its output copied into a
  fresh tensor) and the captured path with the rows copied to the static
  input straight from the numpy array (pageable memory). The captured
  spellings need a tree whose engine captures.

``--src`` runs another tree's package (its ``git archive``'s ``src``): run
two trees in turns in one call (old, new, new, old) to compare them. Prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D, M, BATCH, BLOCK, LIVE = 2048, 1000, 64, 32, 30


def _stats(us) -> dict:
    import numpy as np

    return {"p50_us": statistics.median(us), "p99_us": float(np.percentile(us, 99)),
            "mean_us": statistics.fmean(us)}


def _timed(fn, n: int, sync) -> dict:
    """Host us of ``fn()`` over n calls, the device drained every 32 calls
    outside the timed calls."""
    us = []
    for i in range(n):
        if i % 32 == 0:
            sync()
        t0 = time.perf_counter()
        fn()
        us.append(1e6 * (time.perf_counter() - t0))
    sync()
    return _stats(us)


def _spelled(steps, n: int, sync) -> dict:
    """Run the dispatch ``steps`` (name, fn(carry) -> carry) in order n times,
    timing each step inside the sequence; "dispatch" sums all but the last
    (``block()``)."""
    parts = {name: [] for name, _ in steps}
    parts["dispatch"] = []
    for i in range(n):
        if i % 32 == 0:
            sync()
        carry = None
        total = 0.0
        for j, (name, fn) in enumerate(steps):
            t0 = time.perf_counter()
            carry = fn(carry)
            us = 1e6 * (time.perf_counter() - t0)
            parts[name].append(us)
            if j < len(steps) - 1:
                total += us
        parts["dispatch"].append(total)
    sync()
    return {name: _stats(us) for name, us in parts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run (default: this checkout's)")
    ap.add_argument("--n", type=int, default=2000, help="calls timed a part")
    ap.add_argument("--report", default=None, help="also write the figures here (JSON)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA: the times come from the card", file=sys.stderr)
        return 1
    from repro_torch import resolve_device, serve
    from repro_torch.kernels import _build
    from repro_torch.kernels.factor_matvec import ops as fm_ops
    from repro_torch.serve import engine as serve_engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(f"repro_torch from {Path(serve.__file__).resolve().parents[1]}")
    dev = resolve_device("cuda")
    _build.build_all()
    rng = np.random.default_rng(0)
    packed = {"u": rng.standard_normal((LIVE, D)).astype(np.float32),
              "s": rng.standard_normal(LIVE).astype(np.float32),
              "v": rng.standard_normal((LIVE, M)).astype(np.float32),
              "alpha": np.float32(0.5), "count": np.int32(LIVE)}
    eng = serve.ServingEngine(D, M, serve.ServeConfig(max_batch=BATCH, rank_block=BLOCK),
                              device=dev)
    model = eng.load(packed)
    x = rng.standard_normal((BATCH, D)).astype(np.float32)
    sync = torch.cuda.synchronize
    for _ in range(50):
        eng.score(x)

    def checks(_):
        xh = np.asarray(x, np.float32)
        if xh.ndim == 1:
            xh = xh[None, :]
        b, n_in = xh.shape
        if n_in != eng.n_in or not 1 <= b <= eng.cfg.max_batch:
            raise ValueError("bad batch")
        return xh

    def pinned_zeros(xh):
        pad = torch.zeros((BATCH, D), dtype=torch.float32, pin_memory=True)
        pad[:xh.shape[0]] = torch.from_numpy(xh)
        return pad

    def pinned_numpy(xh):
        pad = torch.empty((BATCH, D), dtype=torch.float32, pin_memory=True)
        staged = pad.numpy()
        staged[:xh.shape[0]] = xh
        staged[xh.shape[0]:] = 0.0
        return pad

    def block(h):
        return h.block()

    def handle(raw):
        return serve_engine.PendingScores(raw, BATCH, model)

    spellings = {"eager": [
        ("numpy conversion", checks), ("pinned staging", pinned_zeros),
        ("copy to the card", lambda pad: pad.to(dev, non_blocking=True)),
        ("factor_matvec wrapper", lambda xd: fm_ops.factor_matvec(xd, model.u, model.s_alpha,
                                                                  model.v)),
        ("handle", handle), ("block", block)]}
    buckets = getattr(eng, "_buckets", None)
    bucket = buckets.get(model.capacity) if isinstance(buckets, dict) else None
    if bucket is not None and bucket.graph is not None:
        static = eng._x

        def replay(_):
            bucket.graph.replay()
            return bucket.out.clone()

        def pageable(xh):
            static[:xh.shape[0]].copy_(torch.from_numpy(xh), non_blocking=True)
            if xh.shape[0] < BATCH:
                static[xh.shape[0]:].zero_()

        spellings["captured"] = [
            ("numpy conversion", checks), ("pinned staging", pinned_numpy),
            ("copy to the card", lambda pad: static.copy_(pad, non_blocking=True)),
            ("replay and copy out", replay), ("handle", handle), ("block", block)]
        spellings["captured, pageable"] = [
            ("numpy conversion", checks), ("copy to the card", pageable),
            ("replay and copy out", replay), ("handle", handle), ("block", block)]
    out = {"device": smi, "src": str(Path(args.src).resolve()), "n": args.n,
           "engine": {"score_async": _timed(lambda: eng.score_async(x), args.n, sync),
                      "score": _timed(lambda: eng.score(x), args.n, sync)}}
    for name, row in out["engine"].items():
        print(f"  engine {name:34s} p50 {row['p50_us']:8.2f} us  p99 {row['p99_us']:8.2f} us")
    for label, steps in spellings.items():
        out[label] = rows = _spelled(steps, args.n, sync)
        print(f"  {label}:")
        for name, row in rows.items():
            print(f"    {name:36s} p50 {row['p50_us']:8.2f} us  p99 {row['p99_us']:8.2f} us  "
                  f"mean {row['mean_us']:8.2f} us")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(out, indent=1))
    print(json.dumps({label: {k: round(v["p50_us"], 2) for k, v in rows.items()}
                      for label, rows in out.items() if isinstance(rows, dict)
                      and label not in ("device",)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
