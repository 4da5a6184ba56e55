#!/usr/bin/env python3
"""Epochs to 10% of rank1's first duality gap, rank1 against the block
solver, for the JAX package and the PyTorch port on the same data, on the
CPU: the Table-1 cell of ``benchmarks/block_fw_convergence.py``.

    JAX_PLATFORMS=cpu python3 tools/torch_block_epochs_to_gap.py [--seed 0]
        [--inject] [--out PATH]

The data are made once with numpy from --seed, as the benchmark makes its own
with JAX keys: W* = U diag(sv / sum sv) V^T with U, V the Q factors of
Gaussian (d, rank) and (m, rank) matrices and sv = linspace(1, 0.1, rank)
(trace norm 1); least squares X (n, d) Gaussian and Y = X W*; matrix
completion the entries of W* at a Bernoulli(obs) mask. Both packages then
run, serially, with mu = 1 and the line search: rank1 at const:2 within the
epoch budget (its first gap sets the target, 10% of it), then block:k:adapt
and block:k:adapt:cold at const:8, stopped by gap_tol at the target, with
block_epochs = 5, as the benchmark runs them. Each package draws its own
start vectors (the JAX package from PRNGKey(1), the port from seed 1), so
the two runs of a solver differ by the draws, not the data; with --inject
the port takes the reference's instead (rank1's start vectors and the block
runs' fresh columns of every epoch through ``V0Stream.from_table``, the
cold-start probe ``init_probe``), so the two differ only by rounding. Prints the
epoch counts of each package beside the JAX package's record in
BENCH_smoke.json (MTLS 79 / 5, MC 101 / 15, made on the benchmark's own
data with JAX 0.4.37; the benchmark itself gives 72 / 5 and 105 / 22 with
JAX 0.9.0, whose keys draw another problem), the speedups (rank1 / warm
block; a rank1 run that misses the target counts the budget) and the
cold-over-warm ratios; --out writes them as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RECORD = {"mtls": (79, 5), "mc": (101, 15)}  # BENCH_smoke.json: rank1, block:32:adapt
# the benchmark's Table-1 cell: d x m, rank of W*, rows of X, the observed
# share for matrix completion, the epoch budget, the block width
D, M, RANK, N, OBS, BUDGET, K = 1024, 1024, 32, 2048, 0.05, 160, 32


def make_data(seed):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((D, RANK)))[0]
    v = np.linalg.qr(rng.standard_normal((M, RANK)))[0]
    sv = np.linspace(1.0, 0.1, RANK)
    w = (u * (sv / sv.sum())) @ v.T
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    rows, cols = np.nonzero(rng.random((D, M)) < OBS)
    vals = w[rows, cols].astype(np.float32)
    return dict(x=x, y=y, rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals)


def epochs_to(gaps, target):
    return next((i + 1 for i, g in enumerate(gaps) if g <= target), None)


def reference_draws(m):
    """The JAX runs' draws: rank1's start vectors (budget, m), the block
    runs' fresh columns (budget, m, k) and the cold-start probe."""
    import jax
    from repro.core import frank_wolfe
    from repro.core.power_method import sphere_vector

    key = jax.random.PRNGKey(1)
    v0 = np.stack([np.asarray(sphere_vector(jax.random.fold_in(key, t), m))
                   for t in range(BUDGET)])
    cols = np.stack([np.stack([np.asarray(sphere_vector(
        jax.random.fold_in(jax.random.fold_in(key, t), 101 + j), m)) for j in range(K)], 1)
        for t in range(BUDGET)])
    return v0, cols, np.asarray(frank_wolfe.init_probe(f"block:{K}", m))


def run_package(pkg, kind, data, args):
    """{solver label: gap history} for rank1, warm and cold block runs."""
    if pkg == "jax":
        import jax
        from repro.core import tasks
        from repro.launch import dfw

        extra = dict(use_pallas=False)
        fit = lambda task, x, y, cfg: dfw.fit_serial(  # noqa: E731
            task, x, y, cfg=cfg, key=jax.random.PRNGKey(1))
    else:
        from repro_torch.core import tasks
        from repro_torch.launch import dfw

        from repro_torch import V0Stream

        extra = {}
        draws = {"rank1": dict(key=1), "block": dict(key=1)}
        if args.inject:
            v0, cols, probe = reference_draws(M)
            draws = {"rank1": dict(key=V0Stream.from_table(v0)),
                     "block": dict(key=V0Stream.from_table(cols), probe=probe)}
        fit = lambda task, x, y, cfg: dfw.fit_serial(  # noqa: E731
            task, x, y, cfg=cfg, device="cpu", **draws[cfg.solver.split(":")[0]])
    if kind == "mtls":
        task, x, y = tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]
    else:
        task = tasks.MatrixCompletion(D, M)
        x, y = tasks.pack_observations(data["rows"], data["cols"], data["vals"])
        x, y = np.asarray(x), np.asarray(y)

    def run(solver, schedule, gap_tol=None):
        cfg = dfw.DFWConfig(mu=1.0, num_epochs=BUDGET, schedule=schedule,
                            step_size="linesearch", solver=solver, gap_tol=gap_tol,
                            block_epochs=5, verify_kernels=False, **extra)
        return [float(g) for g in fit(task, x, y, cfg).history["gap"]]

    t0 = time.perf_counter()
    out = {"rank1": run("rank1", "const:2")}
    target = 0.1 * out["rank1"][0]
    out["warm"] = run(f"block:{K}:adapt", "const:8", target)
    out["cold"] = run(f"block:{K}:adapt:cold", "const:8", target)
    r1, warm, cold = (epochs_to(out[s], target) for s in ("rank1", "warm", "cold"))
    matched = min(len(out["warm"]), len(out["cold"]))
    return dict(rank1_epochs=r1, warm_epochs=warm, cold_epochs=cold, gap0=out["rank1"][0],
                target=target,
                speedup=None if warm is None else (r1 if r1 is not None else BUDGET) / warm,
                cold_over_warm_epochs=None if warm is None or cold is None else cold / warm,
                cold_over_warm_gap=out["cold"][matched - 1] / max(out["warm"][matched - 1], 1e-12),
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject", action="store_true",
                    help="the port's block runs take the reference's random draws")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(4)
    data = make_data(args.seed)
    report = {"device": "cpu", "config": dict(vars(args), d=D, m=M, rank=RANK, n=N, obs=OBS,
                                                budget=BUDGET, k=K), "cells": {}}
    for kind in ("mtls", "mc"):
        for pkg in ("jax", "torch"):
            cell = run_package(pkg, kind, data, args)
            report["cells"][f"{kind}/{pkg}"] = cell
            rec = RECORD[kind]
            print(f"{kind} {pkg:5s}: epochs to 10% of rank1's first gap: rank1 "
                  f"{cell['rank1_epochs'] if cell['rank1_epochs'] is not None else 'budget'}, "
                  f"block:{K}:adapt {cell['warm_epochs']}, :cold {cell['cold_epochs']}; "
                  f"speedup {cell['speedup']}; cold/warm epochs {cell['cold_over_warm_epochs']}, "
                  f"gap {cell['cold_over_warm_gap']:.3f} (BENCH_smoke.json, JAX on its own data: "
                  f"{rec[0]} / {rec[1]}; {cell['seconds']:.1f} s)")
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
