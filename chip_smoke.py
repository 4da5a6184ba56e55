#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, as on an H100

Phases, each fatal on failure (exit code != 0, no result line):

1. Build the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes (n = 1,281,167 rows; R is n x 1000, X is n x 2048) and
   at tiny odd shapes, and time kernel, plain version and the one PyTorch
   call that computes the same function (CUDA events, median of --reps).
3. Drive the main path, ``launch.dfw.fit_serial``, for multi-task least
   squares at the paper's ImageNet shapes (n = 1,281,167, d = 2048,
   m = 1000, f32): planted rank-10 trace-norm-1 W* plus small noise, log
   schedule, line search, --epochs epochs. The loss must be finite and
   non-increasing and every kernel launch count must be what the path
   implies.
4. The same for multinomial logistic regression (planted rank-10 labels,
   5% label noise, log_half schedule): final loss below n ln m.
5. Hold small fits on the card against the same fits on the CPU (plain
   versions), with the same start vectors: histories agree to rtol 1e-4.

``--profile`` adds 3-epoch fits of both tasks under ``torch.profiler``
(device time by kernel, the device's idle share); ``--report PATH`` writes
every number to a JSON file.

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or run from a directory
without ``src/repro_torch``, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

PAPER_N, PAPER_D, PAPER_M = 1_281_167, 2048, 1000
TPU_KERNEL = {
    "matvec": "src/repro/kernels/power_matvec/kernel.py:50",
    "rmatvec": "src/repro/kernels/power_matvec/kernel.py:78",
    "rank1_update": "src/repro/kernels/rank1_update/kernel.py:34",
    "rank1_update_axpy": "src/repro/kernels/rank1_update/kernel.py:62",
}
SOURCE = {
    "matvec": "src/repro_torch/csrc/power_matvec.cu",
    "rmatvec": "src/repro_torch/csrc/power_matvec.cu",
    "rank1_update": "src/repro_torch/csrc/rank1_update.cu",
    "rank1_update_axpy": "src/repro_torch/csrc/rank1_update.cu",
}
# Memory rate (bytes/s) and f32 non-tensor-core peak (flop/s) of each part
# this script has run on, from NVIDIA's data sheet, keyed by
# torch.cuda.get_device_name. Another part fails the run until its entry is
# added, so that no bound is computed from another card's peaks.
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
# Kernel-vs-plain tolerances (max |kernel - plain| / max |plain|): the
# matvecs sum up to 1.28M f32 terms in another order than cuBLAS; the rank-1
# update is spelled in the plain version's order and should match its bits.
TOL = {"matvec": 1e-4, "rmatvec": 1e-4, "rank1_update": 1e-6, "rank1_update_axpy": 1e-6}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


class Check(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Check(msg)


def card_peaks(name: str):
    check(name in CARD_PEAKS, f"no peak table entry for {name!r}: add its memory rate "
          "and f32 peak to CARD_PEAKS")
    return CARD_PEAKS[name]


def time_ms(torch, fn, reps: int) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events)."""
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


def rel_err(torch, got, want):
    diff = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    return diff, diff / max(scale, 1e-30)


def kernel_phase(torch, pm, r1, dev, X, R, Y, gen, reps, peaks):
    """Every kernel against its plain version at full and tiny odd shapes."""
    bw, flops = peaks
    n = X.shape[0]
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    g = torch.full((), 0.3, device=dev)
    a, b, c = 1.0 - g, -g, -g * 0.5
    scal2, scal3 = torch.stack([a, b]), torch.stack([a, b, c])
    x_n, y_m = rn(n), rn(PAPER_M)
    out = torch.empty_like(R)

    cases = []  # (kernel, operand, kernel fn, plain fn, library fn, bytes, flops)
    for label, A in (("R", R), ("X", X)):
        rows, cols = A.shape
        v, u = rn(cols), rn(rows)
        cases.append(("matvec", label, lambda A=A, v=v: pm.matvec(A, v),
                      lambda A=A, v=v: pm.ref.matvec(A, v),
                      lambda A=A, v=v: torch.mv(A, v),
                      4 * (rows * cols + rows + cols), 2 * rows * cols))
        cases.append(("rmatvec", label, lambda A=A, u=u: pm.rmatvec(A, u),
                      lambda A=A, u=u: pm.ref.rmatvec(A, u),
                      lambda A=A, u=u: torch.mv(A.t(), u),
                      4 * (rows * cols + rows + cols), 2 * rows * cols))
    nm = n * PAPER_M
    cases.append(("rank1_update", "R",
                  lambda: r1.rank1_update(R, x_n, y_m, a, b, out=out),
                  lambda: r1.ref.rank1_update(R, x_n, y_m, scal2),
                  lambda: torch.addr(R, x_n, y_m, beta=0.7, alpha=-0.3),
                  8 * nm + 4 * (n + PAPER_M), 4 * nm))
    cases.append(("rank1_update_axpy", "R",
                  lambda: r1.rank1_update_axpy(R, Y, x_n, y_m, a, b, c, out=out),
                  lambda: r1.ref.rank1_update_axpy(R, Y, x_n, y_m, scal3),
                  None, 12 * nm + 4 * (n + PAPER_M), 6 * nm))

    rows_out = []
    for name, label, kfn, pfn, lfn, nbytes, nflops in cases:
        got = kfn()
        torch.cuda.synchronize()
        err_abs, err_rel = rel_err(torch, got, pfn())
        check(math.isfinite(err_rel) and err_rel <= TOL[name],
              f"{name} on {label}: max rel err {err_rel:.3e} > {TOL[name]:.0e}")
        del got
        row = dict(
            name=name, operand=label,
            shape=list(R.shape if label == "R" else X.shape),
            max_abs_err=err_abs, max_rel_err=err_rel,
            ms=time_ms(torch, kfn, reps), plain_ms=time_ms(torch, pfn, reps),
            library_ms=time_ms(torch, lfn, reps) if lfn is not None else None,
            bound_ms=1e3 * max(nbytes / bw, nflops / flops),
            bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
            bytes=nbytes,
        )
        if name == "rank1_update_axpy":
            # No single PyTorch call computes it; the shortest chain is three.
            row["library_chain_ms"] = time_ms(
                torch, lambda: torch.mul(R, 0.7).add_(Y, alpha=-0.15).addr_(
                    x_n, y_m, alpha=-0.3), reps)
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
        rows_out.append(row)
        print(f"kernel {name:18s} {label} {tuple(row['shape'])}: {row['ms']:.3f} ms "
              f"(plain {row['plain_ms']:.3f}, library {row['library_ms']}, bound "
              f"{row['bound_ms']:.3f}, {row['GB_per_s']:.0f} GB/s) rel err {err_rel:.2e}")
    del out

    # Tiny odd shapes, 16-byte aligned and not: the ragged and scalar paths.
    for (rows, cols) in ((37, 5), (1, 7), (65, 33), (300, 1000)):
        for aligned in (True, False):
            def mk(*s):
                t = rn(math.prod(s) + (0 if aligned else 1))
                return (t if aligned else t[1:]).view(*s)
            A, Y0 = mk(rows, cols), mk(rows, cols)
            v, u, xs, ys = rn(cols), rn(rows), rn(rows), rn(cols)
            pairs = [
                ("matvec", pm.matvec(A, v), pm.ref.matvec(A, v)),
                ("rmatvec", pm.rmatvec(A, u), pm.ref.rmatvec(A, u)),
                ("rank1_update", r1.rank1_update(A, xs, ys, a, b),
                 r1.ref.rank1_update(A, xs, ys, scal2)),
                ("rank1_update_axpy", r1.rank1_update_axpy(A, Y0, xs, ys, a, b, c),
                 r1.ref.rank1_update_axpy(A, Y0, xs, ys, scal3)),
            ]
            torch.cuda.synchronize()
            for name, got, want in pairs:
                err = rel_err(torch, got, want)[1]
                check(err <= TOL[name],
                      f"{name} at {rows}x{cols} aligned={aligned}: rel err {err:.3e}")
    # Determinism of the two-stage rmatvec: identical bits on repeat.
    u = rn(n)
    check(torch.equal(pm.rmatvec(X, u), pm.rmatvec(X, u)), "rmatvec is not bit-stable")
    print("kernels match their plain versions at full and odd shapes; rmatvec bit-stable")
    return rows_out


def planted(torch, gen, dev, d, m, rank=10):
    """W* = U diag(s / sum s) V^T: rank 10, trace norm 1 (examples/quickstart.py)."""
    u = torch.linalg.qr(torch.randn(d, rank, generator=gen, device=dev))[0]
    v = torch.linalg.qr(torch.randn(m, rank, generator=gen, device=dev))[0]
    s = torch.linspace(1.0, 0.1, rank, device=dev)
    return u * (s / s.sum()), v


def segment_timer(torch, log):
    """fit callback: wall time per segment (the callback already syncs)."""
    state = {"t": time.perf_counter()}

    def cb(start, aux):
        now = time.perf_counter()
        live = int(sum(1 for g in aux.gap if g == g))
        log.append(dict(start=start, epochs=live, ms_per_epoch=1e3 * (now - state["t"]) / live))
        state["t"] = now

    return cb


def expected_launches(kind: str, ks, verify: bool):
    """Launches the path implies: per power iteration, MTLS runs R.v, X^T t,
    X.u and R^T s (2 matvec + 2 rmatvec) and logistic X^T (Pv - v_y) and X.u
    (1 + 1); each epoch adds the update's X.u (and, for MTLS, the line
    search's) and one rank-1 update. verify_kernelized runs one iteration's
    worth before the fit."""
    per_iter = 2 if kind == "mtls" else 1
    iters = sum(ks) + (1 if verify else 0)
    e = len(ks)
    return {
        "matvec": per_iter * iters + (2 * e if kind == "mtls" else e),
        "rmatvec": per_iter * iters,
        "rank1_update": 0 if kind == "mtls" else e,
        "rank1_update_axpy": e if kind == "mtls" else 0,
    }


def run_path(torch, kernels, dfw, tasks, kind, X, target, cfg, seed, dev):
    kernels.reset_launches()
    seg_log = []
    task = (tasks.MultiTaskLeastSquares if kind == "mtls" else tasks.MultinomialLogistic)(
        PAPER_D, PAPER_M)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dfw.fit_serial(task, X, target, cfg=cfg, key=seed, device=dev,
                         callback=segment_timer(torch, seg_log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    want = expected_launches(kind, res.history["k"], cfg.verify_kernels)
    check(launches == want, f"{kind}: launches {launches} != expected {want}")
    loss = res.history["loss"]
    check(res.epochs_run == cfg.num_epochs, f"{kind}: ran {res.epochs_run} epochs")
    check(all(math.isfinite(v) for v in loss + [res.final_loss]), f"{kind}: non-finite loss")
    print(f"{kind}: {res.epochs_run} epochs in {wall:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {launches}")
    for s in seg_log:
        print(f"  {kind} segment from epoch {s['start']}: {s['epochs']} epochs, "
              f"{s['ms_per_epoch']:.2f} ms/epoch")
    print(f"  {kind} loss: " + ", ".join(f"{v:.6g}" for v in loss)
          + f"; final {res.final_loss:.6g}")
    return res, launches, dict(wall_s=wall, segments=seg_log, loss=loss,
                               final_loss=res.final_loss, launches=launches,
                               peak_gb=torch.cuda.max_memory_allocated() / 1e9)


PORT_KERNELS = ("matvec_kernel", "rmatvec_partial_kernel", "rmatvec_finish_kernel",
                "rank1_kernel")


def profile_fit(torch, dfw, tasks, kind, X, target, cfg, seed, dev):
    """Device time by kernel over a short fit under torch.profiler: the
    port's kernels against everything else (plain PyTorch and cuBLAS), and
    the device's busy share of the wall time (the profiler's own overhead
    is inside that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    task = (tasks.MultiTaskLeastSquares if kind == "mtls" else tasks.MultinomialLogistic)(
        PAPER_D, PAPER_M)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = dfw.fit_serial(task, X, target, cfg=cfg, key=seed, device=dev)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels_us = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels_us[ev.key] = kernels_us.get(ev.key, 0.0) + ev.self_device_time_total
    port = sum(t for k, t in kernels_us.items() if any(p in k for p in PORT_KERNELS))
    busy = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    out = dict(epochs=res.epochs_run, ks=res.history["k"], wall_ms=wall_us / 1e3,
               device_busy_ms=busy / 1e3, port_kernels_ms=port / 1e3,
               other_kernels_ms=(busy - port) / 1e3,
               idle_share=1.0 - busy / wall_us if busy else None,
               top=[(k[:90], t / 1e3) for k, t in top])
    if busy:
        print(f"profile {kind} ({res.epochs_run} epochs, K={res.history['k']}): wall "
              f"{out['wall_ms']:.1f} ms, device busy {out['device_busy_ms']:.1f} ms (port "
              f"kernels {out['port_kernels_ms']:.1f}, other {out['other_kernels_ms']:.1f}), "
              f"idle share {out['idle_share']:.3f}")
        for k, t in out["top"]:
            print(f"  {t:9.2f} ms  {k}")
    else:
        print(f"profile {kind}: the profiler recorded no device time (not measured)")
    return out


def small_parity(torch, np, V0Stream, dfw, tasks, dev):
    """The same small fits on the card (kernels) and on the CPU (plain
    versions), same data and start vectors: histories agree to rtol 1e-4."""
    rng = np.random.default_rng(0)
    n, d, m = 700, 48, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, 5)) @ rng.standard_normal((5, m)) / 50
    y = (x @ w + 0.01 * rng.standard_normal((n, m))).astype(np.float32)
    labels = np.argmax(x @ w, axis=1)
    table = rng.standard_normal((12, m)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    for kind, target, kw in (
        ("mtls", y, dict(mu=1.0, num_epochs=12, schedule="log", step_size="linesearch")),
        ("logistic", labels, dict(mu=5.0, num_epochs=12, schedule="log_half")),
    ):
        task = (tasks.MultiTaskLeastSquares if kind == "mtls" else tasks.MultinomialLogistic)(d, m)
        runs = [dfw.fit_serial(task, x, target, cfg=dfw.DFWConfig(**kw),
                               key=V0Stream.from_table(table), device=where)
                for where in (dev, "cpu")]
        for name in ("loss", "gap", "sigma", "gamma"):
            got, want = np.array(runs[0].history[name]), np.array(runs[1].history[name])
            err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max()))
            check(err <= 1e-4, f"small {kind} {name}: card vs CPU rel err {err:.2e}")
        print(f"small {kind} fit: card matches CPU (rtol 1e-4)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=PAPER_N, help="n (depth cut only)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--logistic-epochs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--report", default=None, help="also write the full report here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3-epoch fits (device time by kernel, idle share)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available; this script runs the port on a GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch import V0Stream, kernels, resolve_device
    from repro_torch.core import tasks
    from repro_torch.kernels import _build
    from repro_torch.kernels import power_matvec as pm
    from repro_torch.kernels import rank1_update as r1
    from repro_torch.launch import dfw

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    report = dict(device=name, torch=torch.__version__, cuda=torch.version.cuda)
    try:
        # 1. build + card
        t0 = time.perf_counter()
        _build.build_all()
        report["build_s"] = time.perf_counter() - t0
        print(f"built kernels in {report['build_s']:.1f} s into {_build.BUILD_DIR}")
        for src_name in ("power_matvec", "rank1_update"):
            for line in _build.build_log(src_name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {src_name}: {line.strip()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        report["nvidia_smi"] = smi
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
        peaks = card_peaks(name)

        # data for the main path, made on the card from --seed
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        n = args.rows
        t0 = time.perf_counter()
        X = torch.randn(n, PAPER_D, generator=gen, device=dev)
        wu, wv = planted(torch, gen, dev, PAPER_D, PAPER_M)
        Y = (X @ wu) @ wv.T
        Y.add_(torch.randn(n, PAPER_M, generator=gen, device=dev), alpha=0.01)
        torch.cuda.synchronize()
        print(f"data: X {tuple(X.shape)}, Y {tuple(Y.shape)} f32 made in "
              f"{time.perf_counter() - t0:.1f} s")

        # 2. kernels against their plain versions
        R = -Y
        krows = kernel_phase(torch, pm, r1, dev, X, R, Y, gen, args.reps, peaks)
        del R
        torch.cuda.empty_cache()

        # 3. MTLS main path
        cfg = dfw.DFWConfig(mu=1.0, num_epochs=args.epochs, schedule="log",
                            step_size="linesearch")
        res, mtls_launch, report["mtls"] = run_path(
            torch, kernels, dfw, tasks, "mtls", X, Y, cfg, args.seed, dev)
        loss = res.history["loss"] + [res.final_loss]
        check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])),
              "mtls: loss increased")
        check(res.final_loss < loss[0], "mtls: final loss not below the initial loss")
        if args.profile:
            del res
            report["mtls_profile"] = profile_fit(
                torch, dfw, tasks, "mtls", X, Y, dfw.DFWConfig(
                    mu=1.0, num_epochs=3, schedule="const:3", step_size="linesearch",
                    verify_kernels=False), args.seed, dev)
            res = None
        del res, Y
        torch.cuda.empty_cache()

        # 4. logistic main path: planted rank-10 labels with 5% label noise
        W = torch.randn(PAPER_D, 10, generator=gen, device=dev) @ torch.randn(
            10, PAPER_M, generator=gen, device=dev)
        labels = torch.argmax(X @ W, dim=1)
        flip = torch.rand(n, generator=gen, device=dev) < 0.05
        labels = torch.where(
            flip, torch.randint(0, PAPER_M, (n,), generator=gen, device=dev), labels)
        del W, flip
        cfg = dfw.DFWConfig(mu=10.0, num_epochs=args.logistic_epochs, schedule="log_half")
        res, log_launch, report["logistic"] = run_path(
            torch, kernels, dfw, tasks, "logistic", X, labels, cfg, args.seed, dev)
        bound = n * math.log(PAPER_M)
        check(res.final_loss < bound, f"logistic: final loss {res.final_loss} >= n ln m {bound}")
        print(f"logistic final loss {res.final_loss:.6g} < n ln m = {bound:.6g}")
        if args.profile:
            del res
            report["logistic_profile"] = profile_fit(
                torch, dfw, tasks, "logistic", X, labels, dfw.DFWConfig(
                    mu=10.0, num_epochs=3, schedule="const:2", verify_kernels=False),
                args.seed, dev)
            res = None
        del res, X, labels
        torch.cuda.empty_cache()

        # 5. small fits, card against CPU
        small_parity(torch, np, V0Stream, dfw, tasks, dev)
    except Check as e:
        return fail(str(e))

    out = []
    for kname in ("matvec", "rmatvec", "rank1_update", "rank1_update_axpy"):
        rows = [r for r in krows if r["name"] == kname]
        main_row = max(rows, key=lambda r: r["bytes"])
        out.append(dict(
            name=kname, route="cuda", source=SOURCE[kname], replaces=TPU_KERNEL[kname],
            launches=mtls_launch[kname] + log_launch[kname],
            max_abs_err=main_row["max_abs_err"], max_rel_err=main_row["max_rel_err"],
            ms=main_row["ms"], plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
            shape=main_row["shape"],
            by_operand={r["operand"]: {k: r[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "max_rel_err")}
                for r in rows},
        ))
    report["kernels"] = krows
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
