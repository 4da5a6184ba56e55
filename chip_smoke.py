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
6. Make matrix-completion data on the card from --seed at the Netflix Prize
   shapes (d = 480,189 users, m = 17,770 movies, 100,480,507 training and
   1,408,395 held-out ratings; users and movies drawn from popularity laws
   whose busiest user and movie hold about as many ratings as in the
   published data; values from a planted rank-10 matrix plus noise 0.1).
7. Hold the COO matvec (both directions) and the int8 quantize pair against
   their plain versions at those shapes and at tiny odd ones, and time them.
8. Drive ``fit_serial`` for matrix completion (comm "dense", log schedule,
   line search, --mc-epochs): loss finite and non-increasing, held-out RMSE
   below that of W = 0, launch counts as the path implies.
9. The same with comm "int8" (--mc-int8-epochs): loss ends below its start,
   quantize and dequantize launched 2K times per epoch each.
10. Small MC fits, dense and int8, on the card against the CPU with the same
   start vectors and noise.

``--profile`` adds 3-epoch fits of the three tasks under ``torch.profiler``
(device time by kernel, the device's idle share); ``--report PATH`` writes
every number to a JSON file. ``--rows`` and ``--mc-entries`` cut depth
(samples, training ratings) for a quick check; the defaults are the full
sizes.

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
# Netflix Prize shapes: users, movies, training ratings, held-out (probe-size)
# ratings. Popularity exponents: a user (movie) of popularity rank r is drawn
# with probability proportional to (r + 1)^-a; these give a busiest user of
# ~17.7 thousand and a busiest movie of ~235 thousand ratings, as in the
# published data (17,653 and 232,944).
NF_D, NF_M, NF_P, NF_TEST = 480_189, 17_770, 100_480_507, 1_408_395
USER_A, MOVIE_A = 0.375, 0.44
TPU_KERNEL = {
    "matvec": "src/repro/kernels/power_matvec/kernel.py:50",
    "rmatvec": "src/repro/kernels/power_matvec/kernel.py:78",
    "rank1_update": "src/repro/kernels/rank1_update/kernel.py:34",
    "rank1_update_axpy": "src/repro/kernels/rank1_update/kernel.py:62",
    "coo_matvec": "src/repro/kernels/mc_matvec/kernel.py:58",
    "quantize": "src/repro/kernels/quantize/kernel.py:49",
    "dequantize": "src/repro/kernels/quantize/kernel.py:81",
}
SOURCE = {
    "matvec": "src/repro_torch/csrc/power_matvec.cu",
    "rmatvec": "src/repro_torch/csrc/power_matvec.cu",
    "rank1_update": "src/repro_torch/csrc/rank1_update.cu",
    "rank1_update_axpy": "src/repro_torch/csrc/rank1_update.cu",
    "coo_matvec": "src/repro_torch/csrc/mc_matvec.cu",
    "quantize": "src/repro_torch/csrc/quantize.cu",
    "dequantize": "src/repro_torch/csrc/quantize.cu",
}
# Memory rate (bytes/s) and f32 non-tensor-core peak (flop/s) of each part
# this script has run on, from NVIDIA's data sheet, keyed by
# torch.cuda.get_device_name. Another part fails the run until its entry is
# added, so that no bound is computed from another card's peaks.
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
# Kernel-vs-plain tolerances (max |kernel - plain| / max |plain|): the
# matvecs sum up to 1.28M f32 terms in another order than cuBLAS, and the COO
# matvec segments of up to ~235 thousand terms in another order than the
# atomics of index_add_; the rank-1 update is spelled in the plain version's
# order and should match its bits. The quantize pair must match its plain
# version bit for bit (checked with torch.equal, not by this table).
TOL = {"matvec": 1e-4, "rmatvec": 1e-4, "rank1_update": 1e-6, "rank1_update_axpy": 1e-6,
       "coo_matvec": 1e-4}


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


def expected_launches(kind: str, ks, verify: bool, comm: str = "dense"):
    """Launches the path implies: per power iteration, MTLS runs R.v, X^T t,
    X.u and R^T s (2 matvec + 2 rmatvec), logistic X^T (Pv - v_y) and X.u
    (1 + 1), matrix completion G.v and G^T.u (2 coo_matvec); each dense-task
    epoch adds the update's X.u (and, for MTLS, the line search's) and one
    rank-1 update. Under int8 every exchange (2 per iteration) is one
    quantize and one dequantize. verify_kernelized runs one iteration's
    worth of matvecs before the fit, and verify_quantize_kernels one pair."""
    iters = sum(ks) + (1 if verify else 0)
    e = len(ks)
    want = dict.fromkeys(TPU_KERNEL, 0)
    if kind == "mc":
        want["coo_matvec"] = 2 * iters
    else:
        per_iter = 2 if kind == "mtls" else 1
        want["matvec"] = per_iter * iters + (2 * e if kind == "mtls" else e)
        want["rmatvec"] = per_iter * iters
        want["rank1_update" if kind == "logistic" else "rank1_update_axpy"] = e
    if comm == "int8":
        want["quantize"] = want["dequantize"] = 2 * sum(ks) + (1 if verify else 0)
    return want


def run_path(torch, kernels, dfw, kind, task, X, target, cfg, seed, dev):
    kernels.reset_launches()
    seg_log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dfw.fit_serial(task, X, target, cfg=cfg, key=seed, device=dev,
                         callback=segment_timer(torch, seg_log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    want = expected_launches(kind, res.history["k"], cfg.verify_kernels, cfg.comm)
    check(launches == want, f"{kind}/{cfg.comm}: launches {launches} != expected {want}")
    loss = res.history["loss"]
    check(res.epochs_run == cfg.num_epochs, f"{kind}: ran {res.epochs_run} epochs")
    check(all(math.isfinite(v) for v in loss + [res.final_loss]), f"{kind}: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{kind}/{cfg.comm}: {res.epochs_run} epochs in {wall:.2f} s, peak device memory "
          f"{peak:.2f} GB, launches {launches}")
    for s in seg_log:
        print(f"  {kind} segment from epoch {s['start']} (K={res.history['k'][s['start']]}): "
              f"{s['epochs']} epochs, {s['ms_per_epoch']:.2f} ms/epoch")
    print(f"  {kind} loss: " + ", ".join(f"{v:.6g}" for v in loss)
          + f"; final {res.final_loss:.6g}")
    return res, launches, dict(wall_s=wall, segments=seg_log, loss=loss, ks=res.history["k"],
                               final_loss=res.final_loss, launches=launches, peak_gb=peak)


PORT_KERNELS = ("matvec_kernel", "rmatvec_partial_kernel", "rmatvec_finish_kernel",
                "rank1_kernel", "piece_sum_kernel", "segment_sum_kernel", "quantize_kernel",
                "dequantize_kernel")


def profile_fit(torch, kind, run):
    """Device time by kernel over a short fit ``run()`` under torch.profiler:
    the port's kernels against everything else (plain PyTorch and cuBLAS),
    and the device's busy share of the wall time (the profiler's own
    overhead is inside that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels_us, calls = {}, {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels_us[ev.key] = kernels_us.get(ev.key, 0.0) + ev.self_device_time_total
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    port = sum(t for k, t in kernels_us.items() if any(p in k for p in PORT_KERNELS))
    # device time per launch of each port kernel (the CUDA-event times of the
    # kernel phase include the host's launch overhead for short kernels)
    per_launch_us = {p: (sum(t for k, t in kernels_us.items() if p in k)
                         / max(1, sum(c for k, c in calls.items() if p in k)))
                     for p in PORT_KERNELS if any(p in k for k in kernels_us)}
    busy = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]
    out = dict(epochs=res.epochs_run, ks=res.history["k"], wall_ms=wall_us / 1e3,
               device_busy_ms=busy / 1e3, port_kernels_ms=port / 1e3,
               other_kernels_ms=(busy - port) / 1e3,
               idle_share=1.0 - busy / wall_us if busy else None,
               top=[(k[:90], t / 1e3) for k, t in top], port_us_per_launch=per_launch_us)
    if busy:
        print(f"profile {kind} ({res.epochs_run} epochs, K={res.history['k']}): wall "
              f"{out['wall_ms']:.1f} ms, device busy {out['device_busy_ms']:.1f} ms (port "
              f"kernels {out['port_kernels_ms']:.1f}, other {out['other_kernels_ms']:.1f}), "
              f"idle share {out['idle_share']:.3f}")
        for k, t in out["top"]:
            print(f"  {t:9.2f} ms  {k}")
        print("  device us per launch: " + ", ".join(
            f"{k} {v:.2f}" for k, v in per_launch_us.items()))
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


def popularity_draw(torch, gen, dev, n_ids, a, count, chunk=1 << 24):
    """``count`` ids in [0, n_ids), id of popularity rank r drawn with
    probability proportional to (r + 1)^-a (searchsorted on an f64 table);
    ranks are mapped to ids by a random permutation."""
    w = (torch.arange(n_ids, device=dev, dtype=torch.float64) + 1.0) ** -a
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    ids = torch.randperm(n_ids, generator=gen, device=dev).to(torch.int32)
    out = torch.empty(count, dtype=torch.int32, device=dev)
    for lo in range(0, count, chunk):
        hi = min(count, lo + chunk)
        r = torch.rand(hi - lo, generator=gen, device=dev, dtype=torch.float64)
        out[lo:hi] = ids[torch.searchsorted(cdf, r).clamp_(max=n_ids - 1)]
    return out


def make_mc_data(torch, gen, dev, p, p_test, d=NF_D, m=NF_M, rank=10, chunk=1 << 24):
    """Ratings at the Netflix shapes, on the card: (idx, yw) of the training
    entries (``tasks.pack_observations`` layout), the held-out entries, and
    mu = the planted matrix's trace norm. M = U V^T / sqrt(rank) with
    Gaussian U (d, rank), V (m, rank) has unit-variance entries; each rating
    is M_ij plus Gaussian noise of std 0.1. Duplicates are kept (the task
    sums them)."""
    total = p + p_test
    rows = popularity_draw(torch, gen, dev, d, USER_A, total)
    cols = popularity_draw(torch, gen, dev, m, MOVIE_A, total)
    U = torch.randn(d, rank, generator=gen, device=dev)
    V = torch.randn(m, rank, generator=gen, device=dev)
    vals = torch.empty(total, dtype=torch.float32, device=dev)
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        planted = (U[rows[lo:hi]] * V[cols[lo:hi]]).sum(1) / math.sqrt(rank)
        vals[lo:hi] = planted + 0.1 * torch.randn(hi - lo, generator=gen, device=dev)
    ru = torch.linalg.qr(U.double())[1]
    rv = torch.linalg.qr(V.double())[1]
    mu = float(torch.linalg.svdvals(ru @ rv.T).sum()) / math.sqrt(rank)
    idx = torch.stack([rows[:p], cols[:p]], dim=1)
    yw = torch.stack([vals[:p], torch.ones(p, device=dev)], dim=1)
    test = (rows[p:].clone(), cols[p:].clone(), vals[p:].clone())
    del rows, cols, vals
    return idx, yw, test, mu


def mc_stats(torch, idx, d, m):
    """Busiest user and movie, empty users and movies, duplicate entries."""
    rows, cols = idx[:, 0], idx[:, 1]
    rdeg = torch.bincount(rows, minlength=d)
    cdeg = torch.bincount(cols, minlength=m)
    key = torch.sort(rows.long() * m + cols.long()).values
    dups = int((key[1:] == key[:-1]).sum())
    return dict(max_user=int(rdeg.max()), max_movie=int(cdeg.max()),
                mean_user=float(rdeg.float().mean()), mean_movie=float(cdeg.float().mean()),
                empty_users=int((rdeg == 0).sum()), empty_movies=int((cdeg == 0).sum()),
                duplicates=dups)


def mc_kernel_phase(torch, mc, qz, dev, state, gen, reps, peaks):
    """coo_matvec (G.v along the row order, G^T.u along the column order) and
    the quantize pair against their plain versions at the MC shapes and at
    tiny odd shapes; times of kernel, plain version and library call."""
    bw, flops = peaks
    d, m = state.by_row.out_dim, state.by_col.out_dim
    p = state.resid.numel()
    vals = state.resid
    rows_out = []
    for label, order, seg, gat, in_dim in (("G.v", state.by_row, state.rows, state.cols, m),
                                           ("G^T.u", state.by_col, state.cols, state.rows, d)):
        out_dim = order.out_dim
        x = torch.randn(in_dim, generator=gen, device=dev)
        # cuSPARSE CSR SpMV on the same function; building the CSR tensor
        # (the values in sorted order) is set-up and not timed.
        csr = torch.sparse_csr_tensor(order.seg_ptr.to(torch.int32), order.gat_sorted,
                                      vals[order.perm.long()], size=(out_dim, in_dim))
        got = mc.coo_matvec(order, vals, x)
        torch.cuda.synchronize()
        want = mc.ref.coo_matvec(seg, gat, vals, x, out_dim)
        err_abs, err_rel = rel_err(torch, got, want)
        check(math.isfinite(err_rel) and err_rel <= TOL["coo_matvec"],
              f"coo_matvec {label}: max rel err {err_rel:.3e} > {TOL['coo_matvec']:.0e}")
        check(torch.equal(mc.coo_matvec(order, vals, x), got),
              f"coo_matvec {label} is not bit-stable")
        lib_err = rel_err(torch, torch.mv(csr, x), want)[1]
        nbytes = 8 * p + 4 * (in_dim + out_dim)
        row = dict(name="coo_matvec", operand=label, shape=[out_dim, in_dim, p],
                   max_abs_err=err_abs, max_rel_err=err_rel, library_rel_err=lib_err,
                   ms=time_ms(torch, lambda: mc.coo_matvec(order, vals, x), reps),
                   plain_ms=time_ms(torch, lambda: mc.ref.coo_matvec(
                       seg, gat, vals, x, out_dim), reps),
                   library_ms=time_ms(torch, lambda: torch.mv(csr, x), reps),
                   bound_ms=1e3 * max(nbytes / bw, 2 * p / flops),
                   bound_by="bytes" if nbytes / bw >= 2 * p / flops else "operations",
                   bytes=nbytes, pieces=int(order.piece_start.numel()))
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
        rows_out.append(row)
        print(f"kernel coo_matvec {label} ({out_dim} x {in_dim}, {p} entries, "
              f"{row['pieces']} pieces): {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"library {row['library_ms']:.3f}, bound {row['bound_ms']:.3f}) rel err "
              f"{err_rel:.2e} (cuSPARSE {lib_err:.2e}), bit-stable")
        del csr, got, want

    for label, n in (("u", d), ("v", m)):
        x = torch.randn(n, generator=gen, device=dev)
        noise = torch.rand(n, generator=gen, device=dev)
        scale = torch.max(torch.abs(x))
        q = qz.quantize(x, noise, scale, budget=127)
        y = qz.dequantize(q, scale, budget=127)
        torch.cuda.synchronize()
        check(torch.equal(q, qz.ref.quantize(x, noise, scale, 127)),
              f"quantize ({label}, {n}) differs from its plain version")
        check(torch.equal(y, qz.ref.dequantize(q, scale, 127)),
              f"dequantize ({label}, {n}) differs from its plain version")
        for name, kfn, pfn, nbytes in (
            ("quantize", lambda: qz.quantize(x, noise, scale, budget=127),
             lambda: qz.ref.quantize(x, noise, scale, 127), 9 * n + 4),
            ("dequantize", lambda: qz.dequantize(q, scale, budget=127),
             lambda: qz.ref.dequantize(q, scale, 127), 5 * n + 4),
        ):
            row = dict(name=name, operand=f"{label} ({n},)", shape=[n], max_abs_err=0.0,
                       max_rel_err=0.0, ms=time_ms(torch, kfn, reps),
                       plain_ms=time_ms(torch, pfn, reps), library_ms=None,
                       bound_ms=1e3 * max(nbytes / bw, 4 * n / flops),
                       bound_by="bytes" if nbytes / bw >= 4 * n / flops else "operations",
                       bytes=nbytes)
            rows_out.append(row)
            print(f"kernel {name} {label} ({n},): {row['ms']:.4f} ms (plain "
                  f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f}), bit-identical")

    # tiny odd shapes: empty segments, one-entry and multi-piece segments,
    # zero-weight padding (exactly the same bits with and without it)
    for (dd, mm, pp) in ((3, 5, 7), (1, 1, 1), (37, 2, 3000), (500, 41, 1), (64, 1000, 2049)):
        r = torch.randint(0, dd, (pp,), generator=gen, device=dev, dtype=torch.int32)
        c = torch.randint(0, mm, (pp,), generator=gen, device=dev, dtype=torch.int32)
        vv = torch.randn(pp, generator=gen, device=dev)
        xv, xu = torch.randn(mm, generator=gen, device=dev), torch.randn(dd, generator=gen,
                                                                         device=dev)
        zero = torch.zeros(5, dtype=torch.int32, device=dev)
        for seg, gat, od, idim, x in ((r, c, dd, mm, xv), (c, r, mm, dd, xu)):
            got = mc.coo_matvec(mc.build_order(seg, gat, od, idim), vv, x)
            err = rel_err(torch, got, mc.ref.coo_matvec(seg, gat, vv, x, od))[1]
            check(err <= TOL["coo_matvec"], f"coo_matvec at {od}x{idim}, {pp} entries: {err:.3e}")
            padded = mc.coo_matvec(mc.build_order(torch.cat([seg, zero]), torch.cat([gat, zero]),
                                                  od, idim),
                                   torch.cat([vv, torch.zeros(5, device=dev)]), x)
            check(torch.equal(padded, got), f"coo_matvec at {od}x{idim}: padding changed bits")
    for n in (1, 37, 1000):
        for b in (1, 15, 127):
            x = torch.randn(n, generator=gen, device=dev)
            grid = (torch.arange(n, device=dev) % (2 * b + 1) - b).float() * (2.5 / b)
            scale = torch.full((), 2.5, device=dev)
            for xs, ns in ((x, torch.rand(n, generator=gen, device=dev)),
                           (grid, torch.zeros(n, device=dev)), (grid, torch.full((n,), 0.5,
                                                                                  device=dev))):
                q = qz.quantize(xs, ns, scale, budget=b)
                check(torch.equal(q, qz.ref.quantize(xs, ns, scale, b))
                      and torch.equal(qz.dequantize(q, scale, budget=b),
                                      qz.ref.dequantize(q, scale, b)),
                      f"quantize pair at n={n}, budget={b} differs from its plain version")
    print("coo_matvec matches its plain version at full and odd shapes, bit-stable, padding "
          "changes no bit; quantize/dequantize bit-identical to their plain versions")
    return rows_out


class RecordingInt8:
    """An int8 reducer that keeps, per exchange, the pre-floor values
    x * inv + noise and the integers (host copies; small fits only)."""

    def __init__(self, comm, qref, torch):
        self.inner, self.qref, self.torch, self.log = comm.Int8Reducer(1), qref, torch, []
        self.spec = "int8"

    def init_state(self, d, m):
        return ()

    def exchange(self, x, state, *, slot, noise=None):
        torch, b = self.torch, self.inner.budget
        nz = noise(x.shape[0], x.device)
        scale = torch.max(torch.abs(x))
        pre = x * (torch.full_like(scale, float(b)) / (scale + 1e-30)) + nz
        q = self.qref.quantize(x, nz, scale, b)
        self.log.append((pre.cpu().numpy(), q.cpu().numpy()))
        return self.inner.exchange(x, state, slot=slot, noise=lambda n, dev: nz)


def mc_small_parity(torch, np, V0Stream, NoiseStream, comm, qref, dfw, fw, tasks, dev):
    """Small MC fits, dense and int8, on the card and on the CPU with the
    same data, start vectors and noise. Dense: histories agree to rtol 1e-4.
    int8: the same, unless a sum taken in another order moved one value
    x * inv + noise across an integer, so that one q differs by one grid
    step; then the check shows that it is exactly that (|dq| <= 1 where the
    two pre-floor values straddle an integer, both within 1e-3 of each
    other), holds the epochs before it to rtol 1e-4, and the final loss to
    1e-2 (one grid step is 1/127 of the largest element of one vector)."""
    rng = np.random.default_rng(1)
    d, m, p, epochs = 300, 200, 20000, 12
    u0, v0 = rng.standard_normal((d, 4)), rng.standard_normal((m, 4))
    rows = rng.integers(0, d, p).astype(np.int32)
    cols = rng.integers(0, m, p).astype(np.int32)
    w = u0 @ v0.T / 2.0
    vals = (w[rows, cols] + 0.1 * rng.standard_normal(p)).astype(np.float32)
    mu = float(np.linalg.svd(w, compute_uv=False).sum())
    table = rng.standard_normal((epochs, m)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    kmax = 4  # log schedule over 12 epochs: K <= 3
    noise = NoiseStream.from_tables(rng.random((epochs, kmax, d), dtype=np.float32),
                                    rng.random((epochs, kmax, m), dtype=np.float32))
    task = tasks.MatrixCompletion(d, m)
    idx, yw = tasks.pack_observations(rows, cols, vals)
    kw = dict(mu=mu, num_epochs=epochs, schedule="log", step_size="linesearch")
    runs = [dfw.fit_serial(task, idx, yw, cfg=dfw.DFWConfig(**kw),
                           key=V0Stream.from_table(table), device=where)
            for where in (dev, "cpu")]
    for name in ("loss", "gap", "sigma", "gamma"):
        got, want = np.array(runs[0].history[name]), np.array(runs[1].history[name])
        err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max()))
        check(err <= 1e-4, f"small mc {name}: card vs CPU rel err {err:.2e}")
    print("small mc fit (dense): card matches CPU (rtol 1e-4)")

    recs, res = [], []
    for where in (dev, "cpu"):
        rec = RecordingInt8(comm, qref, torch)
        ktask = dfw.kernelize(task)
        state = ktask.init_state(idx.to(where), yw.to(where))
        res.append(fw.fit(ktask, state, key=V0Stream.from_table(table), noise=noise,
                          reducer=rec, device=where, **kw))
        recs.append(rec.log)
    check(len(recs[0]) == len(recs[1]) == 2 * sum(res[1].history["k"]),
          "small mc int8: exchange counts differ")
    hist_epochs, flip = first_flip(np, recs, res)
    for name in ("loss", "gap", "sigma", "gamma"):
        got = np.array(res[0].history[name][:hist_epochs])
        want = np.array(res[1].history[name][:hist_epochs])
        if want.size:
            err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max()))
            check(err <= 1e-4, f"small mc int8 {name}: card vs CPU rel err {err:.2e}")
    print(f"small mc fit (int8): card matches CPU (rtol 1e-4 over {hist_epochs} epochs, "
          f"{'no' if flip is None else 'one'} grid-step flip)")


def first_flip(np, recs, res):
    """(epochs to compare, index of the first exchange whose integers differ
    between the card run and the CPU run, or None). At that exchange every
    moved integer must differ by one grid step, with the two runs' pre-floor
    values straddling an integer and within 1e-3 of each other; the final
    losses must then agree to 1e-2."""
    flip = next((j for j, (a, b) in enumerate(zip(recs[0], recs[1]))
                 if not np.array_equal(a[1], b[1])), None)
    if flip is None:
        return len(res[1].history["loss"]), None
    (pre_a, q_a), (pre_b, q_b) = recs[0][flip], recs[1][flip]
    moved = q_a != q_b
    check(np.max(np.abs(q_a.astype(int) - q_b.astype(int))) <= 1,
          f"small mc int8: exchange {flip} differs by more than one grid step")
    gap = float(np.max(np.abs(pre_a - pre_b)))
    check(gap <= 1e-3, f"small mc int8: pre-floor values differ by {gap:.2e}")
    check(np.all(np.floor(pre_a[moved]) != np.floor(pre_b[moved])),
          "small mc int8: a grid step moved without its values straddling an integer")
    ends = np.cumsum([2 * k for k in res[1].history["k"]])
    epoch = int(np.searchsorted(ends, flip, side="right"))
    rel = abs(res[0].final_loss - res[1].final_loss) / abs(res[1].final_loss)
    check(rel <= 1e-2, f"small mc int8: final loss differs by {rel:.2e} after a flip")
    print(f"small mc int8: exchange {flip} (epoch {epoch}) moved {int(moved.sum())} value(s) "
          f"by one grid step (pre-floor values straddle an integer, |diff| <= {gap:.1e}); "
          f"final loss within {rel:.1e}")
    return epoch, flip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=PAPER_N, help="n (depth cut only)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--logistic-epochs", type=int, default=10)
    ap.add_argument("--mc-entries", type=int, default=NF_P,
                    help="training ratings (depth cut only; d, m and the held-out set stay; "
                    "the held-out RMSE check needs the full count)")
    ap.add_argument("--mc-epochs", type=int, default=30)
    ap.add_argument("--mc-int8-epochs", type=int, default=10)
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

    from repro_torch import NoiseStream, V0Stream, comm, kernels, resolve_device
    from repro_torch.core import frank_wolfe, low_rank, tasks
    from repro_torch.kernels import _build
    from repro_torch.kernels import mc_matvec as mc
    from repro_torch.kernels import power_matvec as pm
    from repro_torch.kernels import quantize as qz
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
        for src_name in ("power_matvec", "rank1_update", "mc_matvec", "quantize"):
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
            torch, kernels, dfw, "mtls", tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M), X, Y,
            cfg, args.seed, dev)
        loss = res.history["loss"] + [res.final_loss]
        check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])),
              "mtls: loss increased")
        check(res.final_loss < loss[0], "mtls: final loss not below the initial loss")
        if args.profile:
            del res
            report["mtls_profile"] = profile_fit(torch, "mtls", lambda: dfw.fit_serial(
                tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M), X, Y, cfg=dfw.DFWConfig(
                    mu=1.0, num_epochs=3, schedule="const:3", step_size="linesearch",
                    verify_kernels=False), key=args.seed, device=dev))
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
            torch, kernels, dfw, "logistic", tasks.MultinomialLogistic(PAPER_D, PAPER_M), X,
            labels, cfg, args.seed, dev)
        bound = n * math.log(PAPER_M)
        check(res.final_loss < bound, f"logistic: final loss {res.final_loss} >= n ln m {bound}")
        print(f"logistic final loss {res.final_loss:.6g} < n ln m = {bound:.6g}")
        if args.profile:
            del res
            report["logistic_profile"] = profile_fit(torch, "logistic", lambda: dfw.fit_serial(
                tasks.MultinomialLogistic(PAPER_D, PAPER_M), X, labels, cfg=dfw.DFWConfig(
                    mu=10.0, num_epochs=3, schedule="const:2", verify_kernels=False),
                key=args.seed, device=dev))
            res = None
        del res, X, labels
        torch.cuda.empty_cache()

        # 5. small fits, card against CPU
        small_parity(torch, np, V0Stream, dfw, tasks, dev)

        # 6. matrix-completion data at the Netflix shapes, made on the card
        t0 = time.perf_counter()
        idx, yw, (te_rows, te_cols, te_vals), mu = make_mc_data(
            torch, gen, dev, args.mc_entries, NF_TEST)
        torch.cuda.synchronize()
        report["mc_data"] = mc_stats(torch, idx, NF_D, NF_M)
        report["mc_data"].update(entries=args.mc_entries, held_out=NF_TEST, mu=mu,
                                 made_s=time.perf_counter() - t0)
        print(f"mc data: d={NF_D} m={NF_M} {args.mc_entries} training + {NF_TEST} held-out "
              f"ratings made in {report['mc_data']['made_s']:.1f} s; {report['mc_data']}")
        mc_task = tasks.MatrixCompletion(NF_D, NF_M)

        # 7. COO matvec and the quantize pair against their plain versions
        t0 = time.perf_counter()
        state = mc_task.init_state(idx, yw)
        torch.cuda.synchronize()
        report["mc_init_state_s"] = time.perf_counter() - t0
        print(f"mc state with its row and column orders built in "
              f"{report['mc_init_state_s']:.2f} s")
        krows += mc_kernel_phase(torch, mc, qz, dev, state, gen, args.reps, peaks)
        del state
        torch.cuda.empty_cache()

        # 8. MC main path, comm dense
        cfg = dfw.DFWConfig(mu=mu, num_epochs=args.mc_epochs, schedule="log",
                            step_size="linesearch")
        res, mc_launch, report["mc"] = run_path(
            torch, kernels, dfw, "mc", mc_task, idx, yw, cfg, args.seed, dev)
        loss = res.history["loss"] + [res.final_loss]
        check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])), "mc: loss increased")
        pred = low_rank.gather_entries(res.iterate, te_rows, te_cols)
        rmse = float(torch.sqrt(torch.mean((pred - te_vals) ** 2)))
        rmse0 = float(torch.sqrt(torch.mean(te_vals ** 2)))
        report["mc"].update(heldout_rmse=rmse, heldout_rmse_w0=rmse0,
                            train_rmse=float(mc_task.rmse(res.state)))
        check(math.isfinite(rmse) and rmse < rmse0,
              f"mc: held-out RMSE {rmse:.4f} not below that of W = 0 ({rmse0:.4f})")
        print(f"mc: held-out RMSE {rmse:.4f} (W = 0: {rmse0:.4f}), training RMSE "
              f"{report['mc']['train_rmse']:.4f}")
        del res, pred
        torch.cuda.empty_cache()
        if args.profile:
            ktask = dfw.kernelize(mc_task)
            state = ktask.init_state(idx, yw)
            report["mc_profile"] = profile_fit(torch, "mc", lambda: frank_wolfe.fit(
                ktask, state, mu=mu, num_epochs=3, schedule="const:3",
                step_size="linesearch", key=args.seed, device=dev))
            del state
            torch.cuda.empty_cache()

        # 9. MC main path, comm int8
        cfg = dfw.DFWConfig(mu=mu, num_epochs=args.mc_int8_epochs, schedule="log",
                            step_size="linesearch", comm="int8")
        res, mc8_launch, report["mc_int8"] = run_path(
            torch, kernels, dfw, "mc", mc_task, idx, yw, cfg, args.seed, dev)
        check(res.final_loss < res.history["loss"][0],
              "mc int8: final loss not below the first")
        del res
        torch.cuda.empty_cache()
        if args.profile:
            ktask = dfw.kernelize(mc_task)
            state = ktask.init_state(idx, yw)
            report["mc_int8_profile"] = profile_fit(torch, "mc int8", lambda: frank_wolfe.fit(
                ktask, state, mu=mu, num_epochs=3, schedule="const:3",
                step_size="linesearch", reducer=comm.Int8Reducer(), key=args.seed, device=dev))
            del state
        del idx, yw, te_rows, te_cols, te_vals
        torch.cuda.empty_cache()

        # 10. small MC fits, dense and int8, card against CPU
        mc_small_parity(torch, np, V0Stream, NoiseStream, comm, qz.ref, dfw, frank_wolfe,
                        tasks, dev)
    except Check as e:
        return fail(str(e))

    out = []
    paths = (mtls_launch, log_launch, mc_launch, mc8_launch)
    for kname in TPU_KERNEL:
        rows = [r for r in krows if r["name"] == kname]
        main_row = max(rows, key=lambda r: r["bytes"])
        out.append(dict(
            name=kname, route="cuda", source=SOURCE[kname], replaces=TPU_KERNEL[kname],
            launches=sum(path[kname] for path in paths),
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
