#!/usr/bin/env python3
"""The port's matrix-completion block forms, ``coo_matmat`` (G V in the row
order, G^T U in the column order), the block ``update_resid`` (three orders)
and ``update_resid_caller`` (the caller order alone), at the Netflix shapes
against an older tree's, text-edit variants and cuSPARSE, in turns, on one
GPU.

    python3 tools/torch_mc_block_bench.py [--src OTHER/src ...] [--edit 'OLD=>NEW' ...]
                                          [--unchecked-edit 'OLD=>NEW' ...] [--k K ...]
                                          [--reps R] [--rounds N] [--seed S]

Prints the card's name and power limit first. Makes ``chip_smoke.py``'s
matrix-completion ratings on the card from --seed (480,189 x 17,770,
100,480,507 ratings) and their state (this checkout's ``tasks.mc_state``),
then for k = 8 and 32 (or those given) and each kernel holds every version to
this checkout's result (``coo_matmat``: the bits of
``ref.coo_matmat_chain``'s association, 1e-4 of max|plain| from cuSPARSE;
the update: the plain chain's bits) and to its own bits on a second call, and
times (CUDA events, the median of --reps calls) every version and cuSPARSE's
CSR SpMM (``coo_matmat`` only; its CSR tensor is set-up) in order and then in
reverse order, --rounds times: this checkout's kernel first, then each --src
tree (an older version of the port, timed in the same run), then each --edit
variant (this checkout's ``csrc/mc_matvec.cu`` with the text OLD replaced by
NEW wherever it occurs, at least once), then each --unchecked-edit variant
(the same, but not held to the bits: a part of the kernel left out, to time
the rest). Each line gives the means, the bound
(bytes over 3.35 TB/s), the gather floor (``tools/torch_gather_probe.py``'s
rates measured in this run: the random sectors added to the sequential
bytes) and each version's share of both. It exits non-zero without CUDA,
when a version disagrees or repeats other bits, or when an edit does not
apply.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
from torch_gather_probe import floor_ms, measure  # noqa: E402
from torch_matvec_sweep import time_ms  # noqa: E402

BYTES_PER_S = 3.35e12


def load_mc(src: Path):
    """``repro_torch.kernels.mc_matvec.ops`` of the tree ``src``, loaded beside
    the trees imported before (their modules live on through the returned
    objects)."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(src))
    try:
        return importlib.import_module("repro_torch.kernels.mc_matvec.ops")
    finally:
        sys.path.remove(str(src))


def build_variant(ops, index: int, old: str, new: str) -> ctypes.CDLL:
    """This checkout's mc_matvec.cu with ``old`` replaced by ``new``, compiled
    with the port's flags and bound as ``kernel._library`` binds its own."""
    _build = ops.kernel._build
    text = (_build.CSRC / "mc_matvec.cu").read_text()
    if old not in text:
        raise SystemExit(f"torch_mc_block_bench: no {old!r} in mc_matvec.cu")
    out = _build.BUILD_DIR / f"mc_variant{index}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mc_matvec.cu").write_text(text.replace(old, new))
    so = out / "mc_matvec.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(so), str(out / "mc_matvec.cu")], check=True, capture_output=True)
    own, real = ops.kernel._lib, _build.library
    try:
        ops.kernel._lib = None
        _build.library = lambda name: ctypes.CDLL(str(so))
        return ops.kernel._library()
    finally:
        ops.kernel._lib, _build.library = own, real


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="another checkout's src directory whose kernels are timed too")
    ap.add_argument("--edit", action="append", default=[],
                    help="a variant of this checkout's mc_matvec.cu: 'OLD=>NEW'")
    ap.add_argument("--unchecked-edit", action="append", default=[],
                    help="a variant timed but not held to the bits (a part left out, to see "
                         "what it costs): 'OLD=>NEW'")
    ap.add_argument("--k", type=int, action="append", help="block widths (default 8 and 32)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_mc_block_bench: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    import chip_smoke as cs
    trees = [ROOT / "src"] + [Path(s).resolve() for s in args.src]
    opss = [load_mc(trees[0])]
    tasks = importlib.import_module("repro_torch.core.tasks")  # this checkout's
    opss += [load_mc(t) for t in trees[1:]]
    for ops in opss:
        ops.kernel._build.build_all()
    mine = opss[0]
    # each version: (label, ops module, the library its kernel module binds)
    versions = [(str(t), ops, ops.kernel._library()) for t, ops in zip(trees, opss)]
    unchecked = set()
    for i, edit in enumerate(args.edit + args.unchecked_edit):
        old, new = edit.split("=>", 1)
        label = f"{'unchecked ' if i >= len(args.edit) else ''}edit {edit!r}"
        if i >= len(args.edit):
            unchecked.add(label)
        versions.append((label, mine, build_variant(mine, i, old, new)))
    ref = mine.ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    idx, yw, _, mu = cs.make_mc_data(torch, gen, dev, cs.NF_P, 1, d=cs.NF_D, m=cs.NF_M)
    state = tasks.MatrixCompletion(cs.NF_D, cs.NF_M).init_state(idx, yw)
    del idx, yw
    p = state.rows.numel()
    rates = measure(torch, dev)

    def call(ops, lib, fn, *a):
        ops.kernel._lib = lib
        return getattr(ops, fn)(*a)

    print("kernel, operand, k, " + ", ".join(f"ms ({label})" for label, _, _ in versions)
          + ", library ms, bound ms, gather floor ms, share of the bound, share of the floor",
          flush=True)
    for k in args.k or (8, 32):
        V = torch.randn(cs.NF_M, k, generator=gen, device=dev)
        U = torch.randn(cs.NF_D, k, generator=gen, device=dev) / math.sqrt(cs.NF_D)
        cases = []  # (kernel, operand, args, want, exact, library fn, bytes, sectors)
        for label, order, vals, x, table in (
                ("G V", state.by_row, state.resid_by_row, V, "V"),
                ("G^T U", state.by_col, state.resid_by_col, U, "U")):
            csr = torch.sparse_csr_tensor(order.seg_ptr.to(torch.int32), order.gat_sorted,
                                          vals, size=(order.out_dim, order.in_dim))
            sectors = {table: p * max(1, 4 * k // 32)}
            cases.append(("coo_matmat", label, (order, vals, x),
                          ref.coo_matmat_chain(order, vals, x), True,
                          lambda csr=csr, x=x: csr @ x,
                          8 * p + 4 * k * (order.in_dim + order.out_dim), sectors))
        gamma = torch.full((), 0.05, device=dev)
        full = (gamma, mu, U, V, state.rows, state.cols, state.resid, state.vals, state.weight,
                state.by_row, state.copies("row"), state.by_col, state.copies("col"))
        rows_of = max(1, 4 * k // 32)
        cases.append(("update_resid", "three orders", full, ref.update_resid(*full), True, None,
                      64 * p + 4 * k * (cs.NF_D + cs.NF_M), {"U": 2 * p * rows_of,
                                                             "V": 2 * p * rows_of}))
        cases.append(("update_resid_caller", "caller order", full[:9],
                      ref.update_resid_caller(*full[:9]), True, None,
                      24 * p + 4 * k * (cs.NF_D + cs.NF_M), {"U": p * rows_of,
                                                             "V": p * rows_of}))
        for name, label, a, want, exact, lib_fn, nbytes, sectors in cases:
            for vlabel, ops, lib in versions:
                got = call(ops, lib, name, *a)
                again = call(ops, lib, name, *a)
                pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
                same = (all(torch.equal(x_, y_) for x_, y_ in zip(got, again))
                        if isinstance(got, tuple) else torch.equal(got, again))
                if vlabel not in unchecked and not (
                        all(torch.equal(x_, y_) for x_, y_ in pairs) and same):
                    print(f"torch_mc_block_bench: {name} {label} k={k} ({vlabel}): not the "
                          "plain chain's bits, or other bits on repeat", file=sys.stderr)
                    return 1
                del got, again
            if lib_fn is not None:
                lib_out = lib_fn()
                scale = float(want.abs().max())
                err = float((lib_out - want).abs().max()) / scale
                if not err <= 1e-4:
                    print(f"torch_mc_block_bench: cuSPARSE {label} k={k}: {err:.3e}",
                          file=sys.stderr)
                    return 1
                del lib_out
            fns = [lambda ops=ops, lib=lib: call(ops, lib, name, *a)
                   for _, ops, lib in versions] + ([lib_fn] if lib_fn is not None else [])
            bound = 1e3 * nbytes / BYTES_PER_S
            floor = floor_ms(rates, 8 if k <= 8 else 32, sectors, nbytes, BYTES_PER_S)
            for _ in range(args.rounds):
                first = [time_ms(torch, f, args.reps) for f in fns]
                second = [time_ms(torch, f, args.reps) for f in reversed(fns)][::-1]
                ms = [(x_ + y_) / 2 for x_, y_ in zip(first, second)]
                lib_ms = ms.pop() if lib_fn is not None else None
                print(f"{name}, {label}, {k}, " + ", ".join(f"{t:.4f}" for t in ms)
                      + f", {'none' if lib_ms is None else f'{lib_ms:.4f}'}, {bound:.4f}, "
                      f"{floor:.4f}, " + ", ".join(f"{bound / t:.3f}" for t in ms) + ", "
                      + ", ".join(f"{floor / t:.3f}" for t in ms), flush=True)
        del V, U, cases, full
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
