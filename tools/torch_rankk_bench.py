#!/usr/bin/env python3
"""The port's rank-k updates, ``rankk_update`` (Z' = a Z + b P Q^T) and
``rankk_update_axpy`` (+ c Y0), against older trees, text-edit variants and
``addmm`` (+ ``add_``), in turns, on one GPU; the rank-1 forms beside them.

    python3 tools/torch_rankk_bench.py [--src OTHER/src ...] [--edit 'OLD=>NEW' ...]
                                       [--unchecked-edit 'OLD=>NEW' ...] [--k K ...]
                                       [--reps R] [--rounds N]

Prints the card's name and power limit first. Z and Y0 are 1,281,167 x 1000
f32 (the MTLS residual and targets, the logistic logits), P (n, k) and Q
(m, k), made on the card; k = 1, 8 and 32 unless given (k = 1: the rank-1
forms, x (n,) y (m,)^T, against ``addr`` (+ ``add_``)). For each k and form,
out of place (``out=`` a separate buffer) and in place (``out=`` Z itself,
as the fits call it), it holds this checkout's kernel to the plain version
at 1e-5 of max|plain|, and every version to this checkout's bits
(``torch.equal``), in place to the out-of-place bits, and each to its own
bits on a second call. The versions: this checkout's, each --src tree (an
older version of the port), each --edit variant (this checkout's
``csrc/rank1_update.cu`` with the text OLD replaced by NEW wherever it
occurs, at least once; several pairs joined by ' ;; ' make one variant) and
each --unchecked-edit variant (the same, but not held to the bits: a part
left out, to see what it costs). Then it times (CUDA events, the median of
--reps calls) every version and the library call in order and then in
reverse order (kernel, call, call, kernel for one version), --rounds times,
and prints the means, the bound (each input byte read once and the output
written once, over 3.35 TB/s), each version's share of the bound and its
ratio to the library call. ptxas's registers and spills of each variant's
rank-k kernels are printed as it is built. It exits non-zero without CUDA,
when a version disagrees or repeats other bits, or when an edit does not
apply.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from torch_matvec_sweep import time_ms  # noqa: E402

BYTES_PER_S = 3.35e12
ROWS, COLS = 1_281_167, 1000  # ImageNet's n and m: R, Y and the logits
A, B, C = 0.7, -0.45, -0.3


def load_r1(src: Path):
    """``repro_torch.kernels.rank1_update.ops`` of the tree ``src``, loaded
    beside the trees imported before (their modules live on through the
    returned objects)."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(src))
    try:
        return importlib.import_module("repro_torch.kernels.rank1_update.ops")
    finally:
        sys.path.remove(str(src))


def registers(log: str) -> str:
    """ptxas's registers and spills of each rankk_kernel instantiation."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "rankk_kernel" in entry and ("registers" in line or "spill" in line):
            out.append(f"  {entry[-40:]}: {line.split('info    :')[-1].strip()}")
    return "\n".join(out)


def build_variant(ops, index: int, edit: str) -> ctypes.CDLL:
    """This checkout's rank1_update.cu with each 'OLD=>NEW' of ``edit`` (several
    joined by ' ;; ') applied, compiled with the port's flags and bound as
    ``kernel._library`` binds its own."""
    _build = ops.kernel._build
    text = (_build.CSRC / "rank1_update.cu").read_text()
    for pair in edit.split(" ;; "):
        old, new = pair.split("=>", 1)
        if old not in text:
            raise SystemExit(f"torch_rankk_bench: no {old!r} in rank1_update.cu")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / f"r1_variant{index}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rank1_update.cu").write_text(text)
    so = out / "rank1_update.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(so), str(out / "rank1_update.cu")],
                          capture_output=True, text=True, check=True)
    print(f"variant {index} ({edit!r}):\n{registers(done.stdout + done.stderr)}", flush=True)
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
                    help="a variant of this checkout's rank1_update.cu: 'OLD=>NEW[ ;; ...]'")
    ap.add_argument("--unchecked-edit", action="append", default=[],
                    help="a variant timed but not held to the bits: 'OLD=>NEW'")
    ap.add_argument("--k", type=int, action="append",
                    help="block widths (default 1, the rank-1 forms, 8 and 32)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_rankk_bench: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = [ROOT / "src"] + [Path(s).resolve() for s in args.src]
    opss = [load_r1(t) for t in trees]
    for ops in opss:
        ops.kernel._build.build_all()
    mine = opss[0]
    print(f"this checkout:\n{registers(mine.kernel._build.build_log('rank1_update'))}",
          flush=True)
    # each version: (label, ops module, the library its kernel module binds)
    versions = [(str(t), ops, ops.kernel._library()) for t, ops in zip(trees, opss)]
    unchecked = set()
    for i, edit in enumerate(args.edit + args.unchecked_edit):
        label = f"{'unchecked ' if i >= len(args.edit) else ''}edit {edit!r}"
        if i >= len(args.edit):
            unchecked.add(label)
        versions.append((label, mine, build_variant(mine, i, edit)))

    def call(ops, lib, fn, *a, **kw):
        ops.kernel._lib = lib
        return getattr(ops, fn)(*a, **kw)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    Z = torch.randn(ROWS, COLS, generator=gen, device=dev)
    Y0 = torch.randn(ROWS, COLS, generator=gen, device=dev)
    out, W = torch.empty_like(Z), torch.empty_like(Z)
    a, b, c = (torch.full((), v, device=dev) for v in (A, B, C))
    nm = ROWS * COLS
    print("form, k, call, " + ", ".join(f"ms ({label})" for label, _, _ in versions)
          + ", library ms, bound ms, share of the bound, version / library", flush=True)
    for k in args.k or (1, 8, 32):
        P = torch.randn(*((ROWS,) if k == 1 else (ROWS, k)), generator=gen, device=dev)
        Q = torch.randn(*((COLS,) if k == 1 else (COLS, k)), generator=gen, device=dev)

        def library(src, dst, axpy):
            """addr or addmm (+ add_), written into dst (dst may be src)."""
            if k == 1:
                r = (dst.addr_(P, Q, beta=A, alpha=B) if dst is src
                     else torch.addr(src, P, Q, beta=A, alpha=B, out=dst))
            else:
                r = (dst.addmm_(P, Q.T, beta=A, alpha=B) if dst is src
                     else torch.addmm(src, P, Q.T, beta=A, alpha=B, out=dst))
            return r.add_(Y0, alpha=C) if axpy else r

        for form in ("rank1_update", "rank1_update_axpy") if k == 1 else (
                "rankk_update", "rankk_update_axpy"):
            extra = (Y0,) if form.endswith("axpy") else ()
            scal = (a, b, c) if extra else (a, b)
            plain = getattr(mine.ref, form)(Z, *extra, P, Q, torch.stack(scal))
            want = call(mine, versions[0][2], form, Z, *extra, P, Q, *scal, out=out).clone()
            err = float((want - plain).abs().max()) / float(plain.abs().max())
            del plain
            if not err <= 1e-5:
                print(f"torch_rankk_bench: {form} k={k}: {err:.3e} from the plain version",
                      file=sys.stderr)
                return 1
            for vlabel, ops, lib in versions:
                same = torch.equal(call(ops, lib, form, Z, *extra, P, Q, *scal, out=out), want)
                same &= torch.equal(call(ops, lib, form, Z, *extra, P, Q, *scal, out=out), want)
                for _ in range(2):
                    W.copy_(Z)
                    same &= call(ops, lib, form, W, *extra, P, Q, *scal, out=W) is W
                    same &= torch.equal(W, want)
                if vlabel not in unchecked and not same:
                    print(f"torch_rankk_bench: {form} k={k} ({vlabel}): not this checkout's "
                          "bits, in place or out, or other bits on repeat", file=sys.stderr)
                    return 1
            del want
            nbytes = (12 if extra else 8) * nm + 4 * (ROWS + COLS) * k
            bound = 1e3 * nbytes / BYTES_PER_S
            # in place the values drift from call to call (a = 0.7 keeps them finite)
            for where, src, dst in (("out of place", Z, out), ("in place", W, W)):
                W.copy_(Z)
                fns = [lambda ops=ops, lib=lib: call(ops, lib, form, src, *extra, P, Q, *scal,
                                                     out=dst)
                       for _, ops, lib in versions]
                fns.append(lambda: library(src, dst, bool(extra)))
                for _ in range(args.rounds):
                    first = [time_ms(torch, f, args.reps) for f in fns]
                    second = [time_ms(torch, f, args.reps) for f in reversed(fns)][::-1]
                    *ms, lib_ms = [(x + y) / 2 for x, y in zip(first, second)]
                    print(f"{form}, {k}, {where}, " + ", ".join(f"{t:.4f}" for t in ms)
                          + f", {lib_ms:.4f}, {bound:.4f}, "
                          + ", ".join(f"{bound / t:.3f}" for t in ms) + ", "
                          + ", ".join(f"{t / lib_ms:.4f}" for t in ms), flush=True)
        del P, Q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
