#!/usr/bin/env python3
"""The port's block forms ``matmat`` (A V) and ``rmatmat`` (A^T U) against
cuBLAS (``torch.matmul``, TF32 off) at the block:k solver's shapes, on one
GPU.

    python3 tools/torch_matmat_bench.py [--src OTHER/src ...] [--edit 'OLD=>NEW' ...]
                                        [--k K ...] [--reps R] [--rounds N]

A is R (n x 1000) and X (n x 2048), n = 1,281,167, made on the card; k =
8 and 32 unless given. For each operand, k and form it holds every kernel
to the plain version at 1e-4 of max|plain| and to its own bits on a
second call, then times (CUDA events, the median of --reps calls) each
kernel and the library call in order and then in reverse order (kernel,
call, call, kernel for one kernel), --rounds times, and prints the means:
the kernel of this checkout's ``src`` first, then each --src tree (an
older version, timed in the same run), then each --edit variant (this
checkout's ``csrc/power_matvec.cu`` and its headers with the text OLD
replaced by NEW wherever it occurs, at least once, built beside the
others); then the bound (the bytes of A, V or U and the output over 3.35
TB/s), each kernel's share of it and its ratio to cuBLAS; last the card's
name and power limit. It exits non-zero without CUDA, when a kernel
disagrees or repeats other bits, or when an edit does not apply.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from torch_matvec_sweep import load_ops, time_ms  # noqa: E402

BYTES_PER_S = 3.35e12
ROWS = 1_281_167  # ImageNet's n, R's and X's rows


def build_variant(_build, index: int, old: str, new: str) -> Path:
    """This checkout's power_matvec.cu and its headers, with ``old``
    replaced by ``new`` in every file that holds it (at least one), compiled
    with the port's flags into build/kernels/variant<index>."""
    out = _build.BUILD_DIR / f"variant{index}"
    out.mkdir(parents=True, exist_ok=True)
    edited = 0
    for path in [_build.CSRC / "power_matvec.cu", *sorted(_build.CSRC.glob("*.cuh"))]:
        text = path.read_text()
        edited += old in text
        (out / path.name).write_text(text.replace(old, new))
    if not edited:
        raise SystemExit(f"torch_matmat_bench: no {old!r} in power_matvec.cu or its headers")
    so = out / "power_matvec.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out / "power_matvec.cu")], check=True, capture_output=True)
    return so


def bind(kernel, so: Path):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in kernel._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.pm_error_string.argtypes = [ctypes.c_int]
    lib.pm_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="another checkout's src directory whose block forms are timed too")
    ap.add_argument("--edit", action="append", default=[],
                    help="a variant of this checkout's power_matvec.cu: 'OLD=>NEW'")
    ap.add_argument("--k", type=int, action="append", help="block widths (default 8 and 32)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time each operand this many times over (a line each)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_matmat_bench: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = [ROOT / "src"] + [Path(s).resolve() for s in args.src]
    ops = [load_ops(t) for t in trees]
    for op in ops:
        op.kernel._build.build_all()
    # each kernel: (label, ops module, the library its kernel module binds)
    kernels = [(str(t), op, op.kernel._library()) for t, op in zip(trees, ops)]
    for i, edit in enumerate(args.edit):
        old, new = edit.split("=>", 1)
        so = build_variant(ops[0].kernel._build, i, old, new)
        kernels.append((f"edit {edit!r}", ops[0], bind(ops[0].kernel, so)))

    def call(op, lib, form, a, b):
        op.kernel._lib = lib
        return getattr(op, form)(a, b)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print("operand, k, form, " + ", ".join(f"ms ({label})" for label, _, _ in kernels)
          + ", cuBLAS ms, bound ms, share of the bound, kernel / cuBLAS")
    for label, m in (("R", 1000), ("X", 2048)):
        a = torch.randn(ROWS, m, generator=gen, device=dev)
        n = a.shape[0]
        for k in args.k or (8, 32):
            v = torch.randn(m, k, generator=gen, device=dev)
            u = torch.randn(n, k, generator=gen, device=dev)
            for form, b, lib_fn in (("matmat", v, lambda: torch.matmul(a, v)),
                                    ("rmatmat", u, lambda: torch.matmul(a.T, u))):
                want = lib_fn()
                scale = float(want.abs().max())
                for name, op, lib in kernels:
                    got = call(op, lib, form, a, b)
                    err = float((got - want).abs().max()) / scale
                    if not err <= 1e-4 or not torch.equal(call(op, lib, form, a, b), got):
                        print(f"torch_matmat_bench: {form} {label} k={k} ({name}): error "
                              f"{err:.3e} or other bits on repeat", file=sys.stderr)
                        return 1
                    del got
                fns = [lambda op=op, lib=lib: call(op, lib, form, a, b)
                       for _, op, lib in kernels] + [lib_fn]
                for _ in range(args.rounds):
                    first = [time_ms(torch, f, args.reps) for f in fns]
                    second = [time_ms(torch, f, args.reps) for f in reversed(fns)][::-1]
                    *ms, lib_ms = [(x + y) / 2 for x, y in zip(first, second)]
                    bound = 1e3 * 4 * (n * m + (n + m) * k) / BYTES_PER_S
                    print(f"{label}, {k}, {form}, " + ", ".join(f"{t:.4f}" for t in ms)
                          + f", {lib_ms:.4f}, {bound:.4f}, "
                          + ", ".join(f"{bound / t:.3f}" for t in ms) + ", "
                          + ", ".join(f"{t / lib_ms:.4f}" for t in ms), flush=True)
                del want
            del v, u
        del a
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
