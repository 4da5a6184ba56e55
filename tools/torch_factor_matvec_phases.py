#!/usr/bin/env python3
"""Where the time of the port's ``factor_matvec`` kernel goes, on one GPU.

    python3 tools/torch_factor_matvec_phases.py

Builds an instrumented copy of ``src/repro_torch/csrc/factor_matvec.cu``
(into ``build/kernels/``): ``clock64()`` stamps at the phase boundaries of
every block of the first batch tile, and a switch that skips phases. For the
serving shapes and b = 1024, r = 256 it prints, per shape:

- the device time per launch (torch.profiler, 50 launches) of the kernel in
  full, without stage 1's MMAs, without stage 2's MMAs, and without either
  and without the cluster's exchange (what is left: loads, barriers, the
  launch), beside einsum's and the cuBLAS chain's device time;
- block 0's cycles in each phase of the last rank tile: stage 1 (from the
  kernel's start), the first cluster barrier, the exchange, the second
  barrier, the wait for B, stage 2;
- the card's name, power limit and SM clock.

The instrumented copy is made by editing the source's text; if the kernel's
text has moved on, the script stops and names the line it could not find.
It exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((64, 2048, 64, 1000), (64, 1000, 64, 2048), (1, 2048, 32, 1000),
          (1024, 2048, 256, 1000))
STAMP = ("{ if (dbg && blockIdx.y == 0 && threadIdx.x == 0) "
         "dbg[blockIdx.x * 16 + %d] = clock64(); }")
PHASES = ("stage 1", "barrier 1", "exchange", "barrier 2", "wait B", "stage 2")
# skip bits: 1 stage-1 MMAs, 2 stage-2 MMAs, 4 the exchange
VARIANTS = (("full", 0), ("no stage-1 MMA", 1), ("no stage-2 MMA", 2), ("loads only", 7))


def instrumented(src: str) -> str:
    """The kernel's source with phase stamps and skip switches."""
    edits = [
        ("int vec_out, int bf16) {\n  constexpr int kRows",
         "int vec_out, int bf16, long long* dbg, int skip) {\n  constexpr int kRows"),
        ("  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRows;\n",
         "  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRows;\n  "
         + STAMP % 0 + "\n"),
        ("        if (live) {\n          // 3xTF32",
         "        if (live && !(skip & 1)) {\n          // 3xTF32"),
        ("    // B's tile for this block's first pass",
         "    " + STAMP % 1 + "\n    // B's tile for this block's first pass"),
        ("go to every block of the cluster.\n    cluster.sync();\n",
         "go to every block of the cluster.\n    cluster.sync();\n    " + STAMP % 2 + "\n"),
        ("      if (c >= rt8) continue;", "      if (c >= rt8 || (skip & 4)) continue;"),
        ("*cluster.map_shared_rank(mine, dst) = tv;\n    }\n    cluster.sync();\n",
         "*cluster.map_shared_rank(mine, dst) = tv;\n    }\n    " + STAMP % 3
         + "\n    cluster.sync();\n    " + STAMP % 4 + "\n"),
        ("      cp_async_wait<0>();\n      __syncthreads();\n",
         "      cp_async_wait<0>();\n      __syncthreads();\n      " + STAMP % 5 + "\n"),
        ("      for (int ks = 0; ks < rt8 / 8; ks += 2) {",
         "      for (int ks = 0; ks < ((skip & 2) ? 0 : rt8 / 8); ks += 2) {"),
        ("      write_out<MT>(acc2, out, k0 > 0, row0, bt, n_out, jbeg, jend, ntiles);\n    }\n"
         "  }\n}",
         "      write_out<MT>(acc2, out, k0 > 0, row0, bt, n_out, jbeg, jend, ntiles);\n    }\n"
         "  }\n  " + STAMP % 6 + "\n}"),
        ("int vec_in, int vec_out, int bf16, int device, cudaStream_t stream) {",
         "int vec_in, int vec_out, int bf16, int device, cudaStream_t stream, long long* dbg, "
         "int skip) {"),
        ("out_cols, tma, vec_in, vec_out, bf16));",
         "out_cols, tma, vec_in, vec_out, bf16, dbg, skip));"),
        ("int vec_in, int vec_out, int bf16, int device, void* stream) {",
         "int vec_in, int vec_out, int bf16, int device, void* stream, long long* dbg, "
         "int skip) {"),
    ]
    for old, new in edits:
        if old not in src:
            sys.exit(f"factor_matvec.cu has changed: no line {old.splitlines()[0]!r}")
        src = src.replace(old, new, 1)
    return src.replace("vec_in, vec_out, bf16, device, st); break;",
                       "vec_in, vec_out, bf16, device, st, dbg, skip); break;")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import factor_matvec as fm

    src = _build.BUILD_DIR / "factor_matvec_phases.cu"
    so = src.with_suffix(".so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented((_build.CSRC / "factor_matvec.cu").read_text()))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fm_factor_matvec.argtypes = [P] * 5 + [I64] * 4 + [I, I, I64, I64, I, I, I, I, P, P, I]
    lib.fm_factor_matvec.restype = I
    lib.fm_error_string.argtypes, lib.fm_error_string.restype = [I], ctypes.c_char_p
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())

    def device_us(fn, name, n=50):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA") and name in e.key) / n

    for bt, n_in, r, n_out in SHAPES:
        x = torch.randn(bt, n_in, device=dev, generator=gen) / n_in ** 0.5
        a, s, b = (torch.randn(r, n_in, device=dev, generator=gen),
                   torch.randn(r, device=dev, generator=gen),
                   torch.randn(r, n_out, device=dev, generator=gen))
        out = torch.empty(bt, n_out, device=dev)
        plan = fm.kernel.launch_plan(bt, n_in, r, n_out)
        stamps = torch.zeros(fm.kernel.CLUSTER * 16, dtype=torch.int64, device=dev)

        def call(skip, dbg=None):
            err = lib.fm_factor_matvec(
                x.data_ptr(), a.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), bt, n_in,
                r, n_out, plan.m_tiles, plan.chunks, plan.chunk_width, plan.out_cols, 1, 1, 0,
                dev.index or 0, torch.cuda.current_stream().cuda_stream, dbg, skip)
            if err:
                raise RuntimeError(f"launch failed: {lib.fm_error_string(err)}")

        call(0)
        want = fm.ref.factor_matvec(x, a, s, b)
        err = float((out - want).abs().max() / want.abs().max())
        times = {label: device_us(lambda: call(skip), "factor_matvec_kernel")
                 for label, skip in VARIANTS}
        lib_us = device_us(lambda: torch.einsum("bi,ki,k,kj->bj", x, a, s, b), "")
        chain_us = device_us(lambda: (x @ a.T * s) @ b, "")
        call(0, stamps.data_ptr())
        t = stamps.view(fm.kernel.CLUSTER, 16)[0].tolist()
        print(f"b={bt} {n_in}->{n_out} r={r} (rel err {err:.2e}): device us "
              + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
              + f"; einsum {lib_us:.2f}, chain {chain_us:.2f}")
        print("  block 0 cycles: " + ", ".join(
            f"{name} {t[i + 1] - t[i]}" for i, name in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
