#!/usr/bin/env python3
"""Where the time of the port's ``wkv6_chunk`` kernel goes, on one GPU.

    python3 tools/torch_wkv6_phases.py

Builds an instrumented copy of ``src/repro_torch/csrc/wkv6_chunk.cu`` (into
``build/kernels/``): ``clock64()`` stamps, taken by lane 0 of every warp of
block 0 at the kernel's start, after the cw_last pass, and in every tile
after the loads, after the bonus and segment totals, after the prefix sum
and the forming of R~, K~ and K^, when the warp's products are done and
after the tile's last barrier; and a switch that skips the tensor-core products of warps 0-3 (y),
of warps 4-7 (the state), or both. At the main path's shape (B 4, H 64,
q 256, 64; bf16 r/k/v, f32 logw, the model's decay law) it prints:

- the device time per launch (CUDA events over 50 launches) of the kernel
  in full, without the y products, without the state products and without
  either (what is left: loads, prefix sums, exps, barriers, stores);
- block 0's cycles in each phase, per tile: loads, the bonus and segment
  totals, the prefix sum and forming, products (the slowest warp's; and
  when each warp's products ended, to show the balance), the tile's last
  barrier;
- the card's name, power limit and SM clock.

The instrumented copy is made by editing the source's text; if the kernel's
text has moved on, the script stops and names the line it could not find.
It exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, Q, D = 4, 64, 256, 64
SLOTS = 64  # stamps per warp
STAMP = ("{ if (dbg && blockIdx.x == 0 && threadIdx.x %% 32 == 0) "
         "dbg[(threadIdx.x / 32) * " + str(SLOTS) + " + (%s)] = clock64(); }")
# skip bits: 1 the y warps' products, 2 the state warps' products
VARIANTS = (("full", 0), ("no y products", 1), ("no state products", 2), ("neither", 3))

ENTRY = r'''
extern "C" int wkv6_phases(const void* r, const void* k, const void* v, const void* lw,
                           const float* u, const float* s0, float* y, float* s_out, int b,
                           int h, int q, long long* dbg, int skip, void* stream) {
  const int64_t tok = 64, head = static_cast<int64_t>(q) * 64, bat = head * h;
  const Strides st = {{bat, head, tok}, {bat, head, tok}, {bat, head, tok}, {bat, head, tok},
                      {bat, head, tok}};
  auto kern = wkv6_chunk_kernel<__nv_bfloat16, float>;
  constexpr int kBytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<b * h, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(lw), u, s0, y, s_out, st,
      h, q, 64, 64, true, dbg, skip);
  return static_cast<int>(cudaGetLastError());
}
'''


def instrumented(src: str) -> str:
    """The kernel's source with phase stamps, skip switches and an entry."""
    edits = [
        ("int dk, int dv,\n                  bool vec) {\n",
         "int dk, int dv,\n                  bool vec, long long* dbg, int skip) {\n"),
        ("      static_cast<const TW*>(lw), u, s0, y, s_out, st, h, q, dk, dv, vec);\n",
         "      static_cast<const TW*>(lw), u, s0, y, s_out, st, h, q, dk, dv, vec, nullptr, 0);\n"),
        ("  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);\n",
         "  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);\n  " + STAMP % "0" + "\n"),
        ("  __syncthreads();\n\n  double carry",
         "  __syncthreads();\n  " + STAMP % "1" + "\n\n  double carry"),
        ("    __syncthreads();\n    // ---- the bonus's",
         "    __syncthreads();\n    " + STAMP % "2 + 5 * j" + "\n    // ---- the bonus's"),
        ("    __syncthreads();\n    // ---- cw of the thread's rows",
         "    __syncthreads();\n    " + STAMP % "3 + 5 * j" + "\n    // ---- cw of the thread's rows"),
        ("    __syncthreads();\n\n    if (warp < 4) {",
         "    __syncthreads();\n    " + STAMP % "4 + 5 * j" + "\n\n    if (warp < 4) {"),
        ("    }\n    __syncthreads();\n  }\n\n  if (warp >= 4) {",
         "    }\n    " + STAMP % "5 + 5 * j" + "\n    __syncthreads();\n    "
         + STAMP % "6 + 5 * j" + "\n  }\n\n  if (warp >= 4) {"),
        ("              mma3<false>(sc[i]", "              if (!(skip & 1)) mma3<false>(sc[i]"),
        ("              mma3<kExactV>(dacc[nt]", "              if (!(skip & 1)) mma3<kExactV>(dacc[nt]"),
        ("          mma3<false>(yacc[nt]", "          if (!(skip & 1)) mma3<false>(yacc[nt]"),
        ("      state_product<kExactV>(sm.kh,", "      if (!(skip & 2)) state_product<kExactV>(sm.kh,"),
        ("      if (!last_tile) state_product<kExactV>(sm.k,",
         "      if (!last_tile && !(skip & 2)) state_product<kExactV>(sm.k,"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            sys.exit(f"torch_wkv6_phases: the kernel's text has moved on; cannot find {old!r}")
        src = src.replace(old, new)
    return src + ENTRY


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_phases: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "wkv6_phases.cu"
    cu.write_text(instrumented((_build.CSRC / "wkv6_chunk.cu").read_text()))
    so = out_dir / "wkv6_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.wkv6_phases.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.wkv6_phases.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    r, k = (randn(B, H, Q, D) * 0.5).bfloat16(), (randn(B, H, Q, D) * 0.5).bfloat16()
    v = randn(B, H, Q, D).bfloat16()
    lw = -torch.exp(randn(B, H, Q, D) * 0.6 - 1.0)
    u, s0 = randn(H, D) * 0.5, randn(B, H, D, D) * 0.3
    y, s_out = torch.empty(B, H, Q, D, device=dev), torch.empty(B, H, D, D, device=dev)
    dbg = torch.zeros(8 * SLOTS, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(skip, stamps=None):
        err = lib.wkv6_phases(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                              u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, H,
                              Q, 0 if stamps is None else stamps.data_ptr(), skip, stream)
        if err:
            raise RuntimeError(f"wkv6_phases launch failed ({err})")

    for label, skip in VARIANTS:
        for _ in range(3):
            launch(skip)
        torch.cuda.synchronize()
        times = []
        for _ in range(50):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            launch(skip)
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        ms = statistics.median(a.elapsed_time(b) for a, b in times)
        launch(skip, dbg)
        torch.cuda.synchronize()
        st = dbg.view(8, SLOTS).cpu().tolist()
        w0 = st[0]
        tiles = []
        for j in range(Q // 64):
            base = 5 * j
            prev = w0[1] if j == 0 else w0[base + 1]
            start = w0[base + 4]
            ends = [st[w][base + 5] - start for w in range(8)]
            tiles.append(dict(loads=w0[base + 2] - prev, totals=w0[base + 3] - w0[base + 2],
                              prefix=start - w0[base + 3], products=max(ends),
                              barrier=w0[base + 6] - start - max(ends), ends=ends))
        print(f"{label}: {ms:.4f} ms a launch; block 0: start to cw_last {w0[1] - w0[0]} "
              f"cycles, then per tile")
        for j, t in enumerate(tiles):
            print(f"  tile {j}: loads {t['loads']}, totals {t['totals']}, prefix and forming "
                  f"{t['prefix']}, products {t['products']} (per warp {t['ends']}), last "
                  f"barrier {t['barrier']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
