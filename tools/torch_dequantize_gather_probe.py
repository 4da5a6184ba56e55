#!/usr/bin/env python3
"""Two probes of the port's small and random-access kernels on one GPU:
``quantize`` and ``dequantize`` variants at the int8 reducer's shapes, and
the MC state's gathers under each L2 fetch granularity.

    python3 tools/torch_dequantize_gather_probe.py [--src OLD/src] [--entries P] [--no-gather]
        [--budget B] [--out PATH]

(1) ``quantize`` and ``dequantize`` (``csrc/quantize.cu``) at n = 480,189
(u) and 17,770 (v), budget --budget (default 127): this checkout's kernels,
copies of its source whose vector path takes a fixed width at every n
(quantize: 1, 4 or 8 elements a thread, the text of ``kQuantVec`` and
``kQuantVecMinElements``; dequantize: 16, 8 or 4 int8 a thread, the text of
``kDequantVec`` and ``kVecMinElements``), and --src's kernels (an older
tree), each built with the port's nvcc flags into ``build/probe/`` and held
to the plain version bit for bit. Device time per launch from
torch.profiler over --launches back-to-back launches, each variant profiled
twice (the variants in order, then in reverse order), the mean.

(2) The one-field gather (``gather_sorted``) and the record gather of four
fields (``gather_sorted_fields``) over a row order of --entries entries at
the Netflix shapes (rows and columns uniform), timed with CUDA events (the
median of --reps) under the L2 fetch granularity the context starts with
and under 32, 64 and 128 bytes (``cudaDeviceSetLimit(
cudaLimitMaxL2FetchGranularity)``; "not measured" if the CUDA runtime
library cannot be opened), every copy held to field[perm].

Prints the card's name and power limit, and writes every number to --out as
JSON. It exits non-zero without CUDA or if a result differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
PROBE_DIR = ROOT / "build" / "probe"
L2_FETCH_LIMIT = 0x05  # cudaLimitMaxL2FetchGranularity


def _edit(text: str, edits) -> str:
    for pattern, value in edits:
        text, count = re.subn(pattern, value, text)
        if count != 1:
            raise SystemExit(f"the source no longer has {pattern!r}")
    return text


def variants(src_text: str, old_src: Path | None) -> dict:
    """name -> source text of each variant: this tree's, quantize's vector
    path at 1 (the scalar path at every n), 4 and 8 elements a thread at
    every n, dequantize's at 16, 8 and 4 at every n, and the older tree's."""
    out = {"this tree": src_text}
    for vec in (1, 4, 8):
        edits = ((r"constexpr int kQuantVec = \d+;", f"constexpr int kQuantVec = {max(vec, 4)};"),
                 (r"constexpr int64_t kQuantVecMinElements = [^;]+;",
                  "constexpr int64_t kQuantVecMinElements = "
                  f"{'int64_t(1) << 62' if vec == 1 else '0'};"))
        out[f"quantize: {vec} a thread at every n"] = _edit(src_text, edits)
    for vec in (16, 8, 4):
        edits = ((r"constexpr int kDequantVec = \d+;", f"constexpr int kDequantVec = {vec};"),
                 (r"constexpr int64_t kVecMinElements = [^;]+;",
                  "constexpr int64_t kVecMinElements = 0;"))
        out[f"dequantize: {vec} a thread at every n"] = _edit(src_text, edits)
    if old_src is not None:
        out["older tree"] = (old_src / "repro_torch" / "csrc" / "quantize.cu").read_text()
    return out


def build(sources: dict) -> dict:
    """Compile each source (in parallel) -> name -> loaded library."""
    from repro_torch.kernels import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = PROBE_DIR / f"dequant{i}.cu", PROBE_DIR / f"dequant{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.qz_dequantize_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                                                   ctypes.c_int, ctypes.c_void_p]
        lib.qz_dequantize_f32.restype = ctypes.c_int
        lib.qz_quantize_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                                                 ctypes.c_int, ctypes.c_void_p]
        lib.qz_quantize_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_us(torch, fn, launches: int) -> float | None:
    """Device time per launch (µs): every kernel fn launches, summed over
    ``launches`` calls under torch.profiler, over ``launches``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return total / launches if total else None


def _timed_in_turns(torch, calls, launches):
    times = {name: [] for name in calls}
    for name in [*calls, *reversed(calls)]:
        times[name].append(device_us(torch, calls[name], launches))
    return {name: dict(rounds=t, mean_us=statistics.mean(t) if None not in t else None)
            for name, t in times.items()}


def quantize_probe(torch, qz, libs, dev, launches, budget):
    """Device µs a launch of each variant that changes quantize (and of
    this tree's dequantize, as the pair's other half), at u and v."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    names = [n for n in libs if not n.startswith("dequantize:")]
    for label, n in (("u", 480_189), ("v", 17_770)):
        x = torch.randn(n, generator=gen, device=dev)
        noise = torch.rand(n, generator=gen, device=dev)
        scale = torch.max(torch.abs(x))
        want = qz.ref.quantize(x, noise, scale, budget)
        q = torch.empty(n, dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        calls = {}
        for name in names:
            def call(lib=libs[name]):
                err = lib.qz_quantize_f32(x.data_ptr(), noise.data_ptr(), scale.data_ptr(),
                                          q.data_ptr(), n, budget, dev.index, stream)
                if err:
                    raise RuntimeError(f"quantize launch failed ({err})")
            q.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(q, want):
                raise SystemExit(f"quantize {name} at n={n} differs from its plain version")
            calls[name] = call
        out[label] = _timed_in_turns(torch, calls, launches)
        for name, row in out[label].items():
            print(f"{label} (n = {n}): quantize {name:30s} device {row['mean_us']} µs a launch "
                  f"(rounds {row['rounds']})", flush=True)
    return out


def dequantize_probe(torch, qz, libs, dev, launches, budget):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    names = [n for n in libs if not n.startswith("quantize:")]
    for label, n in (("u", 480_189), ("v", 17_770)):
        q = torch.randint(-budget, budget + 1, (n,), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand((), generator=gen, device=dev) + 0.5
        want = qz.ref.dequantize(q, scale, budget)
        y = torch.empty(n, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        calls = {}
        for name in names:
            def call(lib=libs[name]):
                err = lib.qz_dequantize_f32(q.data_ptr(), scale.data_ptr(), y.data_ptr(), n,
                                            budget, dev.index, stream)
                if err:
                    raise RuntimeError(f"dequantize launch failed ({err})")
            call()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise SystemExit(f"dequantize {name} at n={n} differs from its plain version")
            calls[name] = call
        out[label] = _timed_in_turns(torch, calls, launches)
        for name, row in out[label].items():
            print(f"{label} (n = {n}): dequantize {name:30s} device {row['mean_us']} µs a "
                  f"launch (rounds {row['rounds']})", flush=True)
    return out


def cudart(torch):
    """The CUDA runtime library the process has loaded, or None."""
    major = (torch.version.cuda or "0").split(".")[0]
    for name in (f"libcudart.so.{major}", "libcudart.so",
                 "/usr/local/cuda/lib64/libcudart.so"):
        try:
            lib = ctypes.CDLL(name)
            lib.cudaDeviceSetLimit.argtypes = [ctypes.c_int, ctypes.c_size_t]
            lib.cudaDeviceGetLimit.argtypes = [ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
            return lib
        except (OSError, AttributeError):
            continue
    return None


def time_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def gather_probe(torch, mc, dev, entries, reps):
    rt = cudart(torch)
    if rt is None:
        print("L2 fetch granularity: the CUDA runtime library could not be opened (not measured)")
        return None
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = torch.randint(0, 480_189, (entries,), generator=gen, device=dev, dtype=torch.int32)
    cols = torch.randint(0, 17_770, (entries,), generator=gen, device=dev, dtype=torch.int32)
    fields = [torch.randn(entries, generator=gen, device=dev) for _ in range(3)] + [cols]
    order = mc.build_order(rows, cols, 480_189, 17_770)
    perm = order.perm.long()
    torch.cuda.synchronize()
    start = ctypes.c_size_t(0)
    if rt.cudaDeviceGetLimit(ctypes.byref(start), L2_FETCH_LIMIT) != 0:
        print("L2 fetch granularity: cudaDeviceGetLimit refused (not measured)")
        return None
    out = dict(start_bytes=start.value, settings={})
    for limit in (start.value, 32, 64, 128, start.value):
        torch.cuda.synchronize()
        if rt.cudaDeviceSetLimit(L2_FETCH_LIMIT, limit) != 0:
            print(f"L2 fetch granularity {limit}: cudaDeviceSetLimit refused")
            continue
        got = ctypes.c_size_t(0)
        rt.cudaDeviceGetLimit(ctypes.byref(got), L2_FETCH_LIMIT)
        one = mc.gather_sorted(order, fields[0])
        four = mc.gather_sorted_fields(order, fields)
        torch.cuda.synchronize()
        if not (torch.equal(one, fields[0][perm])
                and all(torch.equal(c, t[perm]) for c, t in zip(four, fields))):
            raise SystemExit(f"a gather at L2 fetch granularity {limit} is not field[perm]")
        del one, four
        row = dict(set_bytes=limit, read_back_bytes=got.value,
                   one_field_ms=time_ms(torch, lambda: mc.gather_sorted(order, fields[0]), reps),
                   four_fields_ms=time_ms(torch, lambda: mc.gather_sorted_fields(order, fields),
                                          reps))
        out["settings"].setdefault(str(limit), []).append(row)
        print(f"L2 fetch granularity {limit} (read back {got.value}): one-field gather "
              f"{row['one_field_ms']:.3f} ms, record gather of four fields "
              f"{row['four_fields_ms']:.3f} ms ({entries} entries, one order)", flush=True)
    rt.cudaDeviceSetLimit(L2_FETCH_LIMIT, start.value)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=None, help="an older tree's src directory")
    ap.add_argument("--entries", type=int, default=100_480_507)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-gather", action="store_true", help="run probe (1) only")
    ap.add_argument("--budget", type=int, default=127,
                    help="the quantize budget (127 // N for N workers)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_dequantize_gather_probe: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import mc_matvec as mc
    from repro_torch.kernels import quantize as qz

    dev = torch.device("cuda", torch.cuda.current_device())
    src_text = (ROOT / "src" / "repro_torch" / "csrc" / "quantize.cu").read_text()
    libs = build(variants(src_text, Path(args.src).resolve() if args.src else None))
    report = dict(quantize=quantize_probe(torch, qz, libs, dev, args.launches, args.budget),
                  dequantize=dequantize_probe(torch, qz, libs, dev, args.launches, args.budget),
                  gather=None if args.no_gather else gather_probe(torch, mc, dev, args.entries,
                                                                  args.reps))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    report["card"] = smi
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
