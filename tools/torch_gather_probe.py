#!/usr/bin/env python3
"""The card's rate of random 32-byte sectors gathered from a table in L2, for
the gather floors of the port's COO kernels (``coo_matmat``, the block
``update_resid``), on one GPU.

    python3 tools/torch_gather_probe.py [--reps R] [--count N]

Builds ``tools/gather_probe.cu`` with the port's nvcc flags and times (CUDA
events, the median of --reps calls) N = 100,480,507 random row reads (the
Netflix rating count) from each table the block kernels gather from: rows of
8 floats (32 bytes, one sector: k = 8) from a 480,189-row table (15.4 MB, U)
and a 17,770-row one (0.57 MB, V); rows of 32 floats (128 bytes, four
sectors: k = 32) from the same row counts (61 MB, past the 50 MB L2, and 2.3
MB). Each row is read by 1, 2 or 8 lanes at k = 8 (two 16-byte loads a lane,
one, or 4 bytes a lane) and 1, 8 or 32 at k = 32. The row of a read is a hash
of its number: no index array moves. It prints ms, sectors a second and GB/s
for each, the best rate of each table (what ``floor_ms`` uses), and last the
card's name and power limit. ``chip_smoke.py`` phase 25 calls ``measure``
and ``floor_ms`` in its own run. It exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "gather_probe.cu"
COUNT = 100_480_507
TABLES = {"U": 480_189, "V": 17_770}  # rows: the Netflix users and movies
LANES = {8: (1, 2, 8), 32: (1, 8, 32)}  # lanes a row, by row width in floats
SECTOR = 32


def _library():
    if "repro_torch" not in sys.modules:  # the port's build helpers, for nvcc and its flags
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    so = _build.BUILD_DIR / f"gather_probe-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(".tmp")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        tmp.rename(so)
    lib = ctypes.CDLL(str(so))
    lib.gather_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.gather_probe.restype = ctypes.c_int
    return lib


def measure(torch, dev, reps: int = 10, count: int = COUNT) -> dict:
    """{(width, table): {"lanes": {lanes: (ms, sectors/s)}, "best": sectors/s}}
    for widths 8 and 32 floats and the tables "U" and "V"."""
    lib = _library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = 8 * sms
    sink = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for width, lanes in LANES.items():
        for name, rows in TABLES.items():
            table = torch.randn(rows, width, device=dev)
            sectors = count * width * 4 // SECTOR
            res = {}
            for lpr in lanes:
                def call():
                    err = lib.gather_probe(width, lpr, table.data_ptr(), rows, count,
                                           sink.data_ptr(), blocks, stream)
                    if err:
                        raise RuntimeError(f"gather_probe launch failed: error {err}")
                for _ in range(2):
                    call()
                torch.cuda.synchronize()
                times = []
                for _ in range(reps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call()
                    end.record()
                    times.append((start, end))
                torch.cuda.synchronize()
                ms = statistics.median(s.elapsed_time(e) for s, e in times)
                res[lpr] = (ms, sectors / (ms * 1e-3))
            out[(width, name)] = {"lanes": res, "bytes": rows * width * 4,
                                  "best": max(r[1] for r in res.values())}
            del table
    return out


def floor_ms(rates: dict, width: int, sectors: dict, seq_bytes: float,
             bytes_per_s: float) -> float:
    """The gather floor: ``sectors`` ({"U": n, "V": n}, 32-byte sectors from
    each table) at the table's best measured rate for rows of ``width``
    floats, added to the sequential bytes over the memory rate."""
    t = sum(n / rates[(width, name)]["best"] for name, n in sectors.items())
    return 1e3 * (t + seq_bytes / bytes_per_s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--count", type=int, default=COUNT)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gather_probe: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rates = measure(torch, dev, args.reps, args.count)
    print("row bytes, table, table MB, lanes a row, ms, G sectors/s, GB/s")
    for (width, name), r in rates.items():
        for lpr, (ms, rate) in r["lanes"].items():
            print(f"{4 * width}, {name}, {r['bytes'] / 1e6:.2f}, {lpr}, {ms:.4f}, "
                  f"{rate / 1e9:.2f}, {rate * SECTOR / 1e9:.1f}")
        print(f"{4 * width}, {name}: best {r['best'] / 1e9:.2f} G sectors/s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
