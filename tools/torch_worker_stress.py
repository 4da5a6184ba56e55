#!/usr/bin/env python3
"""Runs ``tests/test_torch_block_multi.py``'s four gloo workers (``_ranks``:
the block solver's five parity cases and the hier:2 int8 run, on the CPU)
over and over, in several processes at once, and counts the runs in which a
worker died on a signal.

    JAX_PLATFORMS=cpu python3 tools/torch_worker_stress.py [--src OTHER/src] \\
        [--copies 6] [--runs 10]

The JAX reference's tables (the fixture's) are made once, in a subprocess.
Then --copies processes each call ``launch.dfw.run_workers`` --runs times
and print one line a run. --src imports the port from another checkout's
``src`` (an older tree, for a count before a change). It prints the runs,
the failed runs by their error, and exits non-zero if any run failed. A
worker that aborted in its teardown (SIGABRT, "terminate called without an
active exception") is what this counts; one full run of the workers takes
about 20 s with six copies on 8 cores.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _copy(src: str, data_path: str, ref_path: str, runs: int) -> None:
    """One stressing process: ``runs`` runs of the workers, a line each."""
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np

    import test_torch_block_multi as t
    from repro_torch.launch import dfw

    data, ref = dict(np.load(data_path)), dict(np.load(ref_path))
    for i in range(runs):
        try:
            dfw.run_workers(t.NW, t._ranks, data, ref, device="cpu")
            print("ok", flush=True)
        except Exception as e:  # a failed run is the count, not a stop
            print(f"FAILED {type(e).__name__}: {e}".splitlines()[0], flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--copies", type=int, default=6)
    ap.add_argument("--runs", type=int, default=10, help="runs of the workers in each copy")
    ap.add_argument("--copy", nargs=2, help=argparse.SUPPRESS)  # data, ref: run as one copy
    args = ap.parse_args()
    src = str(Path(args.src).resolve())
    if args.copy:
        _copy(src, *args.copy, args.runs)
        return 0
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np

    import test_torch_block_multi as t

    with tempfile.TemporaryDirectory() as tmp:
        data_path, ref_path = os.path.join(tmp, "data.npz"), os.path.join(tmp, "ref.npz")
        np.savez(data_path, **t._data())
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", textwrap.dedent(t._JAX_SCRIPT), data_path,
                        ref_path, json.dumps(t.CASES)], check=True, capture_output=True, env=env)
        procs = [subprocess.Popen([sys.executable, __file__, "--src", src, "--runs",
                                   str(args.runs), "--copy", data_path, ref_path],
                                  stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
                 for _ in range(args.copies)]
        lines = [line.strip() for p in procs for line in p.communicate()[0].splitlines()]
    failed = Counter(line for line in lines if line.startswith("FAILED"))
    print(f"{src}: {len(lines)} runs of {t.NW} workers in {args.copies} copies at once, "
          f"{sum(failed.values())} failed")
    for line, count in failed.items():
        print(f"  {count} x {line}")
    return 1 if failed or len(lines) != args.copies * args.runs else 0


if __name__ == "__main__":
    sys.exit(main())
