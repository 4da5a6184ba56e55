#!/usr/bin/env python
"""Check every declared contract of the PyTorch port
(``repro_torch.analysis.contracts.verify_declared``), the twin of
``tools/repro_contracts.py``.

The power method's 2K all-reduce contracts (rank-1 and block) run on four
gloo worker processes on the CPU, read from each worker's op log
(``analysis.recorder``); the engine's dispatch contract (rank-1 and
``block:4:adapt``), the serving engine's never-materialize contract and the
no-op telemetry handle's run in this process on ``--device``: the card by
default, as every entry point of the port (the programs and the scorer are
then captured into CUDA graphs, and their captures are read); ``--device
cpu`` runs them uncaptured on the CPU.

    python tools/torch_contracts.py [--device cuda|cpu]

Exit 0 when every contract holds; 1 naming the op or counter at fault.
About 15 s with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="the engine and serving probes' device (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.analysis import contracts

    return contracts.verify_declared(verbose=True, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
