#!/usr/bin/env python3
"""Does gloo's point-to-point path take CUDA tensors?

    python3 tools/torch_gloo_p2p_probe.py [--timeout 60]

Two gloo processes on one card exchange a CUDA vector with
``batch_isend_irecv`` (send to the other, receive from it), each in its own
child process under a time limit, first with the CUDA tensors as they are,
then staged through host memory (``comm.WorkerGroup.shift``'s path for
gloo). Prints one line per way: whether it ran, and whether the received
vector is the peer's, with the card's name and power limit. gloo's
collectives stage CUDA tensors inside ``torch.distributed``; this tells
whether its sends need the port to stage them.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

_CHILD = r"""
import os, sys, torch, torch.distributed as dist
rank, tmp, staged = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 2), rank=rank,
                        world_size=2)
dev = torch.device("cuda", 0)
x = torch.full((1 << 16,), float(rank + 1), device=dev)
wire = x.cpu() if staged else x
got = torch.empty_like(wire)
reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, wire, 1 - rank),
                               dist.P2POp(dist.irecv, got, 1 - rank)])
for r in reqs:
    r.wait()
got = got.to(dev)
torch.cuda.synchronize()
ok = bool(torch.all(got == float(2 - rank)))
dist.destroy_process_group()
print("OK" if ok else "WRONG")
"""


def attempt(staged: bool, timeout: float) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r), tmp, "1" if staged else "0"],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
                outs.append(out.strip() or f"exit {p.returncode}: {err.strip().splitlines()[-1:]}")
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                outs.append(f"no answer in {timeout:.0f} s")
        return "; ".join(f"rank {r}: {o}" for r, o in enumerate(outs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    print(f"gloo send/recv of CUDA tensors as they are: {attempt(False, args.timeout)}")
    print(f"gloo send/recv staged through the host: {attempt(True, args.timeout)}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
