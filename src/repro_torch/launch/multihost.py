"""Multi-host launcher of the port: ``host_topology`` and the ``dfw``
subcommand, the counterparts of the JAX package's ``launch/multihost.py``.

One process per card, on every host, under any launcher that sets the
``torch.distributed`` environment (``torchrun``: ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_WORLD_SIZE``)::

    torchrun --nnodes 2 --nproc-per-node 4 ... -m repro_torch.launch.multihost dfw \\
        --epochs 20 --comm int8

or with the address given (``--coordinator host:port --num-hosts N
--host-id j``, one process a host). ``host_topology`` maps the layout onto
the exchange graph: ``hier:<hosts>`` across hosts (the exact sum stays
inside a host, only the encoded hop crosses the host network), ``flat`` on
one host. The ``dfw`` subcommand fits a synthetic low-rank least-squares
problem with ``launch.dfw.fit`` over all the processes, a bring-up probe of
the distributed path. ``train`` runs ``launch.train`` over the group (with
``--mesh DxM`` sharded over all its processes: ``torchrun
--nproc-per-node 4 -m repro_torch.launch.multihost train --arch qwen2-1.5b
--mesh 2x2``); ``serve`` runs ``launch.serve`` in every process (the
reference's serve takes no mesh). ``dryrun`` (the lowering for 512
placeholder workers) is not ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import torch

from ..specs import NotYetPorted


def hosts_from_env() -> int:
    """Hosts of this run: the world size over the processes a host runs
    (``LOCAL_WORLD_SIZE``, default all of them: one host)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return max(1, world // max(1, local))


def host_topology(num_hosts: Optional[int] = None) -> str:
    """The comm topology matching the process layout (``DFWConfig.topology``
    grammar): ``"hier:<num_hosts>"`` on several hosts, ``"flat"`` on one.
    ``num_hosts=None`` reads it from the environment (:func:`hosts_from_env`)."""
    nh = hosts_from_env() if num_hosts is None else int(num_hosts)
    return "flat" if nh <= 1 else f"hier:{nh}"


def initialize(coordinator: Optional[str], num_hosts: int, host_id: int, backend: str) -> int:
    """Join the process group: at ``coordinator`` (tcp, one process a host)
    when given, else from the environment when it names more than one
    process. Returns the host count (1 without a group)."""
    import torch.distributed as dist

    if coordinator is not None and num_hosts > 1:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_hosts, rank=host_id)
        return num_hosts
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
        return hosts_from_env()
    return 1


def _dfw_main(argv: List[str], *, hosts: int, device: torch.device) -> None:
    """Distributed DFW-Trace on a synthetic low-rank MTLS problem, over all
    the processes, with the graph from the host layout (``--topology``
    overrides it)."""
    from ..comm import WorkerGroup
    from ..core import tasks
    from . import dfw

    ap = argparse.ArgumentParser(prog="dfw")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--comm", default="dense", help="dense | int8 | topk:r")
    ap.add_argument("--topology", default="auto",
                    help="flat | ring | gossip:k | hier:g | auto (host layout)")
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--tasks", dest="m", type=int, default=48)
    ap.add_argument("--gap-tol", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    group = WorkerGroup() if dist.is_initialized() else None
    nw = 1 if group is None else group.size
    topology = host_topology(hosts) if args.topology == "auto" else args.topology
    gen = torch.Generator().manual_seed(7)  # the same data in every process
    w_star = torch.randn(args.dim, args.m, generator=gen)
    w_star = w_star / torch.linalg.matrix_norm(w_star, ord="nuc")
    n = (args.samples // nw) * nw
    x = torch.randn(n, args.dim, generator=gen)
    y = x @ w_star
    task = tasks.MultiTaskLeastSquares(d=args.dim, m=args.m)
    cfg = dfw.DFWConfig(mu=args.mu, num_epochs=args.epochs, step_size="linesearch",
                        comm=args.comm, topology=topology, gap_tol=args.gap_tol,
                        checkpoint_dir=args.ckpt_dir)
    res = dfw.fit(task, x, y, cfg=cfg, key=1, group=group, device=device)
    if group is None or group.rank == 0:
        print(f"[multihost.dfw] workers={nw} topology={topology} comm={args.comm} "
              f"epochs_run={res.epochs_run} final_loss={res.final_loss:.6f} "
              f"gap={res.history['gap'][-1]:.4f}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default: this process's local card)")
    ap.add_argument("command", choices=["train", "serve", "dryrun", "dfw"])
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.command == "dryrun":
        raise NotYetPorted("multihost 'dryrun' (the lowering for 512 placeholder workers, "
                           "over a fake process group and meta tensors) is not yet ported to "
                           "PyTorch: it is the next item of ROADMAP section 1, Sharded LM paths")

    import torch.distributed as dist

    from .. import resolve_device
    from ..comm import destroy_groups

    if args.device is None:
        device = resolve_device(torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))))
        torch.cuda.set_device(device)
    else:
        device = resolve_device(args.device)
    hosts = initialize(args.coordinator, args.num_hosts, args.host_id,
                       "nccl" if device.type == "cuda" else "gloo")
    grouped = dist.is_initialized()
    try:
        if not grouped or dist.get_rank() == 0:
            world = dist.get_world_size() if grouped else 1
            print(f"[multihost] {world} processes on {hosts} host(s) "
                  f"(host_topology={host_topology(hosts)})")
        rest = [a for a in args.rest if a != "--"]
        if args.command == "dfw":
            _dfw_main(rest, hosts=hosts, device=device)
        else:
            from . import serve, train
            if "--device" not in rest:
                rest += ["--device", str(device)]
            (train if args.command == "train" else serve).main(rest)
    finally:
        if grouped:
            destroy_groups()


if __name__ == "__main__":
    main(sys.argv[1:])
