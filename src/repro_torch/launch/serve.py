"""Serving driver, the port's counterpart of ``repro.launch.serve``.

``serve_factored`` scores request vectors against a DFW-Trace run
checkpoint through ``repro_torch.serve.ServingEngine`` (the ``factor_matvec``
kernel, padded static batches, rank buckets) and, with ``follow``, polls the
directory and hot-swaps onto every newer step that training writes: one
process fits, this one scores, and the model never exists as a dense d x m
matrix in either.

CLI: ``python -m repro_torch.launch.serve factor --checkpoint DIR`` (on the
card; ``--device cpu`` runs the plain PyTorch version). The reference's
``lm`` subcommand (LM decode over the model zoo) is not yet ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import DeviceLike
from ..checkpoint.store import list_steps
from ..serve import ServeConfig, ServingEngine
from ..specs import NotYetPorted


def serve_factored(
    *,
    checkpoint: str,
    max_batch: int = 64,
    rank_block: int = 32,
    transpose: bool = False,
    batches: int = 8,
    follow: int = 0,
    poll_s: float = 0.2,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Serve random request traffic from a run-checkpoint directory.

    Loads the latest step, scores ``batches`` full batches, then polls the
    directory ``follow`` more rounds, hot-swapping whenever a newer step has
    appeared, and scores ``batches`` more after each poll. Prints one line
    per round and swap; returns a summary dict.
    """
    cfg = ServeConfig(max_batch=max_batch, rank_block=rank_block, transpose=transpose)
    eng = ServingEngine.from_checkpoint(checkpoint, cfg, device=device)
    print(
        f"[serve] {eng.d}x{eng.m} model on {eng.device}, step {eng.model.step}, live "
        f"rank {eng.model.live_rank} (bucket {eng.model.capacity}), max_batch {max_batch}"
    )
    rng = np.random.default_rng(seed)

    def pump(n_batches: int) -> float:
        xs = rng.standard_normal((n_batches, max_batch, eng.n_in), np.float32)
        t0 = time.perf_counter()
        handles = [eng.score_async(xs[i]) for i in range(n_batches)]
        rows = sum(h.block().shape[0] for h in handles)
        dt = time.perf_counter() - t0
        print(
            f"[serve] scored {rows} requests in {dt * 1e3:.1f} ms "
            f"({rows / max(dt, 1e-9):.0f} req/s, model v{eng.model.version})"
        )
        return dt

    pump(batches)
    for _ in range(follow):
        time.sleep(poll_s)
        steps = list_steps(checkpoint)
        if steps and steps[-1] != eng.model.step:
            before = eng.stats["compilations"]
            model = eng.load(checkpoint, step=steps[-1])
            print(
                f"[serve] hot-swap -> step {model.step}, live rank {model.live_rank}, "
                f"+{eng.stats['compilations'] - before} buckets"
            )
        pump(batches)
    print(f"[serve] stats: {eng.stats}")
    return {"stats": eng.stats, "step": eng.model.step,
            "live_rank": eng.model.live_rank, "version": eng.model.version}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    fp = sub.add_parser("factor", help="score requests from a DFW checkpoint")
    fp.add_argument("--checkpoint", required=True)
    fp.add_argument("--max-batch", type=int, default=64)
    fp.add_argument("--rank-block", type=int, default=32)
    fp.add_argument("--transpose", action="store_true",
                    help="score x @ W^T (m -> d) instead of x @ W")
    fp.add_argument("--batches", type=int, default=8)
    fp.add_argument("--follow", type=int, default=0,
                    help="poll the checkpoint dir N more rounds, hot-swapping onto any new step")
    fp.add_argument("--poll-s", type=float, default=0.2)
    fp.add_argument("--seed", type=int, default=0)
    fp.add_argument("--device", default=None, help="default: cuda")
    sub.add_parser("lm", help="LM decode over the model zoo (not yet ported)")
    args, rest = ap.parse_known_args(argv)
    if args.mode == "lm":
        raise NotYetPorted("the lm serving driver (the LM zoo) is not yet ported to PyTorch")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    serve_factored(
        checkpoint=args.checkpoint, max_batch=args.max_batch, rank_block=args.rank_block,
        transpose=args.transpose, batches=args.batches, follow=args.follow,
        poll_s=args.poll_s, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
