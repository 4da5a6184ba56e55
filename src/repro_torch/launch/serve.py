"""Serving drivers, the port's counterpart of ``repro.launch.serve``.

Two traffic shapes live here:

* ``serve_factored`` scores request vectors against a DFW-Trace run
checkpoint through ``repro_torch.serve.ServingEngine`` (the ``factor_matvec``
kernel, padded static batches, rank buckets) and, with ``follow``, polls the
directory and hot-swaps onto every newer step that training writes: one
process fits, this one scores, and the model never exists as a dense d x m
matrix in either.
* ``generate`` decodes a batch of prompts over the LM zoo's decoder
  families (dense, ssm (RWKV-6), vlm, hybrid (Mamba-2 with a shared
  attention block)), token by token through ``decode_step`` against a KV
  cache (dense, vlm), a recurrent state (ssm) or both (hybrid), greedily or
  with temperature sampling; on the card every step is a replay of one
  captured CUDA graph. The encoder-only audio family has no decode (its
  step is ``launch.steps.make_prefill_step``'s encoder step).

CLI: ``python -m repro_torch.launch.serve factor --checkpoint DIR`` or
``python -m repro_torch.launch.serve lm --arch NAME`` (on the card;
``--device cpu`` runs the plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import time

from typing import Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..checkpoint.store import list_steps
from ..configs import get_config
from ..core import cuda_graph
from ..models import lm
from ..serve import ServeConfig, ServingEngine
from .steps import make_serve_step


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


# ---------------------------------------------------------------------------
# LM decode
# ---------------------------------------------------------------------------


def generate(
    *,
    arch: str,
    batch: int = 4,
    prompt_len: int = 16,
    max_new_tokens: int = 32,
    smoke: bool = True,
    temperature: float = 0.0,
    seed: int = 0,
    device: DeviceLike = None,
    params: Optional[dict] = None,
    prompt=None,
    cache: Optional[dict] = None,
    stats: Optional[dict] = None,
):
    """Greedy or temperature sampling over the synthetic-token distribution,
    the reference's loop: the prompt is fed token by token through the serve
    step, then each step feeds the last sampled token, for prompt_len +
    max_new_tokens - 1 steps against a cache of prompt_len + max_new_tokens
    slots. Returns the (batch, max_new_tokens) new tokens as numpy int64.

    One step (``_decode_step``) reads its position from the device, picks
    its input token there (the prompt's column while the position is inside
    the prompt, else the last sampled token), runs ``decode_step``, samples,
    writes the token into its output column and advances the position. On
    CUDA that step is captured once into a CUDA graph (after one warm-up
    step on a scratch cache) and replayed for every position, the
    counterpart of the reference's ``jax.jit(serve_step)``; the tokens come
    back to the host once, at the end. On the CPU the same step runs
    uncaptured. A failed capture or replay raises.

    Free runs draw the parameters and then the prompt from one
    ``torch.Generator`` seeded with ``seed`` on the device; temperature
    sampling draws from it too (``torch.multinomial``; the graph registers
    the generator, so each replay draws afresh), so it matches the
    reference in distribution only. ``params`` (a port parameter dict, e.g.
    from ``convert.lm_params``) and ``prompt`` ((batch, prompt_len) token
    ids) replace the draws; the tests inject the JAX run's arrays there.
    ``cache`` (``lm.init_cache``'s zeroed allocation for batch and
    prompt_len + max_new_tokens) is the cache to fill, which the caller can
    read after the run. ``stats``, when given a dict, receives the loop's
    wall time (``loop_s``, ``ms_per_step``: the replays and the final read),
    ``captures``, ``capture_ms``, ``graph_replays`` and the graph's
    ``pool_bytes``."""
    cfg = get_config(arch, smoke=smoke)
    if cfg.encoder_only:
        raise ValueError(f"{arch} is encoder-only; no decode path")
    lm.check_family(cfg)
    if prompt_len < 1 or max_new_tokens < 1:
        raise ValueError(f"prompt_len={prompt_len}, max_new_tokens={max_new_tokens}: "
                         "both must be >= 1")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if params is None:
        params = lm.init_params(cfg, gen)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)
    else:
        prompt = torch.from_numpy(np.array(prompt, dtype=np.int64)).to(dev)
        if tuple(prompt.shape) != (batch, prompt_len):
            raise ValueError(f"prompt has shape {tuple(prompt.shape)}, expected "
                             f"{(batch, prompt_len)}")
    max_len = prompt_len + max_new_tokens
    specs = lm.cache_specs(cfg, batch, max_len)
    if cache is None:
        cache = lm.init_cache(cfg, batch, max_len, device=dev)
    elif {k: (tuple(v.shape), v.dtype, v.device) for k, v in cache.items()} != {
            k: (shape, dt, dev) for k, (shape, dt) in specs.items()}:
        raise ValueError(f"cache does not match lm.cache_specs for batch {batch} and "
                         f"{max_len} slots on {dev}")
    step = make_serve_step(cfg)
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    last = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    out = torch.zeros((batch, max_new_tokens), dtype=torch.int64, device=dev)

    def run(cache, pos, last, out):
        _decode_step(step, params, cache, prompt, pos, last, out, temperature, gen,
                     mrope=cfg.family == "vlm")

    steps = max_len - 1
    info = dict(captures=0, capture_ms=0.0, graph_replays=0, pool_bytes=0)
    if dev.type == "cuda":
        stream = torch.cuda.Stream(dev)
        # one step outside the capture, on the capture stream and a scratch
        # cache: lazy kernels and cuBLAS's workspace are made here
        scratch = ({k: torch.zeros_like(v) for k, v in cache.items()}, torch.zeros_like(pos),
                   torch.zeros_like(last), torch.zeros_like(out))
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            run(*scratch)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph, capture_ms, pool_bytes = cuda_graph.capture(
            lambda: run(cache, pos, last, out), stream=stream,
            generators=(gen,) if temperature > 0 else ())
        del scratch
        info.update(captures=1, capture_ms=capture_ms, pool_bytes=pool_bytes)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            graph.replay()
        info["graph_replays"] = steps
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            run(cache, pos, last, out)
    new = out.cpu().numpy()
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.update(loop_s=dt, steps=steps, new_tokens=max_new_tokens,
                     ms_per_step=1e3 * dt / steps, **info)
    print(f"[serve] {arch}: generated {new.shape} in {dt:.2f}s "
          f"({dt / max_new_tokens * 1e3:.1f} ms/token at batch {batch})")
    return new


def _decode_step(step, params, cache, prompt, pos, last, out, temperature: float,
                 gen: torch.Generator, mrope: bool = False) -> None:
    """One step of ``generate``'s loop at the device position ``pos`` (0-d
    int64): the input token is the prompt's column ``pos`` while ``pos`` <
    prompt_len, else ``last``; the sampled token goes into ``last`` and into
    ``out``'s column pos - (prompt_len - 1) (column 0 while still inside the
    prompt, rewritten by the prompt's last step); then ``pos`` += 1. With
    ``mrope`` (the vlm family) the step's M-RoPE positions are (pos, pos,
    pos) for every row, made here from the device position, as the
    reference passes ``jnp.full((B, 3, 1), t)``. Reads nothing back to the
    host."""
    prompt_len = prompt.shape[1]
    fed = prompt.index_select(1, pos.clamp(max=prompt_len - 1).reshape(1))
    cur = torch.where(pos < prompt_len, fed, last)
    batch = {"tokens": cur, "cache_pos": pos}
    if mrope:
        batch["positions"] = pos.reshape(1, 1, 1).expand(cur.shape[0], 3, 1)
    logits, _ = step(params, cache, batch)
    scores = logits[:, 0, :].float()
    if temperature > 0:
        nxt = torch.multinomial(torch.softmax(scores / temperature, dim=-1), 1, generator=gen)
    else:
        nxt = torch.argmax(scores, dim=-1, keepdim=True)
    last.copy_(nxt)
    out.index_copy_(1, (pos - (prompt_len - 1)).clamp(min=0).reshape(1), nxt)
    pos.add_(1)


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
    lp = sub.add_parser("lm", help="LM decode over the model zoo (dense, ssm, vlm and hybrid "
                        "families)")
    lp.add_argument("--arch", required=True)
    lp.add_argument("--batch", type=int, default=4)
    lp.add_argument("--prompt-len", type=int, default=16)
    lp.add_argument("--max-new-tokens", type=int, default=32)
    lp.add_argument("--temperature", type=float, default=0.0)
    lp.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return generate(
            arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
            max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            device=args.device,
        )
    return serve_factored(
        checkpoint=args.checkpoint, max_batch=args.max_batch, rank_block=args.rank_block,
        transpose=args.transpose, batches=args.batches, follow=args.follow,
        poll_s=args.poll_s, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
