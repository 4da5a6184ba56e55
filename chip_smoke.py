#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, as on an H100

Phases, each fatal on failure (exit code != 0, no result line):

1. Build the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes (n = 1,281,167 rows; R is n x 1000, X is n x 2048) and
   at tiny odd shapes, and time kernel, plain version and the one PyTorch
   call that computes the same function (CUDA events, median of --reps);
   print matvec's time over torch.mv's on R and on X (timed in turns,
   kernel, call, call, kernel; not a gate); matvec and rmatvec repeat their
   bits.
3. Drive the main path, ``launch.dfw.fit_serial``, for multi-task least
   squares at the paper's ImageNet shapes (n = 1,281,167, d = 2048,
   m = 1000, f32): planted rank-10 trace-norm-1 W* plus small noise, log
   schedule, line search, --epochs epochs. The loss must be finite and
   non-increasing and every kernel launch count must be what the path
   implies.
4. The same for multinomial logistic regression (planted rank-10 labels,
   5% label noise, log_half schedule): final loss below n ln m.
5. Hold small fits on the card against the same fits on the CPU (plain
   versions), with the same start vectors: histories agree to rtol 1e-4.
6. Make matrix-completion data on the card from --seed at the Netflix Prize
   shapes (d = 480,189 users, m = 17,770 movies, 100,480,507 training and
   1,408,395 held-out ratings; users and movies drawn from popularity laws
   whose busiest user and movie hold about as many ratings as in the
   published data; values from a planted rank-10 matrix plus noise 0.1).
7. Build the MC state and print its wall time and its parts (device time
   of the two stable sorts, of the rest of the orders' pieces, and of the
   copies' record gather, from the profiler). Hold the state's eight sorted
   copies and both orders' gather index to field[perm], bit for bit; time
   the record gather that makes them (both orders) against its bound, the
   random-access floor (one 32-byte sector per entry per order at the rate
   of random sectors the one-field gather shows in the same run) and the
   chain of four index_select calls per order; time the one-field gather.
   Hold the COO matvec (both directions, on the residual's copies in the
   row and column orders) and the int8 quantize pair against their plain
   versions at those shapes and at odd ones (n = 15, 16, 17, 135,167,
   135,168, 135,171 around quantize's four-a-thread threshold; budgets 1,
   15, 31 and 127; q one byte off alignment), and time them (the quantize
   pair also by device time, quantize's beside the one-element-a-thread
   kernel's); hold ``update_resid`` (the residual after a step, in caller,
   row and column order from one launch) to the update's plain chain
   followed by ``gather_sorted``, bit for bit, with gamma from the line
   search and from the 2/(t+2) schedule and mu = 0, and time it against
   that chain and gathers.
8. Drive ``fit_serial`` for matrix completion (comm "dense", log schedule,
   line search, --mc-epochs): loss finite and non-increasing, held-out RMSE
   below that of W = 0, launch counts as the path implies (one record
   gather per order and state built, one update_resid per epoch, no gather
   in an epoch).
9. The same with comm "int8" (--mc-int8-epochs): loss ends below its start,
   quantize and dequantize launched 2K times per epoch each.
10. Small MC fits, dense and int8, on the card against the CPU with the same
   start vectors and noise.
11. Hold the factor-form scoring kernel (``factor_matvec``) against its plain
   version at the serving shapes (batch 1, 64 and 1024; rank capacity 32,
   64 and 256; 2048 -> 1000 and 1000 -> 2048) and at tiny odd ones: 1e-4 of
   max, identical bits on repeat, and a live rank of 20 padded to capacity
   32 or 64 gives the same bits. Times of kernel, plain version, einsum and
   the cuBLAS chain; the kernel's device time at the serving shape; the
   count of tensor-core instructions (HMMA) in the built kernel's SASS.
12. Train, then serve: ``fit_serial`` of MTLS at d = 2048, m = 1000 with
   n cut to --serve-rows, --serve-epochs epochs, writing a checkpoint at
   every segment boundary; ``ServingEngine.from_checkpoint`` on the first
   step scores --serve-batches full batches of 64 (p50/p99 per dispatch,
   requests per second), hot-swaps to the latest step while a batch is in
   flight, walks every step, serves 640 single requests through a
   ``MicroBatcher`` and a transposed engine. Every score is checked against
   x @ W on the card; launches, rank buckets and the device memory the
   scoring adds are checked too.

13. Hold the flash attention kernel (``flash_attention``) against its plain
   version at the main path's shape (B = 4, Hq 12 / Hkv 2, S = 8192, Dh 128,
   causal, bf16), at prefill_32k's length (B = 1, S = 32,768), non-causal at
   S = 4096 (bf16 and f32), at tiny odd f32 shapes ((Sq, Skv) = (50, 70)
   and (70, 50), Dh 12 and 16, group sizes 1, 2, 8) and ragged bf16 ones
   around the 128-row tiles (Dh 64 and 128): every row up to 4096, the first
   and last 256 query rows beyond; identical bits on repeat; bf16 with Dh 64
   or 128 on the wgmma route, the rest on the generic one, and the count of
   HGMMA instructions in the built wgmma kernels' SASS (``cuobjdump``).
   Times of kernel, plain version and scaled_dot_product_attention.
14. Full-width prefill of qwen2-1.5b (28 layers, d 1536, vocab 151,936,
   bf16; weights drawn on the card from --seed) through
   ``launch.steps.make_prefill_step`` on 4 random prompts of 8,192 tokens:
   last logits finite, cache (28, 4, 2, 8192, 128), one flash_attention
   launch per layer, each on the wgmma route; ms per prefill (median of 3),
   tokens/s, peak memory.
15. Full-width decode: ``launch.serve.generate`` at batch 4, a 64-token
   prompt and 32 new tokens: tokens in range, no flash_attention launch
   (decode attention is the dense path); ms per step.
16. Cross-checks: full-width prefill against ``decode_step`` fed the prompt
   token by token (4 x 64 tokens) in f32 (1e-3 of max|logits|) and in bf16
   (5e-2); the smoke config's prefill on the card against the CPU (f32,
   rtol 1e-4).
17. Hold the RWKV-6 chunk kernel (``wkv6_chunk``) against its plain chunk
   form (taken in f64) at the main path's shape (B 4, H 64, q 256, head 64,
   bf16 r/k/v, f32 logw drawn like the model's decays, so that about a
   quarter of the pairs pass -80 and the clamps bind; u and S_in nonzero),
   in f32, at two decay extremes in both (logw near -1: almost every pair
   saturates; near -1e-3: no clamp binds), and at tiny odd shapes (q 50, 7,
   1, 100, 320, 192, 255; B * H = 3; dk, dv 16/32/48; bf16 logw): each
   (head, row) of y to its own max, 2e-4; against the exact recurrence at
   q = 32 (rtol = atol = 2e-4); identical bits on repeat; HMMA instructions
   in its SASS. Times of kernel, plain chunk form and exact recurrence; the
   bound on the TF32 tensor cores in 3xTF32 (495 / 3 TFLOP/s), and the f32
   CUDA cores' beside it.
18. Full-width prefill of rwkv6-7b (32 layers, d 4096, 64 heads of 64,
   d_ff 14,336, vocab 65,536, bf16; weights drawn on the card from --seed,
   then every layer's u_bonus redrawn nonzero, since the reference's zero
   init would hide the bonus term) through ``make_prefill_step`` on 4
   random prompts of 4,096 tokens: last logits finite, caches s (32, 4, 64,
   64, 64) and x_tm, x_cm (32, 4, 4096) f32, wkv6_chunk launched 32 x 16 =
   512 times; ms per prefill (median of 3), tokens/s, peak memory.
19. Full-width decode: ``generate`` at batch 4 with those weights, a 64-token
   prompt and 32 new tokens: tokens in range, no wkv6_chunk launch (decode
   is the exact recurrence in plain PyTorch); ms per step.
20. Cross-checks: (a) full-width prefill against ``decode_step`` fed the
   prompt token by token at 4 x 64 tokens (two chunks of 32, so no clamp
   binds: the least in-chunk cw is printed and must stay above -80), logits
   and every cache in f32 (1e-3); in bf16 each held to bf16 decode's own
   distance from the f32 computation on the same weights, and bf16
   prefill's distance from f32 to 1.25 times decode's; (b) bf16 at 4 x 256
   tokens, where the clamps bind: layer 0's s and x_tm caches held (5e-2),
   the logits' gap, the other caches' and the share of pairs past -80
   reported (ROADMAP caveat (e)); (c) the smoke config's prefill on the
   card against the CPU at chunk 32 and at chunk 256 over 512 tokens
   (clamps binding), f32, rtol 1e-4.

21. (a) ``launch.dfw.fit`` over a one-worker NCCL process group against
   ``fit_serial`` on the same data (least squares and logistic regression
   at the ImageNet shapes, matrix completion dense and int8 on new ratings
   at the Netflix shapes, the configurations of phases 3, 4, 8 and 9), run
   in turns (serial, fit, fit, serial): every run's history, final loss and
   iterate the same bits (int8: ``fit_serial`` handed worker 0's noise
   stream) and the same kernel launches; ms an epoch of each side.
22. (b) ``fit`` on four gloo workers (``run_workers``) sharing the one card
   with CUDA tensors, which gloo stages through the host: least squares
   (--epochs) with n cut to 1,281,164 (the largest multiple of 4) against
   ``fit_serial`` on the same rows; matrix completion (--mc-int8-epochs)
   dense against its own ``fit_serial`` run of as many epochs, int8 at the
   four workers' budget 31 and dense with sample_prob 0.8, the ratings laid
   out by ``shard_observations`` and shared with the workers through CUDA
   IPC. Dense histories within the reference's sharded-vs-serial tolerances
   (loss rtol 1e-5, gap 1e-4, sigma 1e-4; W to 1e-5 of its max, MC's at the
   held-out entries: see ``fits_agree``); int8
   losses non-increasing; the int8 and sampled runs' held-out RMSE below W
   = 0's; every mask row with a survivor and summing to 4; every worker's
   launches as its path implies and its history and iterate the same bits
   as worker 0's; each worker's peak device memory and ms an epoch (host
   staging and four processes on one card: not a speedup).
23. The paper's section 3.1 baselines (``core.baselines``) at the ImageNet
   shapes on phase 21's data: NAIVE-DFW and SVA with the line search, 5
   epochs each, then NAIVE on logistic regression (2/(t+2)), 3 epochs: ms an
   epoch split into ``local_grad`` (X^T R, X^T (P - H): plain f32 products),
   the SVD (cuSOLVER) and the update (``rank1_update(_axpy)``); NAIVE's loss
   at each epoch at most 1.10 x DFW-Trace const:1's (the reference's check),
   and logistic regression's final loss below n ln m (phase 4's check);
   ``local_grad`` the same bits twice; matrix completion at 4,800 x 1,777
   with 1M ratings made on the card (the Netflix shapes' dense gradient
   would be 34 GB): ``local_grad`` the same bits twice and the CPU's
   fixed-order sum's, 1e-6 of max from the accumulating scatter, then NAIVE
   5 epochs; launch counts as the path implies.
24. The exchange graphs (``comm.topology``). (a) ``topk:16`` through
   ``fit`` over a one-worker NCCL group against ``fit_serial``, in turns,
   least squares at the ImageNet shapes and matrix completion at the
   Netflix shapes (--mc-int8-epochs): the same bits and launches; ms an
   epoch against phase 21's dense runs; the top-k exchange of MC's 480,189-
   long u. (b) Four gloo workers on the card, as in phase 22: ``ring`` (R = 5
   at N = 4), ``hier:2`` dense, ``hier:2`` + int8 (budget 63) and
   ``topk:16``, on least squares (n = 1,281,164) and matrix completion, each
   against ``fit_serial`` dense on the same data at the reference's own
   tolerances (``graph_agrees``); every worker's launches as its path
   implies, every worker returning worker 0's iterate, and the bytes each
   worker counted per collective equal to the analytic ones exactly (a
   check, not a timing).
25. The block:k solver tier (BlockFW). (a) The block forms of the kernels
   against their plain versions at k = 8 and 32: ``matmat``/``rmatmat`` on R
   and X at n = 1,281,167, ``rankk_update`` and ``rankk_update_axpy`` on R
   (and Y), ``coo_matmat`` (G V, G^T U) and the block ``update_resid`` at the
   Netflix shapes, each against its bound, its plain version and one PyTorch
   call (``A @ V``, ``addmm``, cuSPARSE's CSR SpMM), its bits repeated; the
   block ``update_resid`` and its caller order alone (``update_resid_caller``,
   the line search's) bit for bit; tiny odd shapes at k = 1, 3, 17, 33.
   (b) Full-width fits: least squares ``block:32:adapt`` const:8 with the
   line search (10 epochs), logistic regression ``block:8`` (3 epochs),
   matrix completion ``block:8:adapt`` const:4, dense (10 epochs) and int8
   (5): losses non-increasing (logistic: falling, below n ln m),
   MC's held-out RMSE below W = 0's, executed iterations <= K, launches as
   the path implies; ms an epoch against phases 3 and 8's rank1 epochs. (c)
   ``block:32`` through ``fit`` over one NCCL worker = ``fit_serial``, bits
   and launches. (d) Four gloo workers, ``hier:2`` with ``block:8`` on least
   squares (n = 1,281,164) against ``fit_serial``: loss, final loss and W
   within 1e-4, the counted bytes the analytic ones exactly. (e) The Table-1
   cell of ``benchmarks/block_fw_convergence.py`` made on the card from
   --seed (d = m = 1024, n = 2048, rank-32 truth, 5% of the entries for
   matrix completion, k = 32, budget 160), five problems each: epochs to
   10% of rank1's first gap, rank1 const:2 against ``block:32:adapt``
   const:8 and its ``:cold`` ablation; every block run reaches the target,
   the median speedup must reach 5x (``benchmarks/baselines.json``) and
   each problem's 4.5x.

``--coo-bits PATH`` runs only phases 1 and 6 and then G.v and G^T.u of
``coo_matvec`` at the full shape (x drawn from --seed), saving the results
and their times to PATH; ``--coo-ref`` names such a file from another run
and says whether the bits are the same; ``--src`` imports the port from
another checkout's ``src``, so two versions of the kernel are compared in
one call (old, new, new, old), each on the same data made from --seed.

``--profile`` adds 3-epoch fits of the three tasks, 50 serving dispatches,
one prefill and a short decode of each LM under ``torch.profiler`` (device
time by kernel, the device's idle share); ``--report PATH`` writes every
number to a JSON file. ``--rows``, ``--mc-entries``, ``--lm-batch/--lm-seq/
--lm-layers`` and ``--ssm-batch/--ssm-seq/--ssm-layers`` cut depth
(samples, training ratings, prompts, tokens, layers) for a quick check; the
defaults are the full sizes.

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or run from a directory
without ``src/repro_torch``, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PAPER_N, PAPER_D, PAPER_M = 1_281_167, 2048, 1000
# Netflix Prize shapes: users, movies, training ratings, held-out (probe-size)
# ratings. Popularity exponents: a user (movie) of popularity rank r is drawn
# with probability proportional to (r + 1)^-a; these give a busiest user of
# ~17.7 thousand and a busiest movie of ~235 thousand ratings, as in the
# published data (17,653 and 232,944).
NF_D, NF_M, NF_P, NF_TEST = 480_189, 17_770, 100_480_507, 1_408_395
USER_A, MOVIE_A = 0.375, 0.44
TPU_KERNEL = {
    "matvec": "src/repro/kernels/power_matvec/kernel.py:50",
    "rmatvec": "src/repro/kernels/power_matvec/kernel.py:78",
    "rank1_update": "src/repro/kernels/rank1_update/kernel.py:34",
    "rank1_update_axpy": "src/repro/kernels/rank1_update/kernel.py:62",
    "coo_matvec": "src/repro/kernels/mc_matvec/kernel.py:58",
    "quantize": "src/repro/kernels/quantize/kernel.py:49",
    "dequantize": "src/repro/kernels/quantize/kernel.py:81",
    "factor_matvec": "src/repro/kernels/factor_matvec/kernel.py:59",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:88",
    "wkv6_chunk": "src/repro/kernels/wkv6_chunk/kernel.py:61",
}
# Device µs of the quantize kernel before it took four elements a thread
# (one a thread at every n), at u and v, measured by this script on an NVIDIA
# H100 80GB HBM3 at 700 W; printed beside this run's.
QUANTIZE_SCALAR_US = {"u": 3.09, "v": 1.41}
# Kernels of the port that replace no TPU kernel of their own, with their own
# launch counts: the gather of an MC state's sorted copies and the residual's
# update in each order. They serve the port's coo_matvec, which reads values
# kept in each order's sorted order, so their rows in the kernels line name
# its TPU kernel with "part_of".
HELPER_KERNELS = ("gather_sorted", "update_resid")
# The block:k solver's forms of the kernels above (phase 25), each under the
# TPU kernel the reference vmaps over the k columns; update_resid's block form
# is a route of the update_resid wrapper (its route_launches["block"]), and
# update_resid_caller its caller order alone (the block line search's).
BLOCK_KERNELS = ("matmat", "rmatmat", "rankk_update", "rankk_update_axpy", "coo_matmat",
                 "update_resid_caller")
BLOCK_OF = {"matmat": "matvec", "rmatmat": "rmatvec", "rankk_update": "rank1_update",
            "rankk_update_axpy": "rank1_update_axpy", "coo_matmat": "coo_matvec",
            "update_resid_block": "coo_matvec", "update_resid_caller": "coo_matvec"}
SOURCE = {
    "matvec": "src/repro_torch/csrc/power_matvec.cu",
    "rmatvec": "src/repro_torch/csrc/power_matvec.cu",
    "rank1_update": "src/repro_torch/csrc/rank1_update.cu",
    "rank1_update_axpy": "src/repro_torch/csrc/rank1_update.cu",
    "coo_matvec": "src/repro_torch/csrc/mc_matvec.cu",
    "quantize": "src/repro_torch/csrc/quantize.cu",
    "dequantize": "src/repro_torch/csrc/quantize.cu",
    "factor_matvec": "src/repro_torch/csrc/factor_matvec.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "wkv6_chunk": "src/repro_torch/csrc/wkv6_chunk.cu",
    "gather_sorted": "src/repro_torch/csrc/mc_matvec.cu",
    "update_resid": "src/repro_torch/csrc/mc_matvec.cu",
    "matmat": "src/repro_torch/csrc/power_matvec.cu",
    "rmatmat": "src/repro_torch/csrc/power_matvec.cu",
    "rankk_update": "src/repro_torch/csrc/rank1_update.cu",
    "rankk_update_axpy": "src/repro_torch/csrc/rank1_update.cu",
    "coo_matmat": "src/repro_torch/csrc/mc_matvec.cu",
    "update_resid_block": "src/repro_torch/csrc/mc_matvec.cu",
    "update_resid_caller": "src/repro_torch/csrc/mc_matvec.cu",
}
# Memory rate (bytes/s), f32 non-tensor-core peak, bf16 dense tensor-core
# peak and TF32 dense tensor-core peak (flop/s) of each part this script has
# run on, from NVIDIA's data sheet, keyed by torch.cuda.get_device_name.
# Another part fails the run until its entry is added, so that no bound is
# computed from another card's peaks.
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 989e12, 495e12)}
# Kernel-vs-plain tolerances (max |kernel - plain| / max |plain|): the
# matvecs sum up to 1.28M f32 terms in another order than cuBLAS, and the COO
# matvec segments of up to ~235 thousand terms in another order than the
# atomics of index_add_, factor_matvec its sums in its own order on the tensor
# cores in 3xTF32 (about 2^-20 of each product); the rank-1 update is spelled
# in the plain version's order and should
# match its bits. The quantize pair must match its plain version bit for bit
# (checked with torch.equal, not by this table). Served scores are held to
# x @ W on the card at 1e-4 of max, the serving engine's start-up tolerance.
# flash_attention is held row by row: each query row's max |kernel - plain|
# against that row's own max|plain| (a late causal row averages thousands of
# keys and is far smaller than the first rows, so one max over all rows would
# hide an error there). f32 inputs to 1e-4 (the online softmax sums in
# another order than one softmax over the row); bf16 inputs against the plain
# version on their f32 upcast, to 1e-2, which covers the output's bf16
# rounding only (at most 2^-8 of the row's max). Whole-model checks:
# full-width prefill against token-by-token decode, f32, to 1e-3 of
# max|logits| (28 layers of f32 sums in two orders, the kernel's against the
# plain dense path's); the same in bf16 to 5e-2 (bf16 rounding of every
# activation through 28 layers, taken in two different chains); the smoke
# config's prefill on the card against the CPU, f32, rtol 1e-4 with an atol
# of 1e-5 of max (f32 sums in another order on each side). wkv6_chunk is held
# to its plain chunk form taken in f64 on the same inputs, each (head, row)
# of y to its own max and S_out to its max, 2e-4: the kernel's products in
# 3xTF32 (about 2^-20 of each product) and its prefix sums rounded to f32
# (they run to about -110, where one ulp is 7.6e-6, and the clamped exp
# factors carry that error relatively); at
# q = 32 to the exact recurrence with the JAX package's own f32 test
# tolerance (rtol = atol = 2e-4). The ssm family's whole-model checks use the
# dense family's tolerances above, except prefill against decode in bf16: in
# this random-init 32-layer model bf16 rounding alone moves the logits by
# about 0.14 of their max (bf16 decode, which runs no kernel, against the
# f32 computation on the same weights), so bf16 prefill and decode are held
# to that distance of bf16 decode from f32, measured in the same run (logits
# and every cache), and bf16 prefill's own distance from f32 to 1.25 times
# decode's.
# The block forms (phase 25): matmat/rmatmat and coo_matmat sum in another
# order than cuBLAS and index_add_ (1e-4, as their vector forms); the rank-k
# update's k-term dot is one fmaf chain against the plain version's cuBLAS
# product P Q^T (1e-5 of max); the block update_resid is spelled in its plain
# version's order (bit for bit, torch.equal).
TOL = {"matmat": 1e-4, "rmatmat": 1e-4, "rankk_update": 1e-5, "rankk_update_axpy": 1e-5,
       "coo_matmat": 1e-4,
       "matvec": 1e-4, "rmatvec": 1e-4, "rank1_update": 1e-6, "rank1_update_axpy": 1e-6,
       "coo_matvec": 1e-4, "factor_matvec": 1e-4, "serve": 1e-4,
       "flash_attention": 1e-4, "flash_attention_bf16": 1e-2, "lm_f32": 1e-3, "lm_bf16": 5e-2,
       "lm_card_cpu": 1e-4, "wkv6_chunk": 2e-4, "wkv6_exact": 2e-4, "ssm_bf16_excess": 1.25}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


class Check(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Check(msg)


def card_peaks(name: str):
    check(name in CARD_PEAKS, f"no peak table entry for {name!r}: add its memory rate, "
          "f32, bf16 and TF32 peaks to CARD_PEAKS")
    return CARD_PEAKS[name]


def time_ms(torch, fn, reps: int) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def tree_to(torch, tree, *args):
    """A parameter tree (dicts and lists of tensors) with ``.to(*args)``
    applied to every tensor: another device, or f32 (a bf16 leaf upcast bit
    for bit)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(*args)
    if isinstance(tree, dict):
        return {k: tree_to(torch, v, *args) for k, v in tree.items()}
    return [tree_to(torch, v, *args) for v in tree]


def rel_err(torch, got, want):
    diff = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    return diff, diff / max(scale, 1e-30)


def kernel_phase(torch, pm, r1, dev, X, R, Y, gen, reps, peaks):
    """Every kernel against its plain version at full and tiny odd shapes."""
    bw, flops = peaks[:2]
    n = X.shape[0]
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    g = torch.full((), 0.3, device=dev)
    a, b, c = 1.0 - g, -g, -g * 0.5
    scal2, scal3 = torch.stack([a, b]), torch.stack([a, b, c])
    x_n, y_m = rn(n), rn(PAPER_M)
    out = torch.empty_like(R)

    cases = []  # (kernel, operand, kernel fn, plain fn, library fn, bytes, flops)
    for label, A in (("R", R), ("X", X)):
        rows, cols = A.shape
        v, u = rn(cols), rn(rows)
        cases.append(("matvec", label, lambda A=A, v=v: pm.matvec(A, v),
                      lambda A=A, v=v: pm.ref.matvec(A, v),
                      lambda A=A, v=v: torch.mv(A, v),
                      4 * (rows * cols + rows + cols), 2 * rows * cols))
        cases.append(("rmatvec", label, lambda A=A, u=u: pm.rmatvec(A, u),
                      lambda A=A, u=u: pm.ref.rmatvec(A, u),
                      lambda A=A, u=u: torch.mv(A.t(), u),
                      4 * (rows * cols + rows + cols), 2 * rows * cols))
    nm = n * PAPER_M
    cases.append(("rank1_update", "R",
                  lambda: r1.rank1_update(R, x_n, y_m, a, b, out=out),
                  lambda: r1.ref.rank1_update(R, x_n, y_m, scal2),
                  lambda: torch.addr(R, x_n, y_m, beta=0.7, alpha=-0.3),
                  8 * nm + 4 * (n + PAPER_M), 4 * nm))
    cases.append(("rank1_update_axpy", "R",
                  lambda: r1.rank1_update_axpy(R, Y, x_n, y_m, a, b, c, out=out),
                  lambda: r1.ref.rank1_update_axpy(R, Y, x_n, y_m, scal3),
                  None, 12 * nm + 4 * (n + PAPER_M), 6 * nm))

    rows_out = []
    for name, label, kfn, pfn, lfn, nbytes, nflops in cases:
        got = kfn()
        torch.cuda.synchronize()
        err_abs, err_rel = rel_err(torch, got, pfn())
        check(math.isfinite(err_rel) and err_rel <= TOL[name],
              f"{name} on {label}: max rel err {err_rel:.3e} > {TOL[name]:.0e}")
        del got
        row = dict(
            name=name, operand=label,
            shape=list(R.shape if label == "R" else X.shape),
            max_abs_err=err_abs, max_rel_err=err_rel,
            ms=time_ms(torch, kfn, reps), plain_ms=time_ms(torch, pfn, reps),
            library_ms=time_ms(torch, lfn, reps) if lfn is not None else None,
            bound_ms=1e3 * max(nbytes / bw, nflops / flops),
            bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
            bytes=nbytes,
        )
        if name == "matvec":
            # Against torch.mv in turns (kernel, call, call, kernel): the two
            # are a few percent apart, so neither gets the better place in
            # the run; ms and library_ms are the means of the two rounds.
            lib2, ms2 = time_ms(torch, lfn, reps), time_ms(torch, kfn, reps)
            row.update(ms_rounds=[row["ms"], ms2], library_ms_rounds=[row["library_ms"], lib2],
                       ms=(row["ms"] + ms2) / 2, library_ms=(row["library_ms"] + lib2) / 2)
        if name == "rank1_update_axpy":
            # No single PyTorch call computes it; the shortest chain is three.
            row["library_chain_ms"] = time_ms(
                torch, lambda: torch.mul(R, 0.7).add_(Y, alpha=-0.15).addr_(
                    x_n, y_m, alpha=-0.3), reps)
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
        rows_out.append(row)
        print(f"kernel {name:18s} {label} {tuple(row['shape'])}: {row['ms']:.3f} ms "
              f"(plain {row['plain_ms']:.3f}, library {row['library_ms']}, bound "
              f"{row['bound_ms']:.3f}, {row['GB_per_s']:.0f} GB/s) rel err {err_rel:.2e}")
    del out
    ratio = {r["operand"]: r["ms"] / r["library_ms"] for r in rows_out if r["name"] == "matvec"}
    for r in rows_out:
        if r["name"] == "matvec":
            r["library_ratio"] = ratio[r["operand"]]
            print(f"matvec on {r['operand']}: {r['ms_rounds']} ms against torch.mv's "
                  f"{r['library_ms_rounds']} in turns")
    print("matvec / torch.mv: " + ", ".join(f"{k} {v:.4f}" for k, v in ratio.items()))

    # Tiny odd shapes, 16-byte aligned and not: the ragged and scalar paths.
    for (rows, cols) in ((37, 5), (1, 7), (65, 33), (300, 1000), (9, 1000), (9, 1001)):
        for aligned in (True, False):
            def mk(*s):
                t = rn(math.prod(s) + (0 if aligned else 1))
                return (t if aligned else t[1:]).view(*s)
            A, Y0 = mk(rows, cols), mk(rows, cols)
            v, u, xs, ys = rn(cols), rn(rows), rn(rows), rn(cols)
            pairs = [
                ("matvec", pm.matvec(A, v), pm.ref.matvec(A, v)),
                ("rmatvec", pm.rmatvec(A, u), pm.ref.rmatvec(A, u)),
                ("rank1_update", r1.rank1_update(A, xs, ys, a, b),
                 r1.ref.rank1_update(A, xs, ys, scal2)),
                ("rank1_update_axpy", r1.rank1_update_axpy(A, Y0, xs, ys, a, b, c),
                 r1.ref.rank1_update_axpy(A, Y0, xs, ys, scal3)),
            ]
            torch.cuda.synchronize()
            for name, got, want in pairs:
                err = rel_err(torch, got, want)[1]
                check(err <= TOL[name],
                      f"{name} at {rows}x{cols} aligned={aligned}: rel err {err:.3e}")
    # Determinism: identical bits on repeat.
    u, v = rn(n), rn(PAPER_D)
    check(torch.equal(pm.rmatvec(X, u), pm.rmatvec(X, u)), "rmatvec is not bit-stable")
    check(torch.equal(pm.matvec(X, v), pm.matvec(X, v)), "matvec is not bit-stable")
    print("kernels match their plain versions at full and odd shapes; matvec and rmatvec "
          "bit-stable")
    return rows_out


def planted(torch, gen, dev, d, m, rank=10):
    """W* = U diag(s / sum s) V^T: rank 10, trace norm 1 (examples/quickstart.py)."""
    u = torch.linalg.qr(torch.randn(d, rank, generator=gen, device=dev))[0]
    v = torch.linalg.qr(torch.randn(m, rank, generator=gen, device=dev))[0]
    s = torch.linspace(1.0, 0.1, rank, device=dev)
    return u * (s / s.sum()), v


def dense_data(torch, gen, dev, n):
    """X (n, 2048) standard normal and Y = X W* + 0.01 noise, W* planted."""
    X = torch.randn(n, PAPER_D, generator=gen, device=dev)
    wu, wv = planted(torch, gen, dev, PAPER_D, PAPER_M)
    Y = (X @ wu) @ wv.T
    Y.add_(torch.randn(n, PAPER_M, generator=gen, device=dev), alpha=0.01)
    return X, Y


def planted_labels(torch, gen, dev, X):
    """argmax of X times a planted rank-10 W, with 5% of the labels redrawn."""
    n = X.shape[0]
    W = torch.randn(PAPER_D, 10, generator=gen, device=dev) @ torch.randn(
        10, PAPER_M, generator=gen, device=dev)
    labels = torch.argmax(X @ W, dim=1)
    flip = torch.rand(n, generator=gen, device=dev) < 0.05
    return torch.where(flip, torch.randint(0, PAPER_M, (n,), generator=gen, device=dev), labels)


def segment_timer(torch, log):
    """fit callback: wall time per segment (the callback already syncs)."""
    state = {"t": time.perf_counter()}

    def cb(start, aux):
        now = time.perf_counter()
        live = int(sum(1 for g in aux.gap if g == g))
        log.append(dict(start=start, epochs=live, ms_per_epoch=1e3 * (now - state["t"]) / live))
        state["t"] = now

    return cb


def expected_launches(kind: str, ks, verify: bool, comm: str = "dense"):
    """Launches the path implies: per power iteration, MTLS runs R.v, X^T t,
    X.u and R^T s (2 matvec + 2 rmatvec), logistic X^T (Pv - v_y) and X.u
    (1 + 1), matrix completion G.v and G^T.u (2 coo_matvec); each dense-task
    epoch adds the update's X.u (and, for MTLS, the line search's) and one
    rank-1 update; each MC state built (the fit's, and verify_kernelized's)
    gathers the residual, values, weights and gather index into the row and
    the column order (2 gather_sorted, one record gather per order), and
    each MC epoch's update writes the residual in all three orders (1
    update_resid). Under int8 every exchange (2 per iteration) is
    one quantize and one dequantize. verify_kernelized runs one iteration's
    worth of matvecs before the fit, and verify_quantize_kernels one pair."""
    iters = sum(ks) + (1 if verify else 0)
    e = len(ks)
    want = dict.fromkeys((*TPU_KERNEL, *HELPER_KERNELS, *BLOCK_KERNELS), 0)
    if kind == "mc":
        want["coo_matvec"] = 2 * iters
        want["gather_sorted"] = 2 * (1 + (1 if verify else 0))
        want["update_resid"] = e
    else:
        per_iter = 2 if kind == "mtls" else 1
        want["matvec"] = per_iter * iters + (2 * e if kind == "mtls" else e)
        want["rmatvec"] = per_iter * iters
        want["rank1_update" if kind == "logistic" else "rank1_update_axpy"] = e
    if comm == "int8":
        want["quantize"] = want["dequantize"] = 2 * sum(ks) + (1 if verify else 0)
    return want


def run_path(torch, kernels, dfw, kind, task, X, target, cfg, seed, dev):
    kernels.reset_launches()
    seg_log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dfw.fit_serial(task, X, target, cfg=cfg, key=seed, device=dev,
                         callback=segment_timer(torch, seg_log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    want = expected_launches(kind, res.history["k"], cfg.verify_kernels, cfg.comm)
    check(launches == want, f"{kind}/{cfg.comm}: launches {launches} != expected {want}")
    loss = res.history["loss"]
    check(res.epochs_run == cfg.num_epochs, f"{kind}: ran {res.epochs_run} epochs")
    check(all(math.isfinite(v) for v in loss + [res.final_loss]), f"{kind}: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{kind}/{cfg.comm}: {res.epochs_run} epochs in {wall:.2f} s, peak device memory "
          f"{peak:.2f} GB, launches {launches}")
    for s in seg_log:
        print(f"  {kind} segment from epoch {s['start']} (K={res.history['k'][s['start']]}): "
              f"{s['epochs']} epochs, {s['ms_per_epoch']:.2f} ms/epoch")
    print(f"  {kind} loss: " + ", ".join(f"{v:.6g}" for v in loss)
          + f"; final {res.final_loss:.6g}")
    return res, launches, dict(wall_s=wall, segments=seg_log, loss=loss, ks=res.history["k"],
                               final_loss=res.final_loss, launches=launches, peak_gb=peak)


def expected_block_launches(kind: str, piters, verify: bool, comm: str = "dense",
                            linesearch: bool = True):
    """Launches a block:k fit implies, from its executed power iterations
    ``piters`` (one an epoch): per iteration MTLS runs R V, X U (2 matmat)
    and X^T (R V), R^T (X U) (2 rmatmat), logistic X U and X^T (P V - V_y)
    (1 + 1), matrix completion G V and G^T U (2 coo_matmat); each epoch adds
    the update's X U (MTLS: and the line search's) and one rank-k update
    (MC: one update_resid on its block route, and one update_resid_caller
    for the line search's entry values); verify_kernelized runs one
    iteration's worth of the vector forms and one of the block forms, and
    each MC state built gathers its copies (2 gather_sorted). int8: a
    quantize and a dequantize each exchange, one pair in the start-up
    check."""
    iters, e = int(sum(piters)), len(piters)
    want = dict.fromkeys((*TPU_KERNEL, *HELPER_KERNELS, *BLOCK_KERNELS), 0)
    v = 1 if verify else 0
    if kind == "mc":
        want.update(coo_matmat=2 * iters + 2 * v, coo_matvec=2 * v,
                    gather_sorted=2 * (1 + v), update_resid=e,
                    update_resid_caller=e if linesearch else 0)
    else:
        per_iter = 2 if kind == "mtls" else 1
        want.update(matvec=per_iter * v, rmatvec=per_iter * v,
                    matmat=per_iter * (iters + v) + e * (2 if linesearch else 1),
                    rmatmat=per_iter * (iters + v))
        want["rankk_update_axpy" if kind == "mtls" else "rankk_update"] = e
    if comm == "int8":
        want["quantize"] = want["dequantize"] = 2 * iters + v
    return want


PORT_KERNELS = ("matvec_kernel", "rmatvec_partial_kernel", "rmatvec_finish_kernel",
                "rank1_kernel", "piece_sum_kernel", "segment_sum_kernel", "gather_word_kernel",
                "pack_records_kernel", "gather_records_kernel", "update_resid_kernel",
                "quantize_kernel", "dequantize_kernel", "factor_matvec_kernel",
                # the block:k solver's forms
                "matmat_kernel", "rmatmat_partial_kernel", "rmatmat_finish_kernel",
                "rankk_kernel", "piece_sum_block_kernel", "segment_sum_block_kernel",
                "update_resid_block_kernel")
RECORD_KERNELS = ("pack_records_kernel", "gather_records_kernel")  # the state build's copies


def is_kernel(part: str, key: str) -> bool:
    """Whether the profiler's kernel name ``key`` is the kernel ``part`` (a
    whole word: quantize_kernel is not dequantize_kernel)."""
    return re.search(rf"\b{part}\b", key) is not None
FLASH_KERNELS = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")  # the two routes


def profile_fit(torch, kind, run):
    """Device time by kernel over a short fit ``run()`` under torch.profiler:
    the port's kernels against everything else (plain PyTorch and cuBLAS),
    and the device's busy share of the wall time (the profiler's own
    overhead is inside that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels_us, calls = {}, {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels_us[ev.key] = kernels_us.get(ev.key, 0.0) + ev.self_device_time_total
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    port = sum(t for k, t in kernels_us.items() if any(is_kernel(p, k) for p in PORT_KERNELS))
    # device time per launch of each port kernel (the CUDA-event times of the
    # kernel phase include the host's launch overhead for short kernels)
    per_launch_us = {p: (sum(t for k, t in kernels_us.items() if is_kernel(p, k))
                         / max(1, sum(c for k, c in calls.items() if is_kernel(p, k))))
                     for p in PORT_KERNELS if any(is_kernel(p, k) for k in kernels_us)}
    # device time of each port kernel (for MC: the update's, update_resid,
    # apart from the plain passes of the loss and the line search in "other")
    port_ms = {p: sum(t for k, t in kernels_us.items() if is_kernel(p, k)) / 1e3
               for p in per_launch_us}
    busy = sum(kernels_us.values())
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]
    out = dict(epochs=res.epochs_run, ks=res.history["k"], wall_ms=wall_us / 1e3,
               device_busy_ms=busy / 1e3, port_kernels_ms=port / 1e3,
               other_kernels_ms=(busy - port) / 1e3,
               idle_share=1.0 - busy / wall_us if busy else None,
               top=[(k[:90], t / 1e3) for k, t in top], port_us_per_launch=per_launch_us,
               port_ms=port_ms)
    if busy:
        print(f"profile {kind} ({res.epochs_run} epochs, K={res.history['k']}): wall "
              f"{out['wall_ms']:.1f} ms, device busy {out['device_busy_ms']:.1f} ms (port "
              f"kernels {out['port_kernels_ms']:.1f}, other {out['other_kernels_ms']:.1f}), "
              f"idle share {out['idle_share']:.3f}")
        for k, t in out["top"]:
            print(f"  {t:9.2f} ms  {k}")
        print("  device us per launch: " + ", ".join(
            f"{k} {v:.2f}" for k, v in per_launch_us.items()))
        print("  device ms by port kernel: " + ", ".join(
            f"{k} {v:.3f}" for k, v in port_ms.items())
              + f"; other (plain PyTorch, cuBLAS) {out['other_kernels_ms']:.3f}")
    else:
        print(f"profile {kind}: the profiler recorded no device time (not measured)")
    return out


def small_parity(torch, np, V0Stream, dfw, tasks, dev):
    """The same small fits on the card (kernels) and on the CPU (plain
    versions), same data and start vectors: histories agree to rtol 1e-4."""
    rng = np.random.default_rng(0)
    n, d, m = 700, 48, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, 5)) @ rng.standard_normal((5, m)) / 50
    y = (x @ w + 0.01 * rng.standard_normal((n, m))).astype(np.float32)
    labels = np.argmax(x @ w, axis=1)
    table = rng.standard_normal((12, m)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    for kind, target, kw in (
        ("mtls", y, dict(mu=1.0, num_epochs=12, schedule="log", step_size="linesearch")),
        ("logistic", labels, dict(mu=5.0, num_epochs=12, schedule="log_half")),
    ):
        task = (tasks.MultiTaskLeastSquares if kind == "mtls" else tasks.MultinomialLogistic)(d, m)
        runs = [dfw.fit_serial(task, x, target, cfg=dfw.DFWConfig(**kw),
                               key=V0Stream.from_table(table), device=where)
                for where in (dev, "cpu")]
        for name in ("loss", "gap", "sigma", "gamma"):
            got, want = np.array(runs[0].history[name]), np.array(runs[1].history[name])
            err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max()))
            check(err <= 1e-4, f"small {kind} {name}: card vs CPU rel err {err:.2e}")
        print(f"small {kind} fit: card matches CPU (rtol 1e-4)")


def popularity_draw(torch, gen, dev, n_ids, a, count, chunk=1 << 24):
    """``count`` ids in [0, n_ids), id of popularity rank r drawn with
    probability proportional to (r + 1)^-a (searchsorted on an f64 table);
    ranks are mapped to ids by a random permutation."""
    w = (torch.arange(n_ids, device=dev, dtype=torch.float64) + 1.0) ** -a
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    ids = torch.randperm(n_ids, generator=gen, device=dev).to(torch.int32)
    out = torch.empty(count, dtype=torch.int32, device=dev)
    for lo in range(0, count, chunk):
        hi = min(count, lo + chunk)
        r = torch.rand(hi - lo, generator=gen, device=dev, dtype=torch.float64)
        out[lo:hi] = ids[torch.searchsorted(cdf, r).clamp_(max=n_ids - 1)]
    return out


def make_mc_data(torch, gen, dev, p, p_test, d=NF_D, m=NF_M, rank=10, chunk=1 << 24):
    """Ratings at the Netflix shapes, on the card: (idx, yw) of the training
    entries (``tasks.pack_observations`` layout), the held-out entries, and
    mu = the planted matrix's trace norm. M = U V^T / sqrt(rank) with
    Gaussian U (d, rank), V (m, rank) has unit-variance entries; each rating
    is M_ij plus Gaussian noise of std 0.1. Duplicates are kept (the task
    sums them)."""
    total = p + p_test
    rows = popularity_draw(torch, gen, dev, d, USER_A, total)
    cols = popularity_draw(torch, gen, dev, m, MOVIE_A, total)
    U = torch.randn(d, rank, generator=gen, device=dev)
    V = torch.randn(m, rank, generator=gen, device=dev)
    vals = torch.empty(total, dtype=torch.float32, device=dev)
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        planted = (U[rows[lo:hi]] * V[cols[lo:hi]]).sum(1) / math.sqrt(rank)
        vals[lo:hi] = planted + 0.1 * torch.randn(hi - lo, generator=gen, device=dev)
    ru = torch.linalg.qr(U.double())[1]
    rv = torch.linalg.qr(V.double())[1]
    mu = float(torch.linalg.svdvals(ru @ rv.T).sum()) / math.sqrt(rank)
    idx = torch.stack([rows[:p], cols[:p]], dim=1)
    yw = torch.stack([vals[:p], torch.ones(p, device=dev)], dim=1)
    test = (rows[p:].clone(), cols[p:].clone(), vals[p:].clone())
    del rows, cols, vals
    return idx, yw, test, mu


def mc_stats(torch, idx, d, m):
    """Busiest user and movie, empty users and movies, duplicate entries."""
    rows, cols = idx[:, 0], idx[:, 1]
    rdeg = torch.bincount(rows, minlength=d)
    cdeg = torch.bincount(cols, minlength=m)
    key = torch.sort(rows.long() * m + cols.long()).values
    dups = int((key[1:] == key[:-1]).sum())
    return dict(max_user=int(rdeg.max()), max_movie=int(cdeg.max()),
                mean_user=float(rdeg.float().mean()), mean_movie=float(cdeg.float().mean()),
                empty_users=int((rdeg == 0).sum()), empty_movies=int((cdeg == 0).sum()),
                duplicates=dups)


def coo_bits_phase(torch, mc, tasks, dev, gen, args):
    """--coo-bits: G.v and G^T.u of coo_matvec at the full MC shape, on
    whichever version of the port was imported (values in caller order for
    a version without gather_sorted, else the state's sorted copies), saved
    with their times; compared bit for bit with --coo-ref if given."""
    idx, yw, _, _ = make_mc_data(torch, gen, dev, args.mc_entries, NF_TEST, d=NF_D, m=NF_M)
    state = tasks.MatrixCompletion(NF_D, NF_M).init_state(idx, yw)
    del idx, yw
    sorted_copies = hasattr(mc, "gather_sorted")
    xs = {"G.v": torch.randn(NF_M, generator=gen, device=dev),
          "G^T.u": torch.randn(NF_D, generator=gen, device=dev)}
    saved, res = {}, dict(version="sorted copies" if sorted_copies else "read through perm")
    for label, order, copy in (("G.v", state.by_row, "resid_by_row"),
                               ("G^T.u", state.by_col, "resid_by_col")):
        vals = getattr(state, copy) if sorted_copies else state.resid
        x = xs[label]
        saved[label] = mc.coo_matvec(order, vals, x).cpu()
        res[f"{label} ms"] = time_ms(torch, lambda: mc.coo_matvec(order, vals, x), args.reps)
    torch.save(saved, args.coo_bits)
    if args.coo_ref:
        ref = torch.load(args.coo_ref)
        res["same_bits_as_ref"] = all(torch.equal(saved[k], ref[k]) for k in saved)
    print(f"coo_matvec ({res['version']}): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in res.items()
        if k != "version"))
    return res


def state_build_phase(torch, task, idx, yw):
    """The MC state build: the wall time of ``init_state`` (host clock to a
    sync), then a second build under torch.profiler for the device time of
    its parts: the two stable sorts (the sort kernels), the copies' record
    gathers (pack and gather, both orders) and the rest of the orders'
    pieces (the range check, counts, prefix sums, piece tables, casts and
    init_state's field copies). Returns the first state and the numbers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = task.init_state(idx, yw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = task.init_state(idx, yw)
        torch.cuda.synchronize()
    del again
    ms = dict(sort_ms=0.0, pack_ms=0.0, gather_ms=0.0, other_ms=0.0)
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        t = ev.self_device_time_total / 1e3
        part = ("pack_ms" if is_kernel("pack_records_kernel", ev.key) else
                "gather_ms" if is_kernel("gather_records_kernel", ev.key) else
                "sort_ms" if "sort" in ev.key.lower() else "other_ms")
        ms[part] += t
    out = dict(wall_s=wall, copies_ms=ms["pack_ms"] + ms["gather_ms"], **ms)
    out["device_ms"] = out["copies_ms"] + ms["sort_ms"] + ms["other_ms"]
    print(f"mc state with its row and column orders built in {wall:.4f} s; device time of a "
          f"second build {out['device_ms']:.3f} ms: the two sorts {ms['sort_ms']:.3f}, the "
          f"copies' record gathers {out['copies_ms']:.3f} (pack {ms['pack_ms']:.3f}, gather "
          f"{ms['gather_ms']:.3f}), the rest of the pieces {ms['other_ms']:.3f}")
    return state, out


def check_state_copies(torch, state, where):
    """An MC state's six sorted copies (resid, vals, weight in the row and
    the column order) and both orders' gat_sorted equal field[perm], bit for
    bit (torch.equal)."""
    fields = dict(resid=state.resid, vals=state.vals, weight=state.weight)
    for tag, order, gat in (("row", state.by_row, state.cols), ("col", state.by_col, state.rows)):
        perm64 = order.perm.long()
        for name, t in fields.items():
            check(torch.equal(getattr(state, f"{name}_by_{tag}"), t[perm64]),
                  f"the state {where}: {name}_by_{tag} is not {name}[perm]")
        check(torch.equal(order.gat_sorted, gat[perm64]),
              f"the state {where}: the {tag} order's gat_sorted is not gat[perm]")
        del perm64


def record_gather_row(torch, mc, state, rows_out, reps, bw):
    """The record gather of a state's copies, both orders (what
    ``mc_state`` launches: resid, vals, weight and the order's gather index
    per order), against field[perm] bit for bit, timed (CUDA events; the
    pack's and the gather's device time from the profiler) beside its bound,
    the random-access floor, the plain version and the chain of four
    index_select calls per order (no one PyTorch call gathers four fields).
    Bound: both orders read perm (8 bytes) and the five caller fields once
    (20) and write 2 x 16 bytes: 60 bytes an entry. Random-access floor: one
    32-byte sector per entry per order at the rate of random sectors of the
    one-field gather rows in ``rows_out`` (p random 4-byte reads and 8
    sequential bytes an entry), alone and with the record route's
    sequential passes (per order: the pack reads 16 and writes 16 bytes an
    entry, the gather reads perm and writes 16)."""
    p = state.resid.numel()
    orders = ((state.by_row, state.cols), (state.by_col, state.rows))

    def fields(gat):
        return (state.resid, state.vals, state.weight, gat)

    def records():
        return [mc.gather_sorted_fields(order, fields(gat)) for order, gat in orders]

    got = records()
    torch.cuda.synchronize()
    for (order, gat), copies in zip(orders, got):
        perm64 = order.perm.long()
        for name, t, c in zip(("resid", "vals", "weight", "gat"), fields(gat), copies):
            check(torch.equal(c, t[perm64]), f"the record gather's {name} is not {name}[perm]")
    del got, perm64
    perms = [order.perm.long() for order, _ in orders]

    def chain():
        return [[torch.index_select(t, 0, pm) for t in fields(gat)]
                for pm, (_, gat) in zip(perms, orders)]

    def plain():
        return [[mc.ref.gather_sorted(order.perm, t) for t in fields(gat)] for order, gat in orders]

    one_ms = statistics.mean(r["ms"] for r in rows_out if r["name"] == "gather_sorted")
    sector_rate = p / ((one_ms - 1e3 * 8 * p / bw) / 1e3)
    nbytes = 60 * p
    row = dict(name="gather_sorted", main=True,
               operand="resid, vals, weight, gat -> row and column order (a state's copies)",
               shape=[p], max_abs_err=0.0, max_rel_err=0.0, bits_identical=True,
               ms=time_ms(torch, records, reps),
               device_pack_ms=device_ms(torch, records, "pack_records_kernel", n=5),
               device_gather_ms=device_ms(torch, records, "gather_records_kernel", n=5),
               plain_ms=time_ms(torch, plain, reps), library_ms=None,
               library_chain_ms=time_ms(torch, chain, reps),
               bound_ms=1e3 * nbytes / bw, bound_by="bytes", bytes=nbytes,
               random_sectors_per_s=sector_rate, random_floor_ms=1e3 * 2 * p / sector_rate,
               random_floor_with_passes_ms=1e3 * (2 * p / sector_rate + 2 * 52 * p / bw))
    del perms
    print(f"kernel gather_sorted, record gather of both orders ({p} entries, 4 fields): "
          f"{row['ms']:.3f} ms (device: pack {fmt_ms(row['device_pack_ms'])}, gather "
          f"{fmt_ms(row['device_gather_ms'])}; plain {row['plain_ms']:.3f}, index_select chain "
          f"{row['library_chain_ms']:.3f}, bound {row['bound_ms']:.3f}, random-access floor "
          f"{row['random_floor_ms']:.3f} at {sector_rate:.4g} random sectors/s, with the "
          f"sequential passes {row['random_floor_with_passes_ms']:.3f}), bits identical to "
          f"field[perm]")
    return row


def mc_kernel_phase(torch, mc, qz, dev, state, gen, reps, peaks):
    """coo_matvec (G.v along the row order, G^T.u along the column order, on
    the residual's copies in those orders) and the quantize pair against
    their plain versions at the MC shapes and at tiny odd shapes; times of
    kernel, plain version and library call (the quantize pair also by
    device time); the state's sorted copies and gather indices against
    field[perm], bit for bit, and the time of the record gather that builds
    them (both orders) against its bound, the random-access floor and the
    index_select chain; the one-field gather's time and bits."""
    bw, flops = peaks[:2]
    d, m = state.by_row.out_dim, state.by_col.out_dim
    p = state.resid.numel()
    vals = state.resid
    rows_out = []
    check_state_copies(torch, state, f"at {d} x {m}, {p} entries")
    print("the state's eight sorted copies and both orders' gat_sorted are field[perm], bit "
          "for bit")
    for label, order, sorted_vals, seg, gat, in_dim in (
            ("G.v", state.by_row, state.resid_by_row, state.rows, state.cols, m),
            ("G^T.u", state.by_col, state.resid_by_col, state.cols, state.rows, d)):
        out_dim = order.out_dim
        x = torch.randn(in_dim, generator=gen, device=dev)
        # the gather that builds the copies: vals[perm], bit for bit; its bound
        # reads perm and the values and writes the copy once (12 bytes an entry)
        check(torch.equal(sorted_vals, vals[order.perm.long()]),
              f"the residual's copy for {label} is not resid[perm]")
        fresh = mc.gather_sorted(order, vals)
        torch.cuda.synchronize()
        check(torch.equal(fresh, sorted_vals), f"gather_sorted for {label} is not resid[perm]")
        perm64 = order.perm.long()
        gbytes = 12 * p
        grow = dict(name="gather_sorted", operand=f"resid, {label} order", shape=[p],
                    max_abs_err=0.0, max_rel_err=0.0, bits_identical=True,
                    ms=time_ms(torch, lambda: mc.gather_sorted(order, vals), reps),
                    plain_ms=time_ms(torch, lambda: mc.ref.gather_sorted(order.perm, vals), reps),
                    library_ms=time_ms(torch, lambda: torch.index_select(vals, 0, perm64), reps),
                    bound_ms=1e3 * gbytes / bw, bound_by="bytes", bytes=gbytes)
        rows_out.append(grow)
        print(f"kernel gather_sorted ({label} order, {p} entries): {grow['ms']:.3f} ms (plain "
              f"{grow['plain_ms']:.3f}, index_select {grow['library_ms']:.3f}, bound "
              f"{grow['bound_ms']:.3f}), bits identical to resid[perm]")
        del fresh, perm64
        # cuSPARSE CSR SpMV on the same function; building the CSR tensor
        # (the values in sorted order) is set-up and not timed.
        csr = torch.sparse_csr_tensor(order.seg_ptr.to(torch.int32), order.gat_sorted,
                                      sorted_vals, size=(out_dim, in_dim))
        got = mc.coo_matvec(order, sorted_vals, x)
        torch.cuda.synchronize()
        want = mc.ref.coo_matvec(seg, gat, vals, x, out_dim)
        err_abs, err_rel = rel_err(torch, got, want)
        check(math.isfinite(err_rel) and err_rel <= TOL["coo_matvec"],
              f"coo_matvec {label}: max rel err {err_rel:.3e} > {TOL['coo_matvec']:.0e}")
        check(torch.equal(mc.coo_matvec(order, sorted_vals, x), got),
              f"coo_matvec {label} is not bit-stable")
        lib_err = rel_err(torch, torch.mv(csr, x), want)[1]
        nbytes = 8 * p + 4 * (in_dim + out_dim)
        row = dict(name="coo_matvec", operand=label, shape=[out_dim, in_dim, p],
                   max_abs_err=err_abs, max_rel_err=err_rel, library_rel_err=lib_err,
                   ms=time_ms(torch, lambda: mc.coo_matvec(order, sorted_vals, x), reps),
                   plain_ms=time_ms(torch, lambda: mc.ref.coo_matvec(
                       seg, gat, vals, x, out_dim), reps),
                   library_ms=time_ms(torch, lambda: torch.mv(csr, x), reps),
                   bound_ms=1e3 * max(nbytes / bw, 2 * p / flops),
                   bound_by="bytes" if nbytes / bw >= 2 * p / flops else "operations",
                   bytes=nbytes, pieces=int(order.piece_start.numel()))
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
        rows_out.append(row)
        print(f"kernel coo_matvec {label} ({out_dim} x {in_dim}, {p} entries, "
              f"{row['pieces']} pieces): {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"library {row['library_ms']:.3f}, bound {row['bound_ms']:.3f}) rel err "
              f"{err_rel:.2e} (cuSPARSE {lib_err:.2e}), bit-stable")
        del csr, got, want

    rows_out.append(record_gather_row(torch, mc, state, rows_out, reps, bw))

    for label, n in (("u", d), ("v", m)):
        x = torch.randn(n, generator=gen, device=dev)
        noise = torch.rand(n, generator=gen, device=dev)
        scale = torch.max(torch.abs(x))
        q = qz.quantize(x, noise, scale, budget=127)
        y = qz.dequantize(q, scale, budget=127)
        torch.cuda.synchronize()
        check(torch.equal(q, qz.ref.quantize(x, noise, scale, 127)),
              f"quantize ({label}, {n}) differs from its plain version")
        check(torch.equal(y, qz.ref.dequantize(q, scale, 127)),
              f"dequantize ({label}, {n}) differs from its plain version")
        for name, kfn, pfn, nbytes in (
            ("quantize", lambda: qz.quantize(x, noise, scale, budget=127),
             lambda: qz.ref.quantize(x, noise, scale, 127), 9 * n + 4),
            ("dequantize", lambda: qz.dequantize(q, scale, budget=127),
             lambda: qz.ref.dequantize(q, scale, 127), 5 * n + 4),
        ):
            row = dict(name=name, operand=f"{label} ({n},)", shape=[n], max_abs_err=0.0,
                       max_rel_err=0.0, ms=time_ms(torch, kfn, reps),
                       device_ms=device_ms(torch, kfn, f"{name}_kernel"),
                       plain_ms=time_ms(torch, pfn, reps), library_ms=None,
                       bound_ms=1e3 * max(nbytes / bw, 4 * n / flops),
                       bound_by="bytes" if nbytes / bw >= 4 * n / flops else "operations",
                       bytes=nbytes)
            rows_out.append(row)
            before = (f"; the one-element-a-thread kernel: {QUANTIZE_SCALAR_US[label]} µs"
                      if name == "quantize" else "")
            print(f"kernel {name} {label} ({n},): {row['ms']:.4f} ms, device "
                  f"{fmt_ms(row['device_ms'], 5)} ms (plain {row['plain_ms']:.4f}, bound "
                  f"{row['bound_ms']:.5f}{before}), bit-identical")
        for b in (31, 1):  # four workers' budget, and the coarsest
            check(torch.equal(qz.quantize(x, noise, scale, budget=b),
                              qz.ref.quantize(x, noise, scale, b)),
                  f"quantize ({label}, {n}) at budget {b} differs from its plain version")

    # tiny odd shapes: empty segments, one-entry and multi-piece segments,
    # zero-weight padding (exactly the same bits with and without it)
    for (dd, mm, pp) in ((3, 5, 7), (1, 1, 1), (37, 2, 3000), (500, 41, 1), (64, 1000, 2049)):
        r = torch.randint(0, dd, (pp,), generator=gen, device=dev, dtype=torch.int32)
        c = torch.randint(0, mm, (pp,), generator=gen, device=dev, dtype=torch.int32)
        vv = torch.randn(pp, generator=gen, device=dev)
        xv, xu = torch.randn(mm, generator=gen, device=dev), torch.randn(dd, generator=gen,
                                                                         device=dev)
        zero = torch.zeros(5, dtype=torch.int32, device=dev)
        for seg, gat, od, idim, x in ((r, c, dd, mm, xv), (c, r, mm, dd, xu)):
            order = mc.build_order(seg, gat, od, idim)
            copy = mc.gather_sorted(order, vv)
            check(torch.equal(copy, vv[order.perm.long()]),
                  f"gather_sorted at {od}x{idim}, {pp} entries is not vals[perm]")
            got = mc.coo_matvec(order, copy, x)
            err = rel_err(torch, got, mc.ref.coo_matvec(seg, gat, vv, x, od))[1]
            check(err <= TOL["coo_matvec"], f"coo_matvec at {od}x{idim}, {pp} entries: {err:.3e}")
            padded = mc.build_order(torch.cat([seg, zero]), torch.cat([gat, zero]), od, idim)
            padded_vals = torch.cat([vv, torch.zeros(5, device=dev)])
            check(torch.equal(mc.coo_matvec(padded, mc.gather_sorted(padded, padded_vals), x),
                              got), f"coo_matvec at {od}x{idim}: padding changed bits")
    for n in (1, 15, 16, 17, 37, 1000, 135_167, 135_168, 135_171):
        for b in (1, 15, 31, 127):
            x = torch.randn(n, generator=gen, device=dev)
            grid = (torch.arange(n, device=dev) % (2 * b + 1) - b).float() * (2.5 / b)
            scale = torch.full((), 2.5, device=dev)
            for xs, ns in ((x, torch.rand(n, generator=gen, device=dev)),
                           (grid, torch.zeros(n, device=dev)), (grid, torch.full((n,), 0.5,
                                                                                  device=dev))):
                q = qz.quantize(xs, ns, scale, budget=b)
                q_off = torch.empty(n + 1, dtype=torch.int8, device=dev)[1:]  # one byte off
                q_off.copy_(q)
                check(torch.equal(q, qz.ref.quantize(xs, ns, scale, b))
                      and torch.equal(qz.dequantize(q, scale, budget=b),
                                      qz.ref.dequantize(q, scale, b))
                      and torch.equal(qz.dequantize(q_off, scale, budget=b),
                                      qz.ref.dequantize(q, scale, b)),
                      f"quantize pair at n={n}, budget={b} differs from its plain version")
    print("coo_matvec matches its plain version at full and odd shapes, bit-stable, padding "
          "changes no bit; gather_sorted is vals[perm] bit for bit; quantize/dequantize "
          "bit-identical to their plain versions (odd n, q aligned and one byte off)")
    return rows_out


def update_resid_phase(torch, mc, tasks, dev, state, mu, gen, reps, peaks):
    """update_resid (through MatrixCompletion.update) against the update's
    plain chain followed by gather_sorted, bit for bit, at the MC shape and
    at tiny odd ones, with gamma from the line search's clamp and from the
    2/(t+2) schedule, and mu as given and 0; its time against that chain
    and the two gathers, and its bound: 64 bytes an entry (24 in caller
    order, 20 in each sorted order)."""
    d, m = state.by_row.out_dim, state.by_col.out_dim
    p = state.resid.numel()

    def unit(n):
        x = torch.randn(n, generator=gen, device=dev)
        return x / x.norm()

    gammas = {
        "line search": torch.clamp(torch.rand((), generator=gen, device=dev) / torch.clamp(
            torch.rand((), generator=gen, device=dev) + 0.5, min=1e-30), 0.0, 1.0),
        "2/(t+2)": 2.0 / (torch.full((), 7.0, device=dev) + 2.0),
    }

    def held(st, u, v, where):
        for label, gamma in gammas.items():
            for mu_ in (mu, 0.0):
                got = tasks.MatrixCompletion(st.by_row.out_dim, st.by_col.out_dim).update(
                    st, u, v, gamma, mu_)
                want = mc.ref.resid_step(gamma, mu_, st.resid, st.vals, st.weight, u[st.rows],
                                         v[st.cols])
                torch.cuda.synchronize()
                for name, a, b in (("caller", got.resid, want),
                                   ("row", got.resid_by_row, mc.gather_sorted(st.by_row, want)),
                                   ("column", got.resid_by_col, mc.gather_sorted(st.by_col, want))):
                    check(torch.equal(a, b), f"update_resid {where}, {name} order, gamma from "
                          f"{label}, mu {mu_:g}: not the chain's bits")
                del got, want

    u, v = unit(d), unit(m)
    held(state, u, v, f"at {d} x {m}, {p} entries")
    gamma = gammas["line search"]

    def plain():
        want = mc.ref.resid_step(gamma, mu, state.resid, state.vals, state.weight,
                                 u[state.rows], v[state.cols])
        return want, mc.gather_sorted(state.by_row, want), mc.gather_sorted(state.by_col, want)

    nbytes = 64 * p
    row = dict(name="update_resid", operand=f"resid in three orders, {p} entries",
               shape=[d, m, p], max_abs_err=0.0, max_rel_err=0.0, bits_identical=True,
               ms=time_ms(torch, lambda: tasks.MatrixCompletion(d, m).update(
                   state, u, v, gamma, mu), reps),
               plain_ms=time_ms(torch, plain, reps), library_ms=None,
               bound_ms=1e3 * nbytes / peaks[0], bound_by="bytes", bytes=nbytes)
    print(f"kernel update_resid ({p} entries, caller, row and column order): {row['ms']:.3f} ms "
          f"(plain chain and two gathers {row['plain_ms']:.3f}, bound {row['bound_ms']:.3f}), "
          f"bits identical to the chain followed by gather_sorted")
    # tiny odd shapes: empty rows and columns, one entry, zero-weight entries
    for (dd, mm, pp) in ((3, 5, 7), (1, 1, 1), (37, 2, 3000), (500, 41, 1), (64, 1000, 2049)):
        r = torch.randint(0, dd, (pp,), generator=gen, device=dev, dtype=torch.int32)
        c = torch.randint(0, mm, (pp,), generator=gen, device=dev, dtype=torch.int32)
        w = (torch.rand(pp, generator=gen, device=dev) < 0.8).float()
        st = tasks.mc_state(r, c, torch.randn(pp, generator=gen, device=dev),
                            w * torch.randn(pp, generator=gen, device=dev), w, dd, mm)
        check_state_copies(torch, st, f"at {dd} x {mm}, {pp} entries")
        held(st, unit(dd), unit(mm), f"at {dd} x {mm}, {pp} entries")
    print("update_resid gives the chain's bits followed by gather_sorted in all three orders, "
          "at the full and the odd shapes, gamma from both sources, mu and 0; the odd shapes' "
          "states hold their copies and gather indices as field[perm], bit for bit")
    return [row]


class RecordingInt8:
    """An int8 reducer that keeps, per exchange, the pre-floor values
    x * inv + noise and the integers (host copies; small fits only)."""

    def __init__(self, comm, qref, torch):
        self.inner, self.qref, self.torch, self.log = comm.Int8Reducer(1), qref, torch, []
        self.spec = "int8"

    def init_state(self, d, m, device=None):
        return ()

    def wire_bytes(self, dim, num_workers):
        return self.inner.wire_bytes(dim, num_workers)

    def exchange(self, x, state, *, slot, noise=None, weight=None):
        torch, b = self.torch, self.inner.budget
        nz = noise(x.shape[0], x.device)
        scale = torch.max(torch.abs(x))
        pre = x * (torch.full_like(scale, float(b)) / (scale + 1e-30)) + nz
        q = self.qref.quantize(x, nz, scale, b)
        self.log.append((pre.cpu().numpy(), q.cpu().numpy()))
        return self.inner.exchange(x, state, slot=slot, noise=lambda n, dev: nz)


def mc_small_parity(torch, np, V0Stream, NoiseStream, comm, qref, dfw, fw, tasks, dev):
    """Small MC fits, dense and int8, on the card and on the CPU with the
    same data, start vectors and noise. Dense: histories agree to rtol 1e-4.
    int8: the same, unless a sum taken in another order moved one value
    x * inv + noise across an integer, so that one q differs by one grid
    step; then the check shows that it is exactly that (|dq| <= 1 where the
    two pre-floor values straddle an integer, both within 1e-3 of each
    other), holds the epochs before it to rtol 1e-4, and the final loss to
    1e-2 (one grid step is 1/127 of the largest element of one vector)."""
    rng = np.random.default_rng(1)
    d, m, p, epochs = 300, 200, 20000, 12
    u0, v0 = rng.standard_normal((d, 4)), rng.standard_normal((m, 4))
    rows = rng.integers(0, d, p).astype(np.int32)
    cols = rng.integers(0, m, p).astype(np.int32)
    w = u0 @ v0.T / 2.0
    vals = (w[rows, cols] + 0.1 * rng.standard_normal(p)).astype(np.float32)
    mu = float(np.linalg.svd(w, compute_uv=False).sum())
    table = rng.standard_normal((epochs, m)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    kmax = 4  # log schedule over 12 epochs: K <= 3
    noise = NoiseStream.from_tables(rng.random((epochs, kmax, d), dtype=np.float32),
                                    rng.random((epochs, kmax, m), dtype=np.float32))
    task = tasks.MatrixCompletion(d, m)
    idx, yw = tasks.pack_observations(rows, cols, vals)
    kw = dict(mu=mu, num_epochs=epochs, schedule="log", step_size="linesearch")
    runs = [dfw.fit_serial(task, idx, yw, cfg=dfw.DFWConfig(**kw),
                           key=V0Stream.from_table(table), device=where)
            for where in (dev, "cpu")]
    for name in ("loss", "gap", "sigma", "gamma"):
        got, want = np.array(runs[0].history[name]), np.array(runs[1].history[name])
        err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max()))
        check(err <= 1e-4, f"small mc {name}: card vs CPU rel err {err:.2e}")
    print("small mc fit (dense): card matches CPU (rtol 1e-4)")

    recs, res = [], []
    for where in (dev, "cpu"):
        rec = RecordingInt8(comm, qref, torch)
        ktask = dfw.kernelize(task)
        state = ktask.init_state(idx.to(where), yw.to(where))
        res.append(fw.fit(ktask, state, key=V0Stream.from_table(table), noise=noise,
                          reducer=rec, device=where, **kw))
        recs.append(rec.log)
    check(len(recs[0]) == len(recs[1]) == 2 * sum(res[1].history["k"]),
          "small mc int8: exchange counts differ")
    hist_epochs, flip = first_flip(np, recs, res)
    for name in ("loss", "gap", "sigma", "gamma"):
        got = np.array(res[0].history[name][:hist_epochs])
        want = np.array(res[1].history[name][:hist_epochs])
        if want.size:
            err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6 * np.abs(want).max()))
            check(err <= 1e-4, f"small mc int8 {name}: card vs CPU rel err {err:.2e}")
    print(f"small mc fit (int8): card matches CPU (rtol 1e-4 over {hist_epochs} epochs, "
          f"{'no' if flip is None else 'one'} grid-step flip)")


def first_flip(np, recs, res):
    """(epochs to compare, index of the first exchange whose integers differ
    between the card run and the CPU run, or None). At that exchange every
    moved integer must differ by one grid step, with the two runs' pre-floor
    values straddling an integer and within 1e-3 of each other; the final
    losses must then agree to 1e-2."""
    flip = next((j for j, (a, b) in enumerate(zip(recs[0], recs[1]))
                 if not np.array_equal(a[1], b[1])), None)
    if flip is None:
        return len(res[1].history["loss"]), None
    (pre_a, q_a), (pre_b, q_b) = recs[0][flip], recs[1][flip]
    moved = q_a != q_b
    check(np.max(np.abs(q_a.astype(int) - q_b.astype(int))) <= 1,
          f"small mc int8: exchange {flip} differs by more than one grid step")
    gap = float(np.max(np.abs(pre_a - pre_b)))
    check(gap <= 1e-3, f"small mc int8: pre-floor values differ by {gap:.2e}")
    check(np.all(np.floor(pre_a[moved]) != np.floor(pre_b[moved])),
          "small mc int8: a grid step moved without its values straddling an integer")
    ends = np.cumsum([2 * k for k in res[1].history["k"]])
    epoch = int(np.searchsorted(ends, flip, side="right"))
    rel = abs(res[0].final_loss - res[1].final_loss) / abs(res[1].final_loss)
    check(rel <= 1e-2, f"small mc int8: final loss differs by {rel:.2e} after a flip")
    print(f"small mc int8: exchange {flip} (epoch {epoch}) moved {int(moved.sum())} value(s) "
          f"by one grid step (pre-floor values straddle an integer, |diff| <= {gap:.1e}); "
          f"final loss within {rel:.1e}")
    return epoch, flip


# Phase 22 runs this many gloo workers on the one card; least squares there
# cuts n to the largest multiple of it, 1,281,164 (1,281,167 is divisible by
# no worker count from 2 to 8).
MULTI_WORKERS = 4


def fits_agree(np, got, want, label, w_got, w_want, logistic=False):
    """The reference's sharded-vs-serial tolerances (tests/test_dfw_launch.py):
    loss rtol 1e-5, gap rtol 1e-4 (atol 1e-5; logistic 1e-4), sigma rtol
    1e-4; W to 1e-5 of its max. The reference holds W to 1e-6 absolute,
    which is 1.8e-5 of max|W| in its matrix-completion test and 7.4e-5 in
    its least-squares test; here W is O(1) (matrix completion). At 48,000 x
    1,777 with 1M ratings in f32 on the CPU, after 10 epochs, the
    reference's 4-worker fit leaves its one-process fit by 4.4e-6 of max|W|
    (tools/jax_multi_drift.py) and the port's by 5.6e-6
    (tools/torch_multi_drift.py); a one-process run on the ratings in
    another order, by 7.2e-6 and 7.3e-6. After 30 epochs the same runs part
    by 1e-3 to 1e-1 of max|W|, the reference's as far as the port's.
    Returns each metric's relative deviation per epoch, and W's."""
    dev_of = {}
    for name, rtol, atol in (("loss", 1e-5, 0.0), ("gap", 1e-4, 1e-4 if logistic else 1e-5),
                             ("sigma", 1e-4, 0.0)):
        a, b = np.asarray(got[name], np.float64), np.asarray(want[name], np.float64)
        check(a.shape == b.shape, f"{label}: {name} has {a.shape} epochs, want {b.shape}")
        dev_of[name] = (np.abs(a - b) / np.abs(b)).tolist()
        check(bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b))),
              f"{label}: {name} deviates by up to {max(dev_of[name]):.2e} (rtol {rtol:.0e}; by "
              f"epoch {[float(f'{v:.2e}') for v in dev_of[name]]})")
    w_err = float(np.max(np.abs(w_got - w_want)) / np.max(np.abs(w_want)))
    dev_of["W"] = w_err
    check(w_err <= 1e-5, f"{label}: W deviates by {w_err:.2e} of its max (limit 1e-5)")
    return dev_of


def timed_fit(torch, kernels, run, dev):
    """run() under fresh launch counts: (result, launches, wall s, segment log)."""
    seg_log = []
    kernels.reset_launches()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = run(segment_timer(torch, seg_log))
    sync()
    return res, kernels.launches(), time.perf_counter() - t0, seg_log


def steady_ms(seg_log, ks):
    """ms per epoch of each K(t) segment after the first (which holds the
    set-up: verify, the state build), keyed by K."""
    return {ks[s["start"]]: s["ms_per_epoch"] for s in seg_log[1:]}


def fit_summary(low_rank, res):
    """What the checks keep of a fit (its state is freed)."""
    return dict(history=res.history, final_loss=res.final_loss, stats=res.stats,
                packed=low_rank.pack_live(res.iterate))


def world_one_phase(torch, np, kernels, dfw, comm, low_rank, NoiseStream, dev, jobs, seed):
    """(a) ``fit`` over a one-worker NCCL group against ``fit_serial`` on the
    same data: timed in turns (serial, fit, fit, serial), each run's
    history, final loss and packed iterate the same bits, the same kernel
    launches; ms per epoch of each side. Returns (report, summed launches
    of the fit runs)."""
    import os
    import tempfile

    import torch.distributed as dist

    report, total = {}, dict.fromkeys(kernels.launches(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            group = comm.WorkerGroup()
            for label, task, x, y, cfg in jobs:
                noise = NoiseStream(seed, worker=0)  # the one-worker group's own stream
                runs = []
                for side in ("serial", "fit", "fit", "serial"):
                    if side == "serial":
                        def fn(cb):
                            return dfw.fit_serial(task, x, y, cfg=cfg, key=seed, noise=noise,
                                                  device=dev, callback=cb)
                    else:
                        def fn(cb):
                            return dfw.fit(task, x, y, cfg=cfg, key=seed, group=group,
                                           device=dev, callback=cb)
                    res, launches, wall, seg_log = timed_fit(torch, kernels, fn, dev)
                    summary = fit_summary(low_rank, res)
                    del res
                    torch.cuda.empty_cache()
                    if side == "fit":
                        for k, v in launches.items():
                            total[k] += v
                    runs.append(dict(summary, side=side, launches=launches, wall_s=wall,
                                     segments=seg_log))
                first = runs[0]
                for run in runs[1:]:
                    check(run["history"] == first["history"]
                          and run["final_loss"] == first["final_loss"],
                          f"(a) {label}: {run['side']}'s history is not fit_serial's, bit for bit")
                    check(all(np.array_equal(run["packed"][k], first["packed"][k])
                              for k in first["packed"]),
                          f"(a) {label}: {run['side']}'s iterate is not fit_serial's, bit for bit")
                    check(run["launches"] == first["launches"],
                          f"(a) {label}: {run['side']} launched {run['launches']}, fit_serial "
                          f"{first['launches']}")
                ks = first["history"]["k"]
                ms = {side: [steady_ms(r["segments"], ks) for r in runs if r["side"] == side]
                      for side in ("serial", "fit")}
                per_k = {k: dict(serial=statistics.mean(m[k] for m in ms["serial"]),
                                 fit=statistics.mean(m[k] for m in ms["fit"]))
                         for k in ms["serial"][0]}
                report[label] = dict(walls_s=[r["wall_s"] for r in runs], ms_per_epoch=per_k,
                                     all_reduces=runs[1]["stats"]["all_reduces"])
                print(f"(a) {label}: fit over one NCCL worker = fit_serial bit for bit (history, "
                      f"final loss, iterate) and launch for launch ({first['launches']}); "
                      f"{runs[1]['stats']['all_reduces']} all-reduces; walls in turns "
                      + ", ".join(f"{r['side']} {r['wall_s']:.3f}" for r in runs) + " s; ms an "
                      "epoch " + "; ".join(
                          f"K={k}: serial {v['serial']:.3f}, fit {v['fit']:.3f} "
                          f"({100 * (v['fit'] / v['serial'] - 1):+.2f}%)"
                          for k, v in per_k.items()))
        finally:
            dist.destroy_process_group()
    return report, total


def multi_worker_rank(group, device, jobs, seed):
    """One worker of phase 22 (module level: run_workers starts it by name):
    ``fit`` of each job on its row block; host summaries back."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import low_rank
    from repro_torch.launch import dfw

    cuda = device.type == "cuda"
    out = []
    for _, task, x, y, kw in jobs:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        res, launches, wall, seg_log = timed_fit(torch, kernels, lambda cb: dfw.fit(
            task, x, y, cfg=dfw.DFWConfig(**kw), key=seed, group=group, device=device,
            callback=cb), device)
        out.append(dict(
            history=res.history, final_loss=res.final_loss, stats=res.stats,
            masks=None if res.masks is None else res.masks.numpy(), launches=launches,
            wall_s=wall, segments=seg_log,
            peak_gb=torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None,
            packed=low_rank.pack_live(res.iterate)))
        del res
        if cuda:
            torch.cuda.empty_cache()
    return out


def multi_worker_phase(torch, np, kernels, dfw, tasks, low_rank, dev, X, Y, mc, seed, args):
    """(b) MULTI_WORKERS gloo workers on the one card, with CUDA tensors
    (gloo stages them through the host): least squares at n = 1,281,164 and
    matrix completion dense, each against fit_serial on the same data; int8
    (budget 127 // 4 = 31) and dense with sample_prob 0.8, the ratings laid
    out by shard_observations. Matrix completion runs --mc-int8-epochs
    epochs (10, the depth of the reference's own sharded-vs-serial test):
    over 30, the reference's four-worker run leaves its one-process run as
    far as a one-process run on the same ratings in another order does
    (``fits_agree``). The data is made once here and shared with the workers
    through CUDA IPC. Returns (report, summed launches)."""
    idx, yw, (te_rows, te_cols, te_vals), mu = mc
    nw = MULTI_WORKERS
    mtls_kw = dict(mu=1.0, num_epochs=args.epochs, schedule="log", step_size="linesearch")
    mc_kw = dict(mu=mu, num_epochs=args.mc_int8_epochs, schedule="log", step_size="linesearch")
    t0 = time.perf_counter()
    mtls = tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M)
    mc_task = tasks.MatrixCompletion(NF_D, NF_M)
    n4 = X.shape[0] - X.shape[0] % nw
    refs = {}
    for label, task, x, y, kw in (("mtls dense", mtls, X[:n4], Y[:n4], mtls_kw),
                                  ("mc dense", mc_task, idx, yw, mc_kw)):
        res = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(**kw), key=seed, device=dev)
        refs[label] = fit_summary(low_rank, res)
        del res
        torch.cuda.empty_cache()
    idx4, yw4 = dfw.shard_observations(idx[:, 0], idx[:, 1], yw[:, 0], nw, NF_D, m=NF_M)
    idx4, yw4 = idx4.to(dev), yw4.to(dev)
    print(f"(b) set-up: the serial references (least squares at n = {n4}, matrix "
          f"completion) and the {nw}-worker shard layout ({idx4.shape[0] // nw} entries a "
          f"worker with padding) in {time.perf_counter() - t0:.1f} s")
    jobs = [("mtls", mtls, X[:n4], Y[:n4], mtls_kw), ("mc", mc_task, idx4, yw4, mc_kw),
            ("mc", mc_task, idx4, yw4, dict(mc_kw, comm="int8")),
            ("mc", mc_task, idx4, yw4, dict(mc_kw, sample_prob=0.8))]
    labels = ["mtls dense", "mc dense", "mc int8", "mc dense sample_prob 0.8"]
    t0 = time.perf_counter()
    ranks = dfw.run_workers(nw, multi_worker_rank, jobs, seed, backend="gloo", device=dev)
    wall = time.perf_counter() - t0
    total = dict.fromkeys(kernels.launches(), 0)
    report = dict(wall_s=wall, runs={})
    for i, (label, (kind, _, _, _, kw)) in enumerate(zip(labels, jobs)):
        got = [r[i] for r in ranks]
        head = got[0]
        for j, g in enumerate(got):
            want = expected_launches(kind, g["history"]["k"], True, kw.get("comm", "dense"))
            check(g["launches"] == want, f"(b) {label}: worker {j} launched {g['launches']}, "
                  f"expected {want}")
            for k, v in g["launches"].items():
                total[k] += v
            check(g["history"] == head["history"] and all(
                np.array_equal(g["packed"][k], head["packed"][k]) for k in g["packed"]),
                f"(b) {label}: worker {j}'s history or iterate differs from worker 0's")
        loss = head["history"]["loss"]
        check(all(math.isfinite(v) for v in loss + [head["final_loss"]]),
              f"(b) {label}: non-finite loss")
        it = low_rank.unpack_live(head["packed"], len(loss), device=dev)
        row = dict(walls_s=[g["wall_s"] for g in got], peak_gb=[g["peak_gb"] for g in got],
                   ms_per_epoch=steady_ms(head["segments"], head["history"]["k"]),
                   all_reduces=head["stats"]["all_reduces"], loss=loss,
                   final_loss=head["final_loss"])
        if label in refs:
            ref = refs[label]
            ref_it = low_rank.unpack_live(ref["packed"], len(loss), device=dev)
            if kind == "mtls":
                w_got, w_want = low_rank.materialize(it), low_rank.materialize(ref_it)
            else:  # W where it is evaluated: at the held-out entries
                w_got = low_rank.gather_entries(it, te_rows, te_cols)
                w_want = low_rank.gather_entries(ref_it, te_rows, te_cols)
            row["deviation"] = fits_agree(np, head["history"], ref["history"], f"(b) {label}",
                                          w_got.cpu().numpy(), w_want.cpu().numpy())
            del w_got, w_want, ref_it
        if kind == "mc":
            pred = low_rank.gather_entries(it, te_rows, te_cols)
            row["heldout_rmse"] = float(torch.sqrt(torch.mean((pred - te_vals) ** 2)))
            row["heldout_rmse_w0"] = float(torch.sqrt(torch.mean(te_vals ** 2)))
            check(row["heldout_rmse"] < row["heldout_rmse_w0"],
                  f"(b) {label}: held-out RMSE {row['heldout_rmse']:.4f} not below W = 0's "
                  f"{row['heldout_rmse_w0']:.4f}")
            if kw.get("comm") == "int8":
                check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:] + [
                    head["final_loss"]])), f"(b) {label}: loss increased")
            elif kw.get("sample_prob", 1.0) < 1.0:
                # The history holds the reweighted estimates sum_j w_j F_j of
                # the epochs' samples, which need not fall; final_loss is the
                # full-data loss.
                masks = head["masks"]
                check(masks.shape == (kw["num_epochs"], nw) and bool(np.all(
                    (masks > 0).sum(axis=1) >= 1)), f"(b) {label}: an epoch without a worker")
                check(bool(np.allclose(masks.sum(axis=1), nw, rtol=1e-5)),
                      f"(b) {label}: reweighted rows do not sum to {nw}")
                check(head["final_loss"] < loss[0], f"(b) {label}: final loss not below the first")
                row["alive_per_epoch"] = (masks > 0).sum(axis=1).tolist()
        report["runs"][label] = row
        largest = ({k: max(v) if isinstance(v, list) else v for k, v in row["deviation"].items()}
                   if "deviation" in row else None)
        print(f"(b) {label}, {nw} gloo workers on one card: walls "
              + ", ".join(f"{w:.2f}" for w in row["walls_s"]) + " s; ms an epoch "
              + ", ".join(f"K={k}: {v:.2f}" for k, v in row["ms_per_epoch"].items())
              + " (host staging of every collective; not a speedup); peak device memory a "
              "worker " + ", ".join(fmt_ms(g, 2) for g in row["peak_gb"]) + " GB; "
              f"{row['all_reduces']} all-reduces; launches a worker {head['launches']}"
              + (f"; largest deviation from the one-process run {largest}" if largest else "")
              + (f"; held-out RMSE {row['heldout_rmse']:.4f} (W = 0: "
                 f"{row['heldout_rmse_w0']:.4f})" if "heldout_rmse" in row else "")
              + (f"; workers alive an epoch {row['alive_per_epoch']}"
                 if "alive_per_epoch" in row else ""))
    del idx4, yw4
    return report, total


# Phase 23: NAIVE-DFW and SVA (the paper's section 3.1 baselines) at the ImageNet
# least-squares shapes, and NAIVE on logistic regression and on a small MC.
BASELINE_EPOCHS, BASELINE_LOGISTIC_EPOCHS = 5, 3
SMALL_MC = (4_800, 1_777, 1_000_000)  # users, movies, ratings: the dense gradient is 34 MB
NAIVE_ORACLE = 1.10  # tests/test_frank_wolfe.py: NAIVE's loss <= 1.10 x DFW-Trace's per epoch


class PartTimer:
    """CUDA events around the named parts of an epoch; ``ms()`` reads them
    (one sync) as each part's ms per call."""

    def __init__(self, torch):
        self.torch, self.events = torch, {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self):
        self.torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in ev] for name, ev in self.events.items()}


class TimedTask:
    """A task whose local_grad and update are timed (everything else is the
    task's)."""

    def __init__(self, task, timer):
        self._task = task
        self.local_grad = timer.wrap("local_grad", task.local_grad)
        self.update = timer.wrap("update", task.update)

    def __getattr__(self, name):
        return getattr(self._task, name)


def baseline_run(torch, kernels, baselines, low_rank, method, task, state, epochs, mu, step,
                 dev):
    """``epochs`` epochs of a baseline under fresh launch counts: (history,
    final state, launches, ms per part and epoch)."""
    timer = PartTimer(torch)
    exact = baselines._exact_top_pair
    baselines._exact_top_pair = timer.wrap("svd", exact)
    try:
        make = (baselines.make_naive_epoch_step if method == "naive"
                else baselines.make_sva_epoch_step)
        ep = timer.wrap("epoch", make(TimedTask(task, timer), mu, step_size=step))
        it = low_rank.init(epochs, task.d, task.m, device=dev)
        kernels.reset_launches()
        rows = []
        for t in range(epochs):
            state, it, aux = ep(state, it, t, None)
            rows.append(aux)
        launches = kernels.launches()
    finally:
        baselines._exact_top_pair = exact
    hist = {k: [float(getattr(a, k)) for a in rows] for k in ("loss", "gap", "sigma", "gamma")}
    return hist, state, launches, timer.ms()


def baselines_phase(torch, np, kernels, dfw, tasks, baselines, low_rank, dev, X, Y, labels, gen,
                    seed):
    """NAIVE-DFW and SVA with the line search at n = 1,281,167, d = 2048,
    m = 1000 (BASELINE_EPOCHS each), NAIVE on logistic regression
    (BASELINE_LOGISTIC_EPOCHS, 2/(t+2)), each epoch's ms split into
    local_grad, the SVD and the update; NAIVE's loss at each epoch at most
    NAIVE_ORACLE x DFW-Trace const:1's; local_grad twice the same bits (least
    squares, logistic regression, and matrix completion at SMALL_MC, made on
    the card, where it also equals the CPU's fixed-order sum bit for bit and
    the accumulating scatter to 1e-6 of its max); NAIVE on that MC. Launch
    counts as the path implies. Returns (report, summed launches)."""
    report, total = {}, dict.fromkeys(kernels.launches(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    mtls = dfw.kernelize(tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M))
    dfw_ref = dfw.fit_serial(mtls, X, Y, cfg=dfw.DFWConfig(
        mu=1.0, num_epochs=BASELINE_EPOCHS, schedule="const:1", step_size="linesearch",
        verify_kernels=False), key=seed, device=dev).history["loss"]
    per_epoch = {"naive": dict(matvec=2, rank1_update_axpy=1),
                 "sva": dict(matvec=3, rmatvec=1, rank1_update_axpy=1)}
    for method in ("naive", "sva"):
        hist, state, launches, ms = baseline_run(
            torch, kernels, baselines, low_rank, method, mtls, mtls.init_state(X, Y),
            BASELINE_EPOCHS, 1.0, "linesearch", dev)
        del state
        want = dict.fromkeys(launches, 0)
        want.update({k: v * BASELINE_EPOCHS for k, v in per_epoch[method].items()})
        check(launches == want, f"baselines mtls {method}: launches {launches} != {want}")
        add(launches)
        check(all(math.isfinite(v) for v in hist["loss"]), f"baselines mtls {method}: loss")
        if method == "naive":
            worst = max(a / b for a, b in zip(hist["loss"], dfw_ref))
            check(worst <= NAIVE_ORACLE, f"baselines: NAIVE's loss reaches {worst:.4f} x "
                  f"DFW-Trace const:1's (limit {NAIVE_ORACLE})")
        report[f"mtls {method}"] = dict(loss=hist["loss"], gap=hist["gap"], ms=ms,
                                        launches=launches)
        steady = {k: statistics.median(v[1:]) for k, v in ms.items()}
        print(f"baselines mtls {method}: {BASELINE_EPOCHS} epochs, ms an epoch (median of "
              f"epochs 1-{BASELINE_EPOCHS - 1}) {steady['epoch']:.2f}: local_grad "
              f"{steady['local_grad']:.2f}, SVD {steady['svd']:.2f}, update "
              f"{steady['update']:.2f}; loss " + ", ".join(f"{v:.6g}" for v in hist["loss"])
              + (f"; NAIVE / DFW-Trace const:1 at most {worst:.4f}" if method == "naive" else ""))
    print("  DFW-Trace const:1 loss " + ", ".join(f"{v:.6g}" for v in dfw_ref))
    state = mtls.init_state(X, Y)
    check(torch.equal(mtls.local_grad(state), mtls.local_grad(state)),
          "baselines: MTLS local_grad differs between two calls")
    del state
    torch.cuda.empty_cache()

    logistic = dfw.kernelize(tasks.MultinomialLogistic(PAPER_D, PAPER_M))
    hist, state, launches, ms = baseline_run(
        torch, kernels, baselines, low_rank, "naive", logistic, logistic.init_state(X, labels),
        BASELINE_LOGISTIC_EPOCHS, 10.0, "default", dev)
    want = dict.fromkeys(launches, 0)
    want.update(matvec=BASELINE_LOGISTIC_EPOCHS, rank1_update=BASELINE_LOGISTIC_EPOCHS)
    check(launches == want, f"baselines logistic naive: launches {launches} != {want}")
    add(launches)
    final = float(logistic.local_loss(state))
    bound = X.shape[0] * math.log(PAPER_M)  # the loss at W = 0; phase 4's check
    check(final < bound, f"baselines logistic naive: final loss {final} >= n ln m {bound}")
    check(torch.equal(logistic.local_grad(state), logistic.local_grad(state)),
          "baselines: logistic local_grad differs between two calls")
    del state
    torch.cuda.empty_cache()
    steady = {k: statistics.median(v[1:]) for k, v in ms.items()}
    report["logistic naive"] = dict(loss=hist["loss"], final_loss=final, ms=ms,
                                    launches=launches)
    print(f"baselines logistic naive: {BASELINE_LOGISTIC_EPOCHS} epochs, ms an epoch "
          f"{steady['epoch']:.2f}: local_grad {steady['local_grad']:.2f}, SVD "
          f"{steady['svd']:.2f}, update {steady['update']:.2f}; loss "
          + ", ".join(f"{v:.6g}" for v in hist["loss"]) + f"; final {final:.6g} < n ln m = "
          f"{bound:.6g}")

    d, m, p = SMALL_MC
    idx, yw, _, mu = make_mc_data(torch, gen, dev, p, 1, d=d, m=m)
    mc = dfw.kernelize(tasks.MatrixCompletion(d, m))
    kernels.reset_launches()
    state = mc.init_state(idx, yw)
    g1, g2 = mc.local_grad(state), mc.local_grad(state)
    check(torch.equal(g1, g2), "baselines: MC local_grad differs between two calls")
    on_cpu = mc.local_grad(mc.init_state(idx.cpu(), yw.cpu()))
    check(torch.equal(g1.cpu(), on_cpu), "baselines: MC local_grad on the card is not the "
          "CPU's fixed-order sum")
    plain = torch.zeros(d, m, device=dev).index_put_(
        (state.rows.long(), state.cols.long()), state.resid, accumulate=True)
    plain_err = float(torch.max(torch.abs(g1 - plain)) / torch.max(torch.abs(plain)))
    check(plain_err <= 1e-6, f"baselines: MC local_grad {plain_err:.2e} from the plain chain")
    dups = mc_stats(torch, idx, d, m)["duplicates"]
    del g1, g2, on_cpu, plain
    hist, state, launches, ms = baseline_run(
        torch, kernels, baselines, low_rank, "naive", mc, state, BASELINE_EPOCHS, mu,
        "linesearch", dev)
    launches = kernels.launches()
    want = dict.fromkeys(launches, 0)
    want.update(update_resid=BASELINE_EPOCHS)
    check(launches == want, f"baselines mc naive: launches {launches} != {want}")
    add(launches)
    loss = hist["loss"]
    check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])), "baselines mc naive: loss "
          "increased")
    steady = {k: statistics.median(v[1:]) for k, v in ms.items()}
    report["mc naive"] = dict(loss=loss, ms=ms, duplicates=dups, plain_rel_err=plain_err)
    print(f"baselines mc naive at {d} x {m}, {p} ratings ({dups} duplicate positions): "
          f"local_grad the same bits twice and the CPU's, {plain_err:.1e} of max from the "
          f"accumulating scatter; ms an epoch {steady['epoch']:.2f}: local_grad "
          f"{steady['local_grad']:.2f}, SVD {steady['svd']:.2f}, update {steady['update']:.2f}; "
          "loss " + ", ".join(f"{v:.6g}" for v in loss))
    del state, idx, yw
    torch.cuda.empty_cache()
    return report, total


# Phase 24: the exchange graphs, each against fit_serial dense on the same data
# at the reference's own tolerance for it (its tests hold least squares):
# hier:2 dense tests/test_topology.py:233 (loss rtol 2e-5, gap rtol 2e-4 with
# atol 1e-4), ring :253 (final loss 1%, gap 5%), int8 tests/test_comm.py:261
# (loss rtol 0.02). Where no reference tolerance applies the run is held to the
# line search's descent (loss non-increasing, final below the first) and its
# deviation printed: top-k (the reference's 0.35 at :261 is for d = 40, m = 30,
# where topk:16 sends 40% and 53% of each vector; here it sends 0.8% and 1.6%,
# and 3e-5 of MC's u) and int8 across matrix completion's hier groups.
GRAPHS = (("ring", dict(topology="ring")), ("hier:2", dict(topology="hier:2")),
          ("hier:2 int8", dict(topology="hier:2", comm="int8")),
          ("topk:16", dict(comm="topk:16")))


def graph_agrees(np, label, kind, got, want, final, final_want):
    """Each graph's deviation from the serial run, held to its tolerance
    (see GRAPHS)."""
    hist = {k: (np.asarray(got[k], np.float64), np.asarray(want[k], np.float64))
            for k in ("loss", "gap")}
    rel_final = abs(final - final_want) / abs(final_want)
    dev = {k: float(np.max(np.abs(a - b) / np.abs(b))) for k, (a, b) in hist.items()}
    dev["final_loss"] = rel_final
    if label.endswith("hier:2"):
        a, b = hist["loss"]
        check(bool(np.all(np.abs(a - b) <= 1e-6 + 2e-5 * np.abs(b))), f"{label}: loss {dev}")
        a, b = hist["gap"]
        check(bool(np.all(np.abs(a - b) <= 1e-4 + 2e-4 * np.abs(b))), f"{label}: gap {dev}")
    elif label.endswith("ring"):
        check(rel_final <= 0.01 and dev["gap"] <= 0.05, f"{label}: {dev} (final 1%, gap 5%)")
    elif label.endswith("int8") and kind == "mtls":
        a, b = hist["loss"]
        check(bool(np.all(np.abs(a - b) <= 0.02 * np.abs(b))) and rel_final < 0.02,
              f"{label}: {dev} (loss rtol 0.02)")
    else:
        loss = list(got["loss"]) + [final]
        check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])) and final < loss[0],
              f"{label}: the loss did not fall under the line search: {loss}")
    return dev


def graphs_phase(torch, np, kernels, dfw, comm, tasks, low_rank, NoiseStream, dev, X, Y, mc,
                 seed, args, dense_ms):
    """(a) ``topk:16`` through ``fit`` over one NCCL worker against
    ``fit_serial``, least squares (--epochs) and matrix completion at the
    Netflix shapes (--mc-int8-epochs), in turns, the same bits and launches;
    ms an epoch against dense (phase 21's); the top-k exchange's time on MC's
    480,189-long u. (b) MULTI_WORKERS gloo workers on the card: ring (R = 5
    at N = 4), hier:2 dense, hier:2 + int8 (budget 63) and topk:16 on least
    squares (n = 1,281,164) and on matrix completion (--mc-int8-epochs), each
    against ``fit_serial`` dense on the same data at the reference's
    tolerances (``graph_agrees``); every worker's launches as its path
    implies; every worker returns worker 0's iterate; the bytes each worker
    counted equal the analytic ones exactly. Returns (report, summed
    launches)."""
    idx, yw, _, mu = mc
    report = {}
    mtls_kw = dict(mu=1.0, num_epochs=args.epochs, schedule="log", step_size="linesearch")
    mc_kw = dict(mu=mu, num_epochs=args.mc_int8_epochs, schedule="log", step_size="linesearch")
    mtls = tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M)
    mc_task = tasks.MatrixCompletion(NF_D, NF_M)
    report["a"], total = world_one_phase(
        torch, np, kernels, dfw, comm, low_rank, NoiseStream, dev, [
            ("mtls topk:16", mtls, X, Y, dfw.DFWConfig(**mtls_kw, comm="topk:16")),
            ("mc topk:16", mc_task, idx, yw, dfw.DFWConfig(**mc_kw, comm="topk:16")),
        ], seed)
    for label, dense_label in (("mtls topk:16", "mtls"), ("mc topk:16", "mc dense")):
        got, ref = report["a"][label]["ms_per_epoch"], dense_ms[dense_label]["ms_per_epoch"]
        print(f"(a) {label}: ms an epoch against dense (phase 21) " + "; ".join(
            f"K={k}: {v['fit']:.3f} vs {ref[k]['fit']:.3f}" for k, v in got.items() if k in ref))
    u = torch.randn(NF_D, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    r = comm.TopKReducer(k=16)
    state = r.init_state(NF_D, NF_M, device=dev)
    report["topk_u_ms"] = time_ms(torch, lambda: r.exchange(u, state, slot="u"), args.reps)
    report["topk_u_sort_ms"] = time_ms(
        torch, lambda: comm.topk.top_k_indices(u, 16), args.reps)
    print(f"(a) topk:16 exchange of MC's u (480,189,), one process: {report['topk_u_ms']:.4f} ms "
          f"(its stable sort {report['topk_u_sort_ms']:.4f} ms)")

    nw = MULTI_WORKERS
    n4 = X.shape[0] - X.shape[0] % nw
    idx4, yw4 = dfw.shard_observations(idx[:, 0], idx[:, 1], yw[:, 0], nw, NF_D, m=NF_M)
    idx4, yw4 = idx4.to(dev), yw4.to(dev)
    t0 = time.perf_counter()
    refs = {}
    for kind, task, x, y, kw in (("mtls", mtls, X[:n4], Y[:n4], mtls_kw),
                                 ("mc", mc_task, idx4, yw4, mc_kw)):
        res = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(**kw), key=seed, device=dev)
        refs[kind] = dict(history=res.history, final_loss=res.final_loss)
        del res
        torch.cuda.empty_cache()
    jobs, labels = [], []
    for kind, task, x, y, kw in (("mtls", mtls, X[:n4], Y[:n4], mtls_kw),
                                 ("mc", mc_task, idx4, yw4, mc_kw)):
        for name, graph in GRAPHS:
            jobs.append((kind, task, x, y, dict(kw, **graph)))
            labels.append(f"{kind} {name}")
    ranks = dfw.run_workers(nw, multi_worker_rank, jobs, seed, backend="gloo", device=dev)
    report["b"] = dict(wall_s=time.perf_counter() - t0, runs={})
    for i, (label, (kind, task, _, _, kw)) in enumerate(zip(labels, jobs)):
        got = [r[i] for r in ranks]
        head = got[0]
        cm = kw.get("comm", "dense")
        gossip = kw.get("topology", "flat") == "ring"
        for j, g in enumerate(got):
            want = expected_launches(kind, g["history"]["k"], True, cm)
            check(g["launches"] == want, f"(b) {label}: worker {j} launched {g['launches']}, "
                  f"expected {want}")
            for k, v in g["launches"].items():
                total[k] += v
            check(all(np.array_equal(g["packed"][k], head["packed"][k]) for k in head["packed"]),
                  f"(b) {label}: worker {j} did not return worker 0's iterate")
            if cm != "int8" or j % 2 == 0:  # int8 across hier groups: each pair its own noise
                check(g["history"] == head["history"], f"(b) {label}: worker {j}'s history")
            st, epochs = g["stats"], len(g["history"]["k"])
            counted = st["bytes_all_reduce"] + st["bytes_all_gather"] + st["bytes_send"]
            scalars = epochs * (2 + 2 + (2 if gossip else 0)) * 2 * 4 + 2 * 4
            check(counted == st["comm_wire_bytes"] + scalars,
                  f"(b) {label}: worker {j} counted {counted} bytes, analytic "
                  f"{st['comm_wire_bytes']} + {scalars} scalars")
        dev_of = graph_agrees(np, f"(b) {label}", kind, head["history"], refs[kind]["history"],
                              head["final_loss"], refs[kind]["final_loss"])
        st, epochs = head["stats"], len(head["history"]["k"])
        hops = {k[len("comm_hop_bytes_"):]: v / epochs for k, v in st.items()
                if k.startswith("comm_hop_bytes_")} or {"global": st["comm_wire_bytes"] / epochs}
        row = dict(deviation=dev_of, walls_s=[g["wall_s"] for g in got],
                   ms_per_epoch=steady_ms(head["segments"], head["history"]["k"]),
                   bytes_per_epoch=(st["bytes_all_reduce"] + st["bytes_all_gather"]
                                    + st["bytes_send"]) / epochs,
                   wire_bytes_per_epoch=st["comm_wire_bytes"] / epochs, hop_bytes_per_epoch=hops,
                   all_reduces=st["all_reduces"])
        report["b"]["runs"][label] = row
        print(f"(b) {label}, {nw} gloo workers: deviation from fit_serial dense "
              + ", ".join(f"{k} {v:.2e}" for k, v in dev_of.items())
              + f"; counted bytes an epoch {row['bytes_per_epoch']:.1f} = exchanges "
              f"{row['wire_bytes_per_epoch']:.1f} (by hop "
              + ", ".join(f"{h} {b:.1f}" for h, b in hops.items())
              + ") + scalar sums; ms an epoch "
              + ", ".join(f"K={k}: {v:.2f}" for k, v in row["ms_per_epoch"].items())
              + " (host staging; a check, not a timing)")
    del idx4, yw4
    return report, total


SERVE_D, SERVE_M, SERVE_BATCH, SERVE_BLOCK = PAPER_D, PAPER_M, 64, 32


def device_ms(torch, fn, name="", n=20):
    """Device time per call of ``fn`` (torch.profiler): the kernels whose name
    holds ``name`` (every kernel for ""), summed over n calls, over n; None
    if two profiles in a row recorded none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if str(getattr(ev, "device_type", "")).endswith("CUDA") and name in ev.key)
        if total:
            return total / n / 1e3
    return None


def fmt_ms(x, digits=4):
    """A device time for a log line: "not measured" where the profiler gave none."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def factor_kernel_phase(torch, fm, _build, dev, gen, reps, peaks):
    """factor_matvec against its plain version at the serving shapes (both
    directions) and tiny odd ones; bits on repeat; the zero tail of a rank
    bucket; times of kernel, plain version, the one library call
    einsum("bi,ki,k,kj->bj") and the cuBLAS chain (x @ a.T * s) @ b, TF32 off
    (CUDA events per call; for b = 1, 64 and 1024 at ranks 32, 64 and 256
    also device time from the profiler); the HMMA count of the kernel's SASS."""
    bw, flops = peaks[:2]
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    torch.backends.cuda.matmul.allow_tf32 = False
    hmma = sass_counts(_build, "factor_matvec", "HMMA", "factor_matvec_kernel")
    print(f"factor_matvec SASS: HMMA instructions per kernel {hmma}")
    check(hmma and all(v > 0 for v in hmma.values()),
          "factor_matvec: no tensor-core instruction (HMMA) in the built kernel")
    rows_out = []
    for n_in, n_out in ((SERVE_D, SERVE_M), (SERVE_M, SERVE_D)):
        for bt in (1, SERVE_BATCH, 1024):
            for cap in (32, 64, 256):
                x, a, s, b = rn(bt, n_in) / math.sqrt(n_in), rn(cap, n_in), rn(cap), rn(cap, n_out)
                got = fm.factor_matvec(x, a, s, b)
                torch.cuda.synchronize()
                err_abs, err_rel = rel_err(torch, got, fm.ref.factor_matvec(x, a, s, b))
                check(math.isfinite(err_rel) and err_rel <= TOL["factor_matvec"],
                      f"factor_matvec b={bt} r={cap} {n_in}->{n_out}: rel err {err_rel:.3e}")
                check(torch.equal(fm.factor_matvec(x, a, s, b), got),
                      f"factor_matvec b={bt} r={cap} {n_in}->{n_out} is not bit-stable")
                lib = lambda x=x, a=a, s=s, b=b: torch.einsum(  # noqa: E731
                    "bi,ki,k,kj->bj", x, a, s, b)
                lib_err = rel_err(torch, lib(), got)[1]
                nbytes = 4 * (bt * n_in + cap * (n_in + n_out + 1) + bt * n_out)
                nflops = 2 * bt * cap * (n_in + n_out) + bt * cap
                row = dict(
                    name="factor_matvec", operand=f"b={bt} r={cap} {n_in}->{n_out}",
                    shape=[bt, n_in, cap, n_out], max_abs_err=err_abs, max_rel_err=err_rel,
                    ms=time_ms(torch, lambda: fm.factor_matvec(x, a, s, b), reps),
                    plain_ms=time_ms(torch, lambda: fm.ref.factor_matvec(x, a, s, b), reps),
                    library_ms=time_ms(torch, lib, reps), library_rel_err=lib_err,
                    library_chain_ms=time_ms(torch, lambda: (x @ a.T * s) @ b, reps),
                    bound_ms=1e3 * max(nbytes / bw, nflops / flops),
                    bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
                    bytes=nbytes, flops=nflops, plan=dataclasses.asdict(
                        fm.kernel.launch_plan(bt, n_in, cap, n_out)), hmma=hmma,
                    main=(bt, cap, n_in) == (SERVE_BATCH, 64, SERVE_D))
                if cap == {1: 32, SERVE_BATCH: 64, 1024: 256}[bt]:
                    row.update(
                        device_ms=device_ms(torch, lambda: fm.factor_matvec(x, a, s, b),
                                            "factor_matvec_kernel"),
                        library_device_ms=device_ms(torch, lib),
                        library_chain_device_ms=device_ms(torch, lambda: (x @ a.T * s) @ b))
                    print(f"  device time per call: kernel {row['device_ms']:.4f} ms, einsum "
                          f"{row['library_device_ms']:.4f}, chain "
                          f"{row['library_chain_device_ms']:.4f}; plan {row['plan']}")
                rows_out.append(row)
                print(f"kernel factor_matvec b={bt:4d} r={cap:3d} {n_in}->{n_out}: "
                      f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, einsum "
                      f"{row['library_ms']:.4f}, cuBLAS chain {row['library_chain_ms']:.4f}, "
                      f"bound {row['bound_ms']:.5f} by {row['bound_by']}) rel err "
                      f"{err_rel:.2e}, bit-stable; einsum rel err {lib_err:.2e}")
    # the zero tail of a rank bucket: live rank 20 at capacity 32 and 64, at
    # batches of one and several clusters, batch tiles of 16, 32 and 64 rows
    for bt in (1, 20, SERVE_BATCH, 300, 600, 1024):
        x, a, s, b = rn(bt, SERVE_D), rn(20, SERVE_D), rn(20), rn(20, SERVE_M)
        live = fm.factor_matvec(x, a, s, b)
        for cap in (32, 64):
            pad = lambda t: torch.cat([t, t.new_zeros((cap - 20,) + t.shape[1:])])  # noqa: E731
            check(torch.equal(fm.factor_matvec(x, pad(a), pad(s), pad(b)), live),
                  f"factor_matvec b={bt}: capacity {cap} changed the live rank's bits")
    # tiny odd shapes, 16-byte aligned and not
    for (bt, n_in, r, n_out) in ((3, 129, 7, 65), (1, 7, 1, 3), (130, 300, 7, 65),
                                 (33, 128, 12, 257), (300, 128, 12, 257), (600, 256, 7, 65)):
        for aligned in (True, False):
            def mk(*sh):
                t = rn(math.prod(sh) + (0 if aligned else 1))
                return (t if aligned else t[1:]).view(*sh)
            x, a, s, b = mk(bt, n_in), mk(r, n_in), rn(r), mk(r, n_out)
            err = rel_err(torch, fm.factor_matvec(x, a, s, b, alpha=0.7),
                          fm.ref.factor_matvec(x, a, 0.7 * s, b))[1]
            check(err <= TOL["factor_matvec"],
                  f"factor_matvec at {(bt, n_in, r, n_out)} aligned={aligned}: {err:.3e}")
    print("factor_matvec matches its plain version at the serving and odd shapes, bit-stable, "
          "a padded rank bucket gives the live rank's bits")
    return rows_out


def train_then_serve(torch, np, dfw, tasks, ckpt, serve, low_rank, kernels, dev, gen, args):
    """Phase 12: fit_serial writes checkpoints, the serving engine loads,
    scores and hot-swaps them. Returns (report, fit launches, serving
    launches)."""
    import tempfile

    rep = {}
    n = args.serve_rows
    X = torch.randn(n, SERVE_D, generator=gen, device=dev)
    wu, wv = planted(torch, gen, dev, SERVE_D, SERVE_M)
    Y = (X @ wu) @ wv.T
    Y.add_(torch.randn(n, SERVE_M, generator=gen, device=dev), alpha=0.01)
    del wu, wv
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="serve_ckpt_") as ckdir:
        cfg = dfw.DFWConfig(mu=1.0, num_epochs=args.serve_epochs, schedule="log",
                            step_size="linesearch", block_epochs=16, checkpoint_dir=ckdir,
                            checkpoint_every=1, checkpoint_keep=None)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = dfw.fit_serial(tasks.MultiTaskLeastSquares(SERVE_D, SERVE_M), X, Y, cfg=cfg,
                             key=args.seed, device=dev)
        torch.cuda.synchronize()
        rep["fit_s"] = time.perf_counter() - t0
        fit_launch = kernels.launches()
        want = expected_launches("mtls", res.history["k"], cfg.verify_kernels)
        check(fit_launch == want, f"serve fit: launches {fit_launch} != expected {want}")
        steps = ckpt.store.list_steps(ckdir)
        check(steps[-1] == args.serve_epochs and len(steps) == res.stats["segments_run"],
              f"serve fit: checkpoint steps {steps} for {res.stats['segments_run']} segments")
        step_bytes = sum(f.stat().st_size for f in Path(ckdir, f"step_{steps[-1]:08d}").iterdir())
        rep.update(steps=steps, step_bytes=step_bytes, fit_stats=res.stats)
        print(f"serve fit: MTLS n={n} d={SERVE_D} m={SERVE_M}, {res.epochs_run} epochs in "
              f"{rep['fit_s']:.2f} s, checkpoint steps {steps} ({step_bytes / 1e9:.3f} GB each)")
        del res, X, Y
        torch.cuda.empty_cache()

        def dense(step):
            packed = ckpt.read_iterate_packed(ckdir, step)[1]
            return low_rank.materialize(low_rank.unpack_live(packed, int(packed["count"]),
                                                             device=dev))

        def score_err(got, x, w):
            want = torch.from_numpy(x).to(dev) @ w
            return rel_err(torch, torch.from_numpy(got).to(dev), want)[1]

        rng = np.random.default_rng(args.seed)
        scfg = serve.ServeConfig(max_batch=SERVE_BATCH, rank_block=SERVE_BLOCK)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = serve.ServingEngine.from_checkpoint(ckdir, scfg, step=steps[0], device=dev)
        rep["first_load_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        served = []  # (step, x, scores) checked after the scoring window
        lat = []
        for _ in range(args.serve_batches):
            x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
            t0 = time.perf_counter()
            got = eng.score(x)
            lat.append(time.perf_counter() - t0)
            served.append((eng.model.step, x, got))
        # hot-swap to the latest step while a batch is in flight
        x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
        first = eng.score_async(x)
        t0 = time.perf_counter()
        eng.load(ckdir)
        swap_s = [time.perf_counter() - t0]
        second = eng.score_async(x)
        check(first.version == 0 and second.version == 1 and second.step == steps[-1],
              f"in-flight swap: versions {first.version}, {second.version}")
        served += [(steps[0], x, first.block()), (steps[-1], x, second.block())]
        # every step in turn, one batch each
        for step in steps[1:]:
            t0 = time.perf_counter()
            eng.load(ckdir, step=step)
            swap_s.append(time.perf_counter() - t0)
            x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
            served.append((step, x, eng.score(x)))
        buckets = {serve.rank_bucket(s, SERVE_BLOCK) for s in steps}
        check(eng.stats["compilations"] == len(buckets),
              f"rank buckets prepared {eng.stats['compilations']} != visited {len(buckets)}")
        # 640 single requests through a MicroBatcher
        batcher = serve.MicroBatcher(eng, flush_at=SERVE_BATCH)
        singles = rng.standard_normal((10 * SERVE_BATCH, SERVE_D), dtype=np.float32)
        tickets = [batcher.submit(q) for q in singles]
        check(batcher.pending_count == 0 and all(tk.dispatched for tk in tickets),
              "micro-batcher left requests queued")
        served.append((eng.model.step, singles, np.stack([tk.result() for tk in tickets])))
        rise = torch.cuda.max_memory_allocated() - base_mem
        dispatches = eng.stats["dispatches"]
        check(dispatches == args.serve_batches + 2 + len(steps) - 1 + 10,
              f"serving dispatches {dispatches}")
        # a transposed engine on the latest step (the first engine's start-up
        # check covered both directions)
        teng = serve.ServingEngine.from_checkpoint(
            ckdir, serve.ServeConfig(max_batch=SERVE_BATCH, rank_block=SERVE_BLOCK,
                                     transpose=True, verify_kernels=False), device=dev)
        tserved = []
        for _ in range(20):
            x = rng.standard_normal((SERVE_BATCH, SERVE_M), dtype=np.float32)
            tserved.append((teng.model.step, x, teng.score(x)))
        serve_launch = kernels.launches()
        dispatches += teng.stats["dispatches"]
        check(serve_launch["factor_matvec"] == dispatches + 2,
              f"factor_matvec launches {serve_launch['factor_matvec']} != dispatches "
              f"{dispatches} + 2")
        check(rise < 4 * SERVE_D * SERVE_M,
              f"scoring raised device memory by {rise} bytes, a d x m f32 matrix is "
              f"{4 * SERVE_D * SERVE_M}")
        # every score against x @ W (or x @ W^T) on the card
        ws = {s: dense(s) for s in steps}
        worst = max(score_err(got, x, ws[s]) for s, x, got in served)
        worst_t = max(score_err(got, x, ws[s].T) for s, x, got in tserved)
        check(worst <= TOL["serve"] and worst_t <= TOL["serve"],
              f"served scores differ from x @ W: rel err {worst:.3e} / transposed {worst_t:.3e}")
        del ws
    lat_ms = sorted(1e3 * v for v in lat)
    rep.update(
        dispatches=dispatches, compilations=eng.stats["compilations"], buckets=sorted(buckets),
        launches=serve_launch["factor_matvec"], memory_rise_bytes=rise,
        latency_p50_ms=statistics.median(lat_ms),
        latency_p99_ms=lat_ms[min(len(lat_ms) - 1, math.ceil(0.99 * len(lat_ms)) - 1)],
        requests_per_s=SERVE_BATCH * len(lat) / sum(lat), swap_ms=[1e3 * v for v in swap_s],
        max_rel_err=worst, max_rel_err_transposed=worst_t)
    print(f"serve: {len(lat)} batches of {SERVE_BATCH} at live rank {steps[0]} (bucket "
          f"{serve.rank_bucket(steps[0], SERVE_BLOCK)}): per dispatch p50 "
          f"{rep['latency_p50_ms']:.4f} ms, p99 {rep['latency_p99_ms']:.4f} ms, "
          f"{rep['requests_per_s']:.0f} requests/s")
    print(f"serve: hot-swaps {', '.join(f'{v:.2f}' for v in rep['swap_ms'])} ms; buckets "
          f"{sorted(buckets)} prepared {eng.stats['compilations']}; {dispatches} dispatches, "
          f"{serve_launch['factor_matvec']} factor_matvec launches; scoring added "
          f"{rise} bytes of device memory; max rel err {worst:.2e} (transposed {worst_t:.2e})")
    return rep, fit_launch, serve_launch, eng


def profile_serving(torch, np, eng, n=50):
    """Device time of n sequential dispatches against their wall time."""
    from torch.profiler import ProfilerActivity, profile

    xs = np.random.default_rng(1).standard_normal((n, SERVE_BATCH, eng.n_in), dtype=np.float32)
    eng.score(xs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in xs:
            eng.score(x)
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev_us, host_us = {}, {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us[ev.key] = dev_us.get(ev.key, 0.0) + ev.self_device_time_total
        elif ev.self_cpu_time_total > 0:
            host_us[ev.key] = host_us.get(ev.key, 0.0) + ev.self_cpu_time_total
    busy = sum(dev_us.values())
    kern = sum(t for k, t in dev_us.items() if "factor_matvec_kernel" in k)
    out = dict(dispatches=n, wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               kernel_us_per_dispatch=kern / n, idle_share=1.0 - busy / wall_us if busy else None,
               top=sorted(((k[:90], t / 1e3) for k, t in dev_us.items()), key=lambda kv: -kv[1]),
               # host time of the traced ops (the Python between them is not
               # traced): where a dispatch's wall time goes
               host_us_per_dispatch=sorted(((k[:60], t / n) for k, t in host_us.items()),
                                           key=lambda kv: -kv[1])[:12])
    if busy:
        print(f"profile serving ({n} dispatches): wall {out['wall_ms']:.2f} ms, device busy "
              f"{out['device_busy_ms']:.3f} ms, factor_matvec {out['kernel_us_per_dispatch']:.2f} "
              f"us per dispatch, idle share {out['idle_share']:.3f}")
        for k, t in out["top"][:6]:
            print(f"  {t:9.3f} ms  {k}")
        print("  host us per dispatch: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["host_us_per_dispatch"]))
    else:
        print("profile serving: the profiler recorded no device time (not measured)")
    return out


def profile_factor_sweep(torch, fm, dev, gen, n=20, batches=(1, 8, 32, 64, 132, 264, 1024)):
    """Device time per factor_matvec launch at r = 64, 2048 -> 1000 across
    batches, beside the launch plan (clusters, blocks against the card's SMs)
    and the factor bytes every block reads: how the time scales with the
    grid."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    r, n_in, n_out = 64, SERVE_D, SERVE_M
    a, s, b = (torch.randn(r, n_in, generator=gen, device=dev), torch.randn(r, device=dev),
               torch.randn(r, n_out, generator=gen, device=dev))
    out = []
    for bt in batches:
        x = torch.randn(bt, n_in, generator=gen, device=dev)
        kern_ms = device_ms(torch, lambda: fm.factor_matvec(x, a, s, b), "factor_matvec_kernel",
                            n)
        plan = fm.kernel.launch_plan(bt, n_in, r, n_out)
        out.append(dict(b=bt, plan=dataclasses.asdict(plan), blocks=plan.blocks, sms=sms,
                        factor_bytes_per_block=4 * r * (plan.chunk_width + plan.out_cols),
                        device_us=1e3 * kern_ms if kern_ms else None))
        print(f"profile factor_matvec b={bt:4d}: {plan.batch_tiles} clusters of "
              f"{fm.kernel.CLUSTER} blocks ({plan.blocks} blocks on {sms} SMs; batch tiles of "
              f"{plan.batch_tile} rows, n_in in {plan.chunks} chunks of {plan.chunk_width}, "
              f"{plan.out_cols} out columns a block), device {out[-1]['device_us']} us per launch")
    return out


LM_ARCH = "qwen2_1_5b"  # full width and depth: 28 layers, d 1536, 12/2 heads, Dh 128
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 64, 32
PREFILL_32K = 32768  # models.config.LM_SHAPES["prefill_32k"].seq_len
FA_HQ, FA_HKV, FA_DH = 12, 2, 128  # qwen2-1.5b's attention
FA_MAIN = (4, 8192)  # (B, S) of the main path's prefill
FA_ALL_ROWS = 4096  # up to this S every row is checked and the plain version runs whole


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, kv) pairs the function scores: all, or top-left causal."""
    if not causal:
        return sq * skv
    n = min(sq, skv)
    return n * (n + 1) // 2 + max(0, sq - skv) * skv


def sass_counts(_build, lib: str, opcode: str, fn_part: str):
    """Instructions of ``opcode`` in each kernel of the built library ``lib``
    whose name holds ``fn_part`` (SASS from cuobjdump, beside nvcc)."""
    so = _build.library_path(lib)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif opcode in line and fn is not None and fn_part in fn:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def hgmma_counts(_build):
    """HGMMA instructions in each wgmma kernel of the built flash_attention
    library's SASS."""
    return sass_counts(_build, "flash_attention", "HGMMA", "wgmma")


def flash_kernel_phase(torch, fa, kernels, _build, dev, gen, reps, peaks):
    """flash_attention against its plain version: the main path's shape (B 4,
    S 8192, causal, bf16), prefill_32k's length (B 1, S 32,768), non-causal
    cases, tiny odd f32 ones and ragged bf16 ones; identical bits on repeat;
    the route each took; the HGMMA count of the wgmma kernels; times of
    kernel, plain version and scaled_dot_product_attention."""
    bw, f32_peak, bf16_peak = peaks[:3]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    counts = hgmma_counts(_build)
    for fn, n in sorted(counts.items()):
        print(f"  SASS of {fn}: {n} HGMMA instructions")
    check(len(counts) == 2 and all(n > 0 for n in counts.values()),
          f"no HGMMA in the wgmma kernels' SASS: {counts}")

    def routed(call, want):
        """Run ``call`` and check that it launched flash_attention once, on
        route ``want``."""
        before = kernels.route_launches()["flash_attention"]
        out = call()
        after = kernels.route_launches()["flash_attention"]
        moved = {r: after[r] - before[r] for r in after if after[r] != before[r]}
        check(moved == {want: 1}, f"flash_attention took {moved}, expected {{{want!r}: 1}}")
        return out

    def inputs(b, hq, hkv, sq, skv, dh, dtype):
        return [torch.randn(b, h, s, dh, generator=gen, device=dev).to(dtype)
                for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]

    def plain(q, k, v, scale, causal, chunk=1024):
        """The plain version; past 4096 rows over 1024-row query chunks (the
        whole score matrix would take 13 GB at the main shape, 52 GB at 32k)."""
        if q.shape[2] <= FA_ALL_ROWS:
            return fa.ref.attention(q, k, v, scale=scale, causal=causal)
        return torch.cat([fa.ref.attention(q[:, :, i:i + chunk], k, v, scale=scale,
                                           causal=causal, q_offset=i)
                          for i in range(0, q.shape[2], chunk)], dim=2)

    def error(got, q, k, v, scale, causal):
        """Each query row against its own max|plain|, the plain version on the
        f32 upcast: every row up to S = 4096, else the first and last 256
        query rows. Returns max |kernel - plain|, the worst row's share of its
        max|plain|, and that share over the last span alone (the rows that
        average the most keys, whose values are the smallest)."""
        sq = q.shape[2]
        spans = [(0, sq)] if sq <= FA_ALL_ROWS else [(0, 256), (sq - 256, sq)]
        diff = worst = 0.0
        for lo, hi in spans:
            want = fa.ref.attention(q[:, :, lo:hi].float(), k.float(), v.float(), scale=scale,
                                    causal=causal, q_offset=lo)
            row_diff = (got[:, :, lo:hi].float() - want).abs().amax(-1)
            row_rel = float((row_diff / want.abs().amax(-1).clamp_min(1e-30)).max())
            diff, worst = max(diff, float(row_diff.max())), max(worst, row_rel)
            del want, row_diff
        return diff, worst, row_rel

    rows_out = []
    big = [  # (label, b, sq, causal, dtype, reps)
        ("main path", *FA_MAIN, True, torch.bfloat16, max(3, reps // 3)),
        ("prefill_32k length", 1, PREFILL_32K, True, torch.bfloat16, 3),
        ("non-causal", 1, FA_ALL_ROWS, False, torch.bfloat16, reps),
        ("non-causal f32", 1, FA_ALL_ROWS, False, torch.float32, reps),
    ]
    for label, b, s, causal, dtype, nrep in big:
        q, k, v = inputs(b, FA_HQ, FA_HKV, s, s, FA_DH, dtype)
        scale = FA_DH ** -0.5
        route = "wgmma" if dtype == torch.bfloat16 else "generic"
        got = routed(lambda: fa.flash_attention(q, k, v, scale=scale, causal=causal), route)
        torch.cuda.synchronize()
        err_abs, err_rel, err_last = error(got, q, k, v, scale, causal)
        tol = TOL["flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention"]
        check(math.isfinite(err_rel) and err_rel <= tol,
              f"flash_attention {label}: row-relative err {err_rel:.3e} > {tol:.0e}")
        check(torch.equal(fa.flash_attention(q, k, v, scale=scale, causal=causal), got),
              f"flash_attention {label} is not bit-stable")
        del got
        esize = torch.tensor([], dtype=dtype).element_size()
        nbytes = esize * (2 * b * FA_HQ * s * FA_DH + 2 * b * FA_HKV * s * FA_DH)
        nflops = 4 * FA_DH * b * FA_HQ * attention_pairs(s, s, causal)
        peak = bf16_peak if dtype == torch.bfloat16 else f32_peak
        row = dict(
            name="flash_attention", operand=f"{label}: B={b} Hq={FA_HQ} Hkv={FA_HKV} S={s} "
            f"Dh={FA_DH} {'causal' if causal else 'full'} {str(dtype)[6:]}",
            shape=[b, FA_HQ, FA_HKV, s, s, FA_DH], max_abs_err=err_abs, max_rel_err=err_rel,
            last_rows_rel_err=err_last, tol=tol,
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale=scale, causal=causal),
                       nrep),
            plain_ms=time_ms(torch, lambda: plain(q, k, v, scale, causal), nrep),
            library_ms=time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True,
                                                   scale=scale), nrep),
            bound_ms=1e3 * max(nbytes / bw, nflops / peak),
            bound_by="bytes" if nbytes / bw >= nflops / peak else "operations",
            bytes=nbytes, flops=nflops, main=label == "main path", route=route)
        if route == "wgmma":
            # the p_hi/p_lo split issues the P.V products twice: 1.5x the work
            row["split_floor_ms"] = 1.5 * 1e3 * nflops / peak
        row["tflops"] = nflops / row["ms"] / 1e9
        rows_out.append(row)
        print(f"kernel flash_attention {row['operand']} ({route} route): {row['ms']:.3f} ms "
              f"({row['tflops']:.1f} TFLOP/s; plain {row['plain_ms']:.3f}, sdpa "
              f"{row['library_ms']:.3f}, bound {row['bound_ms']:.4f} by {row['bound_by']}"
              + (f", split floor {row['split_floor_ms']:.4f}" if route == "wgmma" else "")
              + f") row-relative err {err_rel:.2e}, last rows {err_last:.2e} (limit {tol:.0e}), "
              "bit-stable")
        del q, k, v
        torch.cuda.empty_cache()

    # tiny odd f32 shapes: ragged Sq / Skv, Dh 12 and 16, group sizes 1, 2, 8
    for dh in (12, 16):
        for hkv in (8, 4, 1):
            for causal in (True, False):
                for sq, skv in ((50, 70), (70, 50)):
                    q, k, v = inputs(2, 8, hkv, sq, skv, dh, torch.float32)
                    got = routed(lambda: fa.flash_attention(q, k, v, scale=dh ** -0.5,
                                                            causal=causal), "generic")
                    err = error(got, q, k, v, dh ** -0.5, causal)[1]
                    check(err <= TOL["flash_attention"],
                          f"flash_attention Sq {sq} Skv {skv} Dh {dh} Hkv {hkv} causal {causal}: "
                          f"row-relative err {err:.3e}")
                    check(torch.equal(fa.flash_attention(q, k, v, scale=dh ** -0.5,
                                                         causal=causal), got),
                          f"flash_attention Sq {sq} Dh {dh} is not bit-stable")
    # ragged bf16 shapes around the wgmma route's 128-row tiles: Sq != Skv
    # both ways, group sizes 1, 2 and 6, Dh 64 and 128
    for dh in (64, 128):
        for hq, hkv, sq, skv in ((2, 2, 127, 129), (6, 1, 129, 300), (4, 2, 300, 127)):
            for causal in (True, False):
                q, k, v = inputs(1, hq, hkv, sq, skv, dh, torch.bfloat16)
                got = routed(lambda: fa.flash_attention(q, k, v, scale=dh ** -0.5,
                                                        causal=causal), "wgmma")
                err = error(got, q, k, v, dh ** -0.5, causal)[1]
                check(err <= TOL["flash_attention_bf16"],
                      f"flash_attention bf16 Sq {sq} Skv {skv} Dh {dh} Hq/Hkv {hq}/{hkv} causal "
                      f"{causal}: row-relative err {err:.3e}")
                check(torch.equal(fa.flash_attention(q, k, v, scale=dh ** -0.5,
                                                     causal=causal), got),
                      f"flash_attention bf16 Sq {sq} Skv {skv} Dh {dh} is not bit-stable")
    print("flash_attention matches its plain version at the main path's shape, at 32k, "
          "non-causal, at odd f32 shapes (generic route) and ragged bf16 ones (wgmma route); "
          "bit-stable")
    return rows_out, counts


def lm_prefill_phase(torch, kernels, lm, steps, cfg, dev, gen, args):
    """Phase 14: ``make_prefill_step`` on --lm-batch random prompts of --lm-seq
    tokens, weights drawn on the card. The run with the counters set to 0
    is the main path; three more give the time."""
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    rep = dict(arch=cfg.name, layers=cfg.num_layers, batch=args.lm_batch, seq=args.lm_seq,
               params=lm.param_count(params), init_s=time.perf_counter() - t0)
    toks = torch.randint(0, cfg.vocab_size, (args.lm_batch, args.lm_seq), generator=gen,
                         device=dev)
    step = steps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    last, cache = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    rep["first_ms"] = 1e3 * (time.perf_counter() - t0)
    launches = kernels.launches()
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.num_layers
    check(launches == want, f"prefill: launches {launches} != {want}")
    routes = kernels.route_launches()["flash_attention"]
    check(routes == {"wgmma": cfg.num_layers, "generic": 0},
          f"prefill: flash_attention routes {routes}, expected every layer on wgmma")
    rep["routes"] = routes
    rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    kv_shape = (cfg.num_layers, args.lm_batch, cfg.num_kv_heads, args.lm_seq, cfg.head_dim_)
    check(tuple(last.shape) == (args.lm_batch, cfg.vocab_size), f"prefill logits {last.shape}")
    check(bool(torch.isfinite(last).all()), "prefill: non-finite last-position logits")
    check(tuple(cache["k"].shape) == kv_shape and tuple(cache["v"].shape) == kv_shape,
          f"prefill cache {tuple(cache['k'].shape)} != {kv_shape}")
    check(bool(torch.isfinite(cache["k"]).all() and torch.isfinite(cache["v"]).all()),
          "prefill: non-finite cache")
    del last, cache
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    med = statistics.median(times)
    rep.update(ms=[1e3 * t for t in times], ms_median=1e3 * med,
               tokens_per_s=args.lm_batch * args.lm_seq / med, launches=launches)
    print(f"prefill {cfg.name} ({cfg.num_layers} layers, {rep['params']} parameters, "
          f"{cfg.dtype}) on {args.lm_batch} x {args.lm_seq} tokens: median {rep['ms_median']:.1f} "
          f"ms ({rep['tokens_per_s']:.0f} tokens/s; first {rep['first_ms']:.1f} ms), peak "
          f"{rep['peak_gb']:.2f} GB, {cfg.num_layers} flash_attention launches, all on wgmma; "
          f"last logits {(args.lm_batch, cfg.vocab_size)} finite, cache {kv_shape}")
    return rep, launches, params, toks


def lm_decode_phase(torch, np, kernels, lm_serve, cfg, dev, seed):
    """Phase 15: ``generate`` at full width: the prompt fed token by token,
    then greedy decoding; no launch of the flash kernel (decode attention is
    the dense path, as in the reference)."""
    stats = {}
    kernels.reset_launches()
    new = lm_serve.generate(arch=LM_ARCH, smoke=False, batch=DECODE_BATCH,
                            prompt_len=DECODE_PROMPT, max_new_tokens=DECODE_NEW, seed=seed,
                            device=dev, stats=stats)
    launches = kernels.launches()
    check(all(v == 0 for v in launches.values()), f"decode: launches {launches}")
    check(new.shape == (DECODE_BATCH, DECODE_NEW) and int(new.min()) >= 0
          and int(new.max()) < cfg.vocab_size, f"decode: tokens {new.shape} out of range")
    rep = dict(stats, batch=DECODE_BATCH, prompt_len=DECODE_PROMPT, new_tokens=DECODE_NEW,
               ms_per_token=stats["ms_per_step"], distinct_tokens=int(np.unique(new).size))
    print(f"decode {cfg.name} at batch {DECODE_BATCH}: {stats['steps']} steps in "
          f"{stats['loop_s']:.2f} s, {rep['ms_per_token']:.2f} ms per step; tokens in range, "
          f"0 flash_attention launches")
    return rep, launches


def prefill_vs_decode(torch, lm, steps, cfg, params, toks):
    """Last-position logits of the prefill (flash kernel) and of decode_step
    fed the prompt token by token (dense path): max diff / max |decode|."""
    last, _ = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    cache = lm.init_cache(cfg, toks.shape[0], toks.shape[1], device=toks.device)
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(params, cache, {"tokens": toks[:, t:t + 1],
                                                       "cache_pos": t}, cfg)
    return rel_err(torch, last.float(), logits[:, 0].float())[1]


def lm_crosscheck_phase(torch, lm, steps, get_config, kernels, cfg, params16, dev, gen):
    """Phase 16: (a) full width in f32 and (b) in bf16, prefill against
    token-by-token decode on 4 prompts of 64 tokens; (c) the smoke config's
    prefill on the card against the CPU with the same weights, f32."""
    rep = {}
    toks = torch.randint(0, cfg.vocab_size, (4, DECODE_PROMPT), generator=gen, device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = lm.init_params(cfg32, gen)
    kernels.reset_launches()
    rep["f32_rel_err"] = prefill_vs_decode(torch, lm, steps, cfg32, params32, toks)
    check(kernels.launches()["flash_attention"] == cfg.num_layers,
          "f32 prefill did not launch the flash kernel once per layer")
    check(rep["f32_rel_err"] <= TOL["lm_f32"],
          f"full-width f32: prefill vs decode rel err {rep['f32_rel_err']:.3e}")
    del params32
    torch.cuda.empty_cache()
    rep["bf16_rel_err"] = prefill_vs_decode(torch, lm, steps, cfg, params16, toks)
    check(rep["bf16_rel_err"] <= TOL["lm_bf16"],
          f"full-width bf16: prefill vs decode rel err {rep['bf16_rel_err']:.3e}")

    small = get_config(LM_ARCH, smoke=True)
    cpu_params = lm.init_params(small, 7, device="cpu")

    stoks = torch.randint(0, small.vocab_size, (2, 100), generator=torch.Generator().manual_seed(7))
    on_card = lm.forward(tree_to(torch, cpu_params, dev), {"tokens": stoks.to(dev)}, small,
                         mode="prefill")
    on_cpu = lm.forward(cpu_params, {"tokens": stoks}, small, mode="prefill")
    worst = 0.0
    for got, want in ((on_card["logits"], on_cpu["logits"]),
                      (on_card["cache"]["k"], on_cpu["cache"]["k"]),
                      (on_card["cache"]["v"], on_cpu["cache"]["v"])):
        got = got.cpu()
        bound = TOL["lm_card_cpu"] * want.abs() + 1e-5 * float(want.abs().max())
        check(bool(((got - want).abs() <= bound).all()),
              "smoke prefill: card differs from the CPU beyond rtol 1e-4")
        worst = max(worst, float(((got - want).abs() / (want.abs() + 1e-30)).max()))
    rep["smoke_card_vs_cpu_max_rel"] = worst
    print(f"prefill vs decode at full width: f32 rel err {rep['f32_rel_err']:.2e} (tolerance "
          f"{TOL['lm_f32']:.0e}), bf16 {rep['bf16_rel_err']:.2e} ({TOL['lm_bf16']:.0e}); smoke "
          f"prefill card vs CPU within rtol {TOL['lm_card_cpu']:.0e}")
    return rep


def profile_lm(torch, lm_serve, steps, cfg, params, toks, dev, seed):
    """Device time by kernel and the idle share of one prefill and of a
    short decode (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    step = steps.make_prefill_step(cfg)
    runs = (("prefill", lambda: step(params, {"tokens": toks})),
            ("decode", lambda: lm_serve.generate(
                arch=LM_ARCH, smoke=False, batch=DECODE_BATCH, prompt_len=8,
                max_new_tokens=8, seed=seed, device=dev, params=params)))
    for label, run in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        del res
        dev_us = {}
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                dev_us[ev.key] = dev_us.get(ev.key, 0.0) + ev.self_device_time_total
        busy = sum(dev_us.values())
        flash = sum(t for k, t in dev_us.items() if any(f in k for f in FLASH_KERNELS))
        out[label] = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                          flash_ms=flash / 1e3, idle_share=1.0 - busy / wall_us if busy else None,
                          top=sorted(((k[:90], t / 1e3) for k, t in dev_us.items()),
                                     key=lambda kv: -kv[1])[:10])
        if busy:
            print(f"profile {label}: wall {out[label]['wall_ms']:.1f} ms, device busy "
                  f"{out[label]['device_busy_ms']:.1f} ms (flash_attention "
                  f"{out[label]['flash_ms']:.1f}), idle share {out[label]['idle_share']:.3f}")
            for k, t in out[label]["top"][:8]:
                print(f"  {t:9.2f} ms  {k}")
        else:
            print(f"profile {label}: the profiler recorded no device time (not measured)")
    return out


SSM_ARCH = "rwkv6_7b"  # full width: 32 layers, d 4096, 64 heads of 64, d_ff 14,336, vocab 65,536
SSM_BATCH, SSM_SEQ = 4, 4096  # prompts x tokens of the main path's prefill (Finch's context)
WKV_HEADS, WKV_Q, WKV_D = 64, 256, 64  # rwkv6-7b's heads, ssm_chunk and head size
# Chunk of the prefill-vs-decode check at 64 tokens: at full width some
# channel's cumulative log decay passes -80 within 64 tokens (-86.7 in the
# f32 run), so one chunk of 64 lets the clamps bind; two chunks of 32 do not,
# and carry the state across a chunk boundary.
XCHECK_CHUNK = 32


# Decay laws of phase 17: logw = -exp(w), w ~ N(mean, sd). "model" is the
# model's law (about a quarter of the (position, channel) pairs of a 256-token
# chunk pass -80, so the clamps bind); "saturating" puts logw near -1, so cw
# reaches about -256 and almost every pair saturates; "slow" puts it near
# -1e-3, so no clamp binds.
DECAYS = {"model": (-1.0, 0.6), "saturating": (0.0, 0.05), "slow": (math.log(1e-3), 0.05)}


def wkv_inputs(torch, gen, dev, b, h, q, dk, dv, dtype, wdtype, decay="model"):
    """r, k ~ N(0, 0.25), v ~ N(0, 1), logw from the decay law ``decay``
    (``DECAYS``), u and S_in nonzero."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    mean, sd = DECAYS[decay]
    r, k = (randn(b, h, q, dk) * 0.5).to(dtype), (randn(b, h, q, dk) * 0.5).to(dtype)
    v = randn(b, h, q, dv).to(dtype)
    logw = (-torch.exp(randn(b, h, q, dk) * sd + mean)).to(wdtype)
    return r, k, v, logw, randn(h, dk) * 0.5, randn(b, h, dk, dv) * 0.3


def wkv_errors(torch, wkv, got, args):
    """Kernel against the plain chunk form taken in f64 on the same inputs:
    (max |y diff|, the worst (head, row) of y against its own max, S_out's
    max diff against its max)."""
    y, s = got
    y64, s64 = wkv.ref.wkv6_chunk_factored(*args, dtype=torch.float64)
    row_diff = (y.double() - y64).abs().amax(-1)
    row_rel = float((row_diff / y64.abs().amax(-1).clamp_min(1e-30)).max())
    s_rel = float((s.double() - s64).abs().max() / s64.abs().max())
    return float(row_diff.max()), row_rel, s_rel


def wkv_work(b, h, q, dk, dv, esize, wsize):
    """(bytes, flop) of one chunk: inputs read once, y and S_out written
    once; the strictly lower triangle of R K^T and of A V, the inter-chunk
    and state products, the bonus."""
    pairs = q * (q - 1) // 2
    nbytes = b * h * ((2 * q * dk + q * dv) * esize + q * dk * wsize)
    nbytes += 4 * h * dk + 4 * b * h * (2 * dk * dv + q * dv)
    flops = b * h * (2 * pairs * (dk + dv) + 4 * q * dk * dv + 3 * q * dk + 2 * q * dv)
    return nbytes, flops


def wkv6_kernel_phase(torch, wkv, _build, dev, gen, reps, peaks):
    """Phase 17: wkv6_chunk against its plain chunk form at the main path's
    shape (B 4, H 64, q 256, 64, r/k/v bf16, logw f32, clamps binding) and in
    f32, at the two decay extremes in both, against the exact recurrence at
    q = 32, at tiny odd shapes; identical bits on repeat; the HMMA count of
    its SASS; times of kernel, plain chain and exact recurrence."""
    bw, f32_peak, _, tf32_peak = peaks
    tol = TOL["wkv6_chunk"]
    hmma = sass_counts(_build, "wkv6_chunk", "HMMA", "wkv6")
    check(hmma and all(n > 0 for n in hmma.values()),
          f"wkv6_chunk: no HMMA instruction in its SASS ({hmma})")
    print(f"wkv6_chunk SASS: HMMA per instantiation {sorted(hmma.values())}")
    rows_out = []
    big = [("main path", torch.bfloat16, "model"), ("f32", torch.float32, "model"),
           ("saturating", torch.bfloat16, "saturating"),
           ("saturating f32", torch.float32, "saturating"),
           ("slow", torch.bfloat16, "slow"), ("slow f32", torch.float32, "slow")]
    for label, dtype, decay in big:
        b, h, q, d = SSM_BATCH, WKV_HEADS, WKV_Q, WKV_D
        timed = decay == "model"
        args = wkv_inputs(torch, gen, dev, b, h, q, d, d, dtype, torch.float32, decay)
        got = wkv.wkv6_chunk(*args)
        torch.cuda.synchronize()
        err_abs, err_rel, s_rel = wkv_errors(torch, wkv, got, args)
        check(math.isfinite(err_rel) and err_rel <= tol and s_rel <= tol,
              f"wkv6_chunk {label}: row-relative err {err_rel:.3e}, state {s_rel:.3e} > {tol:.0e}")
        y32 = wkv.ref.wkv6_chunk_factored(*args)[0]
        f32_rel = float(((got[0] - y32).abs().amax(-1) / y32.abs().amax(-1)).max())
        again = wkv.wkv6_chunk(*args)
        check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
              f"wkv6_chunk {label} is not bit-stable")
        cw = torch.cumsum(args[3].double(), dim=2)
        past = float((cw < -80).double().mean())
        if decay == "model":
            check(past > 0.1, f"wkv6_chunk {label}: only {past:.3f} of the pairs pass -80")
        del again, y32, cw
        row = dict(
            name="wkv6_chunk", operand=f"{label}: B={b} H={h} q={q} dk=dv={d} "
            f"{str(dtype)[6:]} r/k/v, f32 logw, {decay} decay", shape=[b, h, q, d, d],
            max_abs_err=err_abs, max_rel_err=err_rel, state_rel_err=s_rel,
            rel_err_vs_f32_plain=f32_rel, past_80_share=past, tol=tol,
            main=label == "main path")
        if timed:
            esize = torch.tensor([], dtype=dtype).element_size()
            nbytes, nflops = wkv_work(b, h, q, d, d, esize, 4)
            # 3xTF32: three tensor-core products per f32 product
            by_bytes, by_ops = nbytes / bw, 3 * nflops / tf32_peak
            row.update(
                ms=time_ms(torch, lambda: wkv.wkv6_chunk(*args), max(3, reps)),
                plain_ms=time_ms(torch, lambda: wkv.ref.wkv6_chunk_factored(*args), max(3, reps)),
                exact_ms=time_ms(torch, lambda: wkv.ref.wkv6_chunk(*args), 3),
                library_ms=None, bound_ms=1e3 * max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_f32_cores_ms=1e3 * max(by_bytes, nflops / f32_peak),
                bytes=nbytes, flops=nflops, hmma=hmma)
            row["tflops"] = nflops / row["ms"] / 1e9
        rows_out.append(row)
        timing = (f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s; plain chunk form "
                  f"{row['plain_ms']:.4f}, exact recurrence {row['exact_ms']:.3f}, bound "
                  f"{row['bound_ms']:.4f} by {row['bound_by']} on the TF32 tensor cores in "
                  f"3xTF32, {row['bound_f32_cores_ms']:.4f} on the f32 CUDA cores) "
                  if timed else "")
        print(f"kernel wkv6_chunk {row['operand']}: {timing}row-relative err {err_rel:.2e} "
              f"(state {s_rel:.2e}; limit {tol:.0e}) against the f64 plain version, "
              f"{f32_rel:.2e} against the f32 one; {past:.3f} of the pairs past -80; "
              f"bit-stable")
        del args, got
        torch.cuda.empty_cache()

    # q = 32: no clamp binds, the chunk form is the exact recurrence
    for dtype in (torch.bfloat16, torch.float32):
        args = wkv_inputs(torch, gen, dev, SSM_BATCH, WKV_HEADS, 32, WKV_D, WKV_D, dtype,
                          torch.float32)
        y, s = wkv.wkv6_chunk(*args)
        ye, se = wkv.ref.wkv6_chunk(*args)
        for got, want in ((y, ye), (s, se)):
            excess = float(((got - want).abs() - TOL["wkv6_exact"] * (1 + want.abs())).max())
            check(excess <= 0, f"wkv6_chunk q=32 {dtype}: not within rtol = atol = 2e-4 of "
                  "the exact recurrence")
    # tiny odd shapes: q 50, 7, 1; BH = 3 both ways; dk, dv 16 / 32; logw in bf16
    for b, h, q, dk, dv in ((1, 3, 50, 64, 64), (3, 1, 7, 64, 64), (3, 1, 1, 64, 64),
                            (1, 3, 100, 16, 32), (2, 2, 320, 48, 64), (1, 2, 192, 64, 64),
                            (2, 1, 255, 64, 64)):
        for dtype, wdtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                              (torch.bfloat16, torch.bfloat16)):
            args = wkv_inputs(torch, gen, dev, b, h, q, dk, dv, dtype, wdtype)
            got = wkv.wkv6_chunk(*args)
            _, err, s_err = wkv_errors(torch, wkv, got, args)
            check(err <= tol and s_err <= tol,
                  f"wkv6_chunk B {b} H {h} q {q} dk {dk} dv {dv} {dtype}/{wdtype}: row-relative "
                  f"err {err:.3e}, state {s_err:.3e}")
            again = wkv.wkv6_chunk(*args)
            check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
                  f"wkv6_chunk q {q} is not bit-stable")
    print("wkv6_chunk matches its plain chunk form at the main path's shape (clamps binding), "
          "in f32, at both decay extremes and at odd shapes, and the exact recurrence at "
          "q = 32; bit-stable")
    return rows_out


def decay_recorder(torch, rwkv6):
    """Wrap the model's chunk call to record the least in-chunk cumulative
    log decay and the share of (position, channel) pairs past -80 (the
    launches still go through ``ops.wkv6_chunk``). Returns (stats, undo)."""
    import types

    ops = rwkv6.wkv_ops
    stats = {"min_cw": 0.0, "past": 0, "pairs": 0}

    def recorded(r, k, v, logw, u, s0, *, out=None):
        cw = torch.cumsum(logw.double(), dim=2)
        stats["min_cw"] = min(stats["min_cw"], float(cw.min()))
        stats["past"] += int((cw < -80).sum())
        stats["pairs"] += cw.numel()
        return ops.wkv6_chunk(r, k, v, logw, u, s0, out=out)

    rwkv6.wkv_ops = types.SimpleNamespace(wkv6_chunk=recorded)

    def undo():
        rwkv6.wkv_ops = ops

    return stats, undo


def nonzero_bonus(torch, params, gen):
    """Redraw every layer's u_bonus N(0, 0.5^2): the reference inits it to
    zeros, which would hide the bonus term."""
    for lp in params["layers"]:
        u = lp["tm_cm"]["u_bonus"]
        u.copy_(torch.randn(u.shape, generator=gen, device=u.device) * 0.5)


def ssm_prefill_phase(torch, kernels, lm, steps, cfg, dev, gen, args):
    """Phase 18: ``make_prefill_step`` on --ssm-batch random prompts of
    --ssm-seq tokens, weights drawn on the card (u_bonus redrawn nonzero).
    The run with the counters set to 0 is the main path; three more give the
    time."""
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    nonzero_bonus(torch, params, gen)
    torch.cuda.synchronize()
    rep = dict(arch=cfg.name, layers=cfg.num_layers, batch=args.ssm_batch, seq=args.ssm_seq,
               chunk=cfg.ssm_chunk, params=lm.param_count(params),
               init_s=time.perf_counter() - t0)
    toks = torch.randint(0, cfg.vocab_size, (args.ssm_batch, args.ssm_seq), generator=gen,
                         device=dev)
    step = steps.make_prefill_step(cfg)
    q = min(cfg.ssm_chunk, args.ssm_seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    last, cache = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    rep["first_ms"] = 1e3 * (time.perf_counter() - t0)
    launches = kernels.launches()
    want = dict.fromkeys(launches, 0)
    want["wkv6_chunk"] = cfg.num_layers * (args.ssm_seq // q)
    check(launches == want, f"ssm prefill: launches {launches} != {want}")
    rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    h = cfg.d_model // 64
    shapes = {"s": (cfg.num_layers, args.ssm_batch, h, 64, 64),
              "x_tm": (cfg.num_layers, args.ssm_batch, cfg.d_model),
              "x_cm": (cfg.num_layers, args.ssm_batch, cfg.d_model)}
    check(tuple(last.shape) == (args.ssm_batch, cfg.vocab_size), f"ssm logits {last.shape}")
    check(bool(torch.isfinite(last).all()), "ssm prefill: non-finite last-position logits")
    for name, shape in shapes.items():
        check(tuple(cache[name].shape) == shape and cache[name].dtype == torch.float32,
              f"ssm prefill cache {name} {tuple(cache[name].shape)} != {shape} f32")
        check(bool(torch.isfinite(cache[name]).all()), f"ssm prefill: non-finite cache {name}")
    del last, cache
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    med = statistics.median(times)
    rep.update(ms=[1e3 * t for t in times], ms_median=1e3 * med,
               tokens_per_s=args.ssm_batch * args.ssm_seq / med, launches=launches)
    print(f"prefill {cfg.name} ({cfg.num_layers} layers, {rep['params']} parameters, "
          f"{cfg.dtype}, chunk {q}) on {args.ssm_batch} x {args.ssm_seq} tokens: median "
          f"{rep['ms_median']:.1f} ms ({rep['tokens_per_s']:.0f} tokens/s; first "
          f"{rep['first_ms']:.1f} ms), peak {rep['peak_gb']:.2f} GB, {want['wkv6_chunk']} "
          f"wkv6_chunk launches; last logits finite, caches {shapes}")
    return rep, launches, params, toks


def ssm_decode_phase(torch, np, kernels, lm_serve, cfg, params, dev, seed):
    """Phase 19: ``generate`` at full width with the prefill's weights: the
    prompt fed token by token, then greedy decoding; no wkv6_chunk launch
    (decode is the exact recurrence in plain PyTorch, as in the reference)."""
    stats = {}
    kernels.reset_launches()
    new = lm_serve.generate(arch=SSM_ARCH, smoke=False, batch=DECODE_BATCH,
                            prompt_len=DECODE_PROMPT, max_new_tokens=DECODE_NEW, seed=seed,
                            device=dev, params=params, stats=stats)
    launches = kernels.launches()
    check(all(v == 0 for v in launches.values()), f"ssm decode: launches {launches}")
    check(new.shape == (DECODE_BATCH, DECODE_NEW) and int(new.min()) >= 0
          and int(new.max()) < cfg.vocab_size, f"ssm decode: tokens {new.shape} out of range")
    rep = dict(stats, batch=DECODE_BATCH, prompt_len=DECODE_PROMPT, new_tokens=DECODE_NEW,
               layers=len(params["layers"]), ms_per_token=stats["ms_per_step"],
               distinct_tokens=int(np.unique(new).size))
    print(f"decode {cfg.name} at batch {DECODE_BATCH}: {stats['steps']} steps in "
          f"{stats['loop_s']:.2f} s, {rep['ms_per_token']:.2f} ms per step; tokens in range, "
          f"0 wkv6_chunk launches")
    return rep, launches


def ssm_prefill_vs_decode(torch, lm, steps, rwkv6, cfg, params, toks):
    """Prefill (the kernel) and decode_step fed the prompt token by token
    (the exact recurrence). Returns the report (the last logits' and each
    layer's caches' max diff / max |decode|, the prefill's least in-chunk cw
    and share of pairs past -80), both paths' last logits and decode's
    cache."""
    stats, undo = decay_recorder(torch, rwkv6)
    try:
        last, pcache = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    finally:
        undo()
    cache = lm.init_cache(cfg, toks.shape[0], toks.shape[1], device=toks.device)
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(params, cache, {"tokens": toks[:, t:t + 1],
                                                       "cache_pos": t}, cfg)
    out = dict(logits=rel_err(torch, last.float(), logits[:, 0].float())[1],
               min_cw=stats["min_cw"], past_80_share=stats["past"] / max(stats["pairs"], 1))
    for name in ("s", "x_tm", "x_cm"):
        out[name] = [rel_err(torch, pcache[name][i], cache[name][i])[1]
                     for i in range(len(params["layers"]))]
    return out, last.float(), logits[:, 0].float(), cache




def ssm_crosscheck_phase(torch, lm, steps, rwkv6, get_config, kernels, cfg, params16, dev,
                         gen):
    """Phase 20: (a) full width, prefill against token-by-token decode on 4
    prompts of 64 tokens (two chunks of 32: no clamp binds), in f32 (an f32
    copy of the bf16 weights) and in bf16, each bf16 path also against the
    f32 one; (b) bf16 at 256 tokens (one chunk of 256: the clamps bind),
    layer 0's caches held, the rest reported (caveat (e)); (c) the smoke
    config's prefill on the card against the CPU at chunk 32 and at chunk
    256 over 512 tokens, f32. Every comparison is printed before any is
    held."""
    rep, failures = {}, []
    toks = torch.randint(0, cfg.vocab_size, (4, DECODE_PROMPT), generator=gen, device=dev)
    n_chunks = DECODE_PROMPT // XCHECK_CHUNK
    lasts = {}
    for label in ("f32", "bf16"):
        if label == "f32":  # an f32 copy of the weights (30 GB) beside the bf16 one
            c = dataclasses.replace(cfg, dtype="float32", ssm_chunk=XCHECK_CHUNK)
            p = tree_to(torch, params16, torch.float32)
        else:
            c = dataclasses.replace(cfg, ssm_chunk=XCHECK_CHUNK)
            p = params16
        kernels.reset_launches()
        r, pre, dec, cache = ssm_prefill_vs_decode(torch, lm, steps, rwkv6, c, p, toks)
        lasts[label] = (pre, dec, cache)
        check(kernels.launches()["wkv6_chunk"] == c.num_layers * n_chunks,
              f"{label} ssm prefill at 64 tokens: not {n_chunks} wkv6_chunk launches per layer")
        check(r["min_cw"] > -80, f"{label}: an in-chunk cw reached {r['min_cw']:.1f} in chunks "
              f"of {XCHECK_CHUNK}; the clamps bind")
        r["worst"] = {n: max(r[n]) for n in ("s", "x_tm", "x_cm")}
        rep[f"{label}_64"] = r
        del p
        torch.cuda.empty_cache()
    # bf16's own noise: how far bf16 decode (plain PyTorch, no kernel) lands from
    # the f32 computation on the same weights, for the logits and each cache
    (p32, d32, c32), (p16, d16, c16) = lasts["f32"], lasts["bf16"]
    r16 = rep["bf16_64"]
    noise = {"logits": rel_err(torch, d16, d32)[1]}
    for name in ("s", "x_tm", "x_cm"):
        noise[name] = max(rel_err(torch, c16[name][i], c32[name][i])[1]
                          for i in range(c16[name].shape[0]))
    r16.update(prefill_vs_f32=rel_err(torch, p16, p32)[1], noise=noise)
    r = rep["f32_64"]
    w, tol = r["worst"], TOL["lm_f32"]
    print(f"ssm prefill vs decode at full width, f32, 64 tokens in {n_chunks} chunks of "
          f"{XCHECK_CHUNK}: logits rel err {r['logits']:.2e}, caches s {w['s']:.2e} x_tm "
          f"{w['x_tm']:.2e} x_cm {w['x_cm']:.2e} (tolerance {tol:.0e}); least in-chunk cw "
          f"{r['min_cw']:.2f}, no pair past -80")
    if not (r["logits"] <= tol and all(v <= tol for v in w.values())):
        failures.append(f"full-width f32 ssm: prefill vs decode logits {r['logits']:.3e}, caches "
                        f"{w} (tolerance {tol:.0e})")
    w = r16["worst"]
    print(f"ssm prefill vs decode at full width, bf16, 64 tokens in {n_chunks} chunks of "
          f"{XCHECK_CHUNK}: logits rel err {r16['logits']:.2e}, caches s {w['s']:.2e} x_tm "
          f"{w['x_tm']:.2e} x_cm {w['x_cm']:.2e}, each held to bf16 decode's own distance from "
          f"the f32 computation (logits {noise['logits']:.2e}, s {noise['s']:.2e}, x_tm "
          f"{noise['x_tm']:.2e}, x_cm {noise['x_cm']:.2e}); bf16 prefill from f32 "
          f"{r16['prefill_vs_f32']:.2e}, held to {TOL['ssm_bf16_excess']} x decode's; least "
          f"in-chunk cw {r16['min_cw']:.2f}; the dense family's 5e-2 "
          f"{'met' if max(r16['logits'], *w.values()) <= TOL['lm_bf16'] else 'not met'}")
    if not (r16["logits"] <= noise["logits"] and all(w[n] <= noise[n] for n in w)
            and r16["prefill_vs_f32"] <= TOL["ssm_bf16_excess"] * noise["logits"]):
        failures.append(f"full-width bf16 ssm: prefill vs decode logits {r16['logits']:.3e}, "
                        f"caches {w}, prefill from f32 {r16['prefill_vs_f32']:.3e}, beyond bf16 "
                        f"decode's own distance from f32 {noise}")
    del lasts, p32, d32, c32, p16, d16, c16

    toks = torch.randint(0, cfg.vocab_size, (4, WKV_Q), generator=gen, device=dev)
    # layer 0 sees the same inputs on both paths; its caches agree up to bf16 rounding
    r = ssm_prefill_vs_decode(torch, lm, steps, rwkv6, cfg, params16, toks)[0]
    if not (r["s"][0] <= TOL["lm_bf16"] and r["x_tm"][0] <= TOL["lm_bf16"]):
        failures.append(f"bf16 ssm at {WKV_Q} tokens: layer 0's caches differ (s "
                        f"{r['s'][0]:.3e}, x_tm {r['x_tm'][0]:.3e})")
    rep[f"bf16_{WKV_Q}"] = r
    print(f"ssm prefill vs decode at full width, bf16, {WKV_Q} tokens (clamps bind: "
          f"{r['past_80_share']:.3f} of the pairs past -80, least cw {r['min_cw']:.1f}): layer 0 "
          f"s {r['s'][0]:.2e}, x_tm {r['x_tm'][0]:.2e} (held to {TOL['lm_bf16']:.0e}); reported, "
          f"not held (ROADMAP caveat (e)): logits {r['logits']:.2e}, x_cm of layer 0 "
          f"{r['x_cm'][0]:.2e}, layers 1+ s up to {max(r['s'][1:], default=0):.2e}")

    worst = 0.0
    for chunk, seq in ((32, 96), (256, 512)):
        small = dataclasses.replace(get_config(SSM_ARCH, smoke=True), ssm_chunk=chunk)
        cpu_params = lm.init_params(small, 7, device="cpu")
        nonzero_bonus(torch, cpu_params, torch.Generator().manual_seed(7))
        stoks = torch.randint(0, small.vocab_size, (2, seq),
                              generator=torch.Generator().manual_seed(7))
        kernels.reset_launches()
        on_card = lm.forward(tree_to(torch, cpu_params, dev), {"tokens": stoks.to(dev)}, small,
                             mode="prefill")
        check(kernels.launches()["wkv6_chunk"] == small.num_layers * seq // chunk,
              f"smoke ssm prefill at chunk {chunk}: wkv6_chunk launches {kernels.launches()}")
        on_cpu = lm.forward(cpu_params, {"tokens": stoks}, small, mode="prefill")
        pairs = [(on_card["logits"], on_cpu["logits"])] + [
            (on_card["cache"][n], on_cpu["cache"][n]) for n in ("s", "x_tm", "x_cm")]
        for got, want in pairs:
            got = got.cpu()
            bound = TOL["lm_card_cpu"] * want.abs() + 1e-5 * float(want.abs().max())
            if not bool(((got - want).abs() <= bound).all()):
                failures.append(f"smoke ssm prefill at chunk {chunk}: card differs from the CPU "
                                "beyond rtol 1e-4")
            worst = max(worst, rel_err(torch, got, want)[1])
    rep["smoke_card_vs_cpu_rel"] = worst
    print(f"smoke ssm prefill card vs CPU at chunk 32 (96 tokens) and 256 (512 tokens, clamps "
          f"binding): max diff {worst:.2e} of max, within rtol {TOL['lm_card_cpu']:.0e}")
    check(not failures, "; ".join(failures))
    return rep


def profile_ssm(torch, lm_serve, steps, cfg, params, toks, dev, seed):
    """Device time by kernel and the idle share of one ssm prefill and of a
    short decode (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    step = steps.make_prefill_step(cfg)
    runs = (("prefill", lambda: step(params, {"tokens": toks})),
            ("decode", lambda: lm_serve.generate(
                arch=SSM_ARCH, smoke=False, batch=DECODE_BATCH, prompt_len=8,
                max_new_tokens=8, seed=seed, device=dev, params=params)))
    for label, run in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        del res
        dev_us = {}
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                dev_us[ev.key] = dev_us.get(ev.key, 0.0) + ev.self_device_time_total
        busy = sum(dev_us.values())
        wkv = sum(t for k, t in dev_us.items() if "wkv6_chunk_kernel" in k)
        out[label] = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3, wkv6_ms=wkv / 1e3,
                          idle_share=1.0 - busy / wall_us if busy else None,
                          top=sorted(((k[:90], t / 1e3) for k, t in dev_us.items()),
                                     key=lambda kv: -kv[1])[:10])
        if busy:
            print(f"profile ssm {label}: wall {out[label]['wall_ms']:.1f} ms, device busy "
                  f"{out[label]['device_busy_ms']:.1f} ms (wkv6_chunk "
                  f"{out[label]['wkv6_ms']:.1f}), idle share {out[label]['idle_share']:.3f}")
            for k, t in out[label]["top"][:8]:
                print(f"  {t:9.2f} ms  {k}")
        else:
            print(f"profile ssm {label}: the profiler recorded no device time (not measured)")
    return out



# ---------------------------------------------------------------------------
# Phase 25: the block:k solver tier
# ---------------------------------------------------------------------------

BLOCK_KS = (8, 32)  # block widths of the kernel forms' timings: MC's fits, MTLS's
TABLE1 = dict(d=1024, m=1024, rank=32, n=2048, obs=0.05, budget=160, frac=0.1, k=32)
TABLE1_FLOOR = 5.0  # benchmarks/baselines.json: epochs_to_gap.speedup >= 5x
TABLE1_INSTANCES = 5  # problems the cell's median speedup is taken over (see table1_cell)
# Every problem's own floor: 10% under TABLE1_FLOOR, and under the reference's
# lowest speedup seen (4.77x, its own benchmark cell, JAX 0.9.0 on the CPU)
TABLE1_EACH = 4.5


def block_row(torch, name, label, shape, kfn, pfn, lfn, nbytes, nflops, peaks, reps,
              plain_reps=None, exact=False, main=False):
    """One block form against its plain version at one shape: the error (or
    the bits), the bits on repeat, and the times of kernel, plain version and
    library call beside the bound."""
    bw, flops = peaks[:2]
    got = kfn()
    torch.cuda.synchronize()
    want = pfn()
    if exact:
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{name} {label}: not the plain version's bits")
        err_abs, err_rel = 0.0, 0.0
    else:
        err_abs, err_rel = rel_err(torch, got, want)
        check(math.isfinite(err_rel) and err_rel <= TOL[name],
              f"{name} {label}: max rel err {err_rel:.3e} > {TOL[name]:.0e}")
    again = kfn()
    same = (all(torch.equal(a, b) for a, b in zip(got, again)) if isinstance(got, tuple)
            else torch.equal(got, again))
    check(same, f"{name} {label}: repeated call gave other bits")
    del got, want, again
    row = dict(name=name, operand=label, shape=list(shape), max_abs_err=err_abs,
               max_rel_err=err_rel, ms=time_ms(torch, kfn, reps),
               plain_ms=time_ms(torch, pfn, plain_reps or reps),
               library_ms=time_ms(torch, lfn, reps) if lfn is not None else None,
               bound_ms=1e3 * max(nbytes / bw, nflops / flops),
               bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
               bytes=nbytes, main=main)
    print(f"kernel {name:18s} {label}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
          f"library {row['library_ms']}, bound {row['bound_ms']:.3f} by {row['bound_by']}) "
          f"rel err {err_rel:.2e}, bits repeat")
    return row


def block_dense_kernels(torch, pm, r1, dev, X, Y, gen, reps, peaks):
    """(a) matmat/rmatmat on R and X, the rank-k updates on R (and Y) at
    n = 1,281,167, k = 8 and 32."""
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    R = torch.neg(Y)
    g = torch.full((), 0.3, device=dev)
    a, b, c = 1.0 - g, -g * 1.5, -g
    scal2, scal3 = torch.stack([a, b]), torch.stack([a, b, c])
    rows = []
    out = torch.empty_like(R)
    for k in BLOCK_KS:
        for label, A in (("R", R), ("X", X)):
            n, m = A.shape
            v, u = rn(m, k), rn(n, k)
            nbytes, nflops = 4 * (n * m + (n + m) * k), 2 * n * m * k
            main = label == "X" and k == 32  # block:32's widest pass
            rows.append(block_row(torch, "matmat", f"{label} k={k}", (n, m, k),
                                  lambda: pm.matmat(A, v), lambda: pm.ref.matmat(A, v),
                                  lambda: torch.matmul(A, v), nbytes, nflops, peaks, reps,
                                  main=main))
            rows.append(block_row(torch, "rmatmat", f"{label} k={k}", (n, m, k),
                                  lambda: pm.rmatmat(A, u), lambda: pm.ref.rmatmat(A, u),
                                  lambda: torch.matmul(A.T, u), nbytes, nflops, peaks, reps,
                                  main=main))
            del v, u
        n, m = R.shape
        p_, q_ = rn(n, k), rn(m, k)
        nm = n * m
        rows.append(block_row(
            torch, "rankk_update", f"Z k={k}", (n, m, k),
            lambda: r1.rankk_update(R, p_, q_, a, b, out=out),
            lambda: r1.ref.rankk_update(R, p_, q_, scal2),
            lambda: torch.addmm(R, p_, q_.T, beta=0.7, alpha=-0.45),
            8 * nm + 4 * (n + m) * k, 2 * nm * k + 3 * nm, peaks, reps, main=k == 8))
        rows.append(block_row(
            torch, "rankk_update_axpy", f"R, Y k={k}", (n, m, k),
            lambda: r1.rankk_update_axpy(R, Y, p_, q_, a, b, c, out=out),
            lambda: r1.ref.rankk_update_axpy(R, Y, p_, q_, scal3),
            lambda: torch.addmm(R, p_, q_.T, beta=0.7, alpha=-0.45).add_(Y, alpha=-0.3),
            12 * nm + 4 * (n + m) * k, 2 * nm * k + 5 * nm, peaks, reps, main=k == 32))
        del p_, q_
        torch.cuda.empty_cache()
    del out, R
    return rows


def block_mc_kernels(torch, mc, dev, state, mu, gen, reps, peaks):
    """(a) coo_matmat (G V in the row order, G^T U in the column order) and
    the block update_resid at the Netflix shapes, k = 8 and 32; cuSPARSE's
    CSR SpMM as the library call (its CSR tensor is set-up, not timed)."""
    rows = []
    p = state.rows.numel()
    for k in BLOCK_KS:
        V = torch.randn(NF_M, k, generator=gen, device=dev)
        U = torch.randn(NF_D, k, generator=gen, device=dev) / math.sqrt(NF_D)
        for label, order, vals, x in (("G V", state.by_row, state.resid_by_row, V),
                                      ("G^T U", state.by_col, state.resid_by_col, U)):
            csr = torch.sparse_csr_tensor(order.seg_ptr.to(torch.int32), order.gat_sorted,
                                          vals, size=(order.out_dim, order.in_dim))
            nbytes = 8 * p + 4 * k * (order.in_dim + order.out_dim)
            rows.append(block_row(
                torch, "coo_matmat", f"{label} k={k}", (order.out_dim, order.in_dim, p, k),
                lambda: mc.coo_matmat(order, vals, x),
                lambda: mc.ref.coo_matvec_sorted(order, vals, x),
                lambda: csr @ x, nbytes, 2 * p * k, peaks, reps, plain_reps=2, main=k == 8))
            del csr
        gamma = torch.full((), 0.05, device=dev)
        args = (gamma, mu, U, V, state.rows, state.cols, state.resid, state.vals, state.weight,
                state.by_row, state.copies("row"), state.by_col, state.copies("col"))
        rows.append(block_row(
            torch, "update_resid_block", f"p={p}, k={k}, three orders", (NF_D, NF_M, p, k),
            lambda: mc.update_resid(*args), lambda: mc.ref.update_resid(*args), None,
            64 * p + 4 * k * (NF_D + NF_M), 3 * p * (2 * k + 6), peaks, reps, plain_reps=1,
            exact=True, main=k == 8))
        ones = torch.ones((), device=dev)
        args = (ones, mu, U, V, state.rows, state.cols, state.resid, state.vals, state.weight)
        rows.append(block_row(
            torch, "update_resid_caller", f"p={p}, k={k}, caller order, gamma = 1",
            (NF_D, NF_M, p, k), lambda: mc.update_resid_caller(*args),
            lambda: mc.ref.update_resid_caller(*args), None,
            24 * p + 4 * k * (NF_D + NF_M), p * (2 * k + 6), peaks, reps, plain_reps=1,
            exact=True, main=k == 8))
        del U, V, args
        torch.cuda.empty_cache()
    return rows


def block_odd_shapes(torch, pm, r1, mc, dev, gen):
    """(a) tiny odd shapes: k = 1, 3, 17, 33 (a second group of 32 columns),
    n and m not multiples of 4, a misaligned A, a small skewed COO set."""
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    scal = torch.tensor([0.7, -0.45, -0.3], device=dev)
    rows_, cols_ = torch.randint(0, 301, (5003,), generator=gen, device=dev), torch.randint(
        0, 77, (5003,), generator=gen, device=dev)
    rows_ = torch.where(rows_ % 7 == 0, torch.zeros_like(rows_), rows_).to(torch.int32)
    cols_ = cols_.to(torch.int32)
    vals = rn(5003)
    by_row, by_col = mc.build_order(rows_, cols_, 301, 77), mc.build_order(cols_, rows_, 77, 301)
    vr, vc = mc.gather_sorted(by_row, vals), mc.gather_sorted(by_col, vals)
    for k in (1, 3, 17, 33):
        for n, m in ((37, 5), (65, 33), (300, 1001), (1, 7), (129, 130)):
            base = rn(n * m + 1)
            for A in (base[:-1].view(n, m), base[1:].view(n, m)):  # aligned, off by 4 bytes
                v, u, q = rn(m, k), rn(n, k), rn(m, k)
                Y0 = rn(n, m)
                for name, got, want in (
                        ("matmat", pm.matmat(A, v), pm.ref.matmat(A, v)),
                        ("rmatmat", pm.rmatmat(A, u), pm.ref.rmatmat(A, u)),
                        ("rankk_update", r1.rankk_update(A, u, q, scal[0], scal[1]),
                         r1.ref.rankk_update(A, u, q, scal[:2])),
                        ("rankk_update_axpy",
                         r1.rankk_update_axpy(A, Y0, u, q, scal[0], scal[1], scal[2]),
                         r1.ref.rankk_update_axpy(A, Y0, u, q, scal))):
                    err = rel_err(torch, got, want)[1]
                    check(err <= TOL[name], f"{name} at {n}x{m}, k={k}: rel err {err:.3e}")
        xv, xu = rn(77, k), rn(301, k)
        for label, got, want in (
                ("G V", mc.coo_matmat(by_row, vr, xv), mc.ref.coo_matvec(rows_, cols_, vals,
                                                                         xv, 301)),
                ("G^T U", mc.coo_matmat(by_col, vc, xu), mc.ref.coo_matvec(cols_, rows_, vals,
                                                                           xu, 77))):
            err = rel_err(torch, got, want)[1]
            check(err <= TOL["coo_matmat"], f"coo_matmat {label} k={k}: rel err {err:.3e}")
        if k > 1:
            weight = (torch.arange(5003, device=dev) % 3 != 0).float()
            resid = weight * rn(5003)
            args = (torch.full((), 0.2, device=dev), 1.5, xu, xv, rows_, cols_, resid, vals,
                    weight, by_row, (resid[by_row.perm.long()], vr, weight[by_row.perm.long()]),
                    by_col, (resid[by_col.perm.long()], vc, weight[by_col.perm.long()]))
            check(all(torch.equal(a_, b_) for a_, b_ in zip(mc.update_resid(*args),
                                                            mc.ref.update_resid(*args))),
                  f"update_resid block k={k}: not the plain chain's bits")
            check(torch.equal(mc.update_resid_caller(*args[:9]), mc.update_resid(*args)[0]),
                  f"update_resid_caller k={k}: not update_resid's caller-order bits")
    torch.cuda.synchronize()
    print("block forms match their plain versions at k = 1, 3, 17, 33 and odd shapes")


def block_fit(torch, kernels, dfw, kind, task, x, y, cfg, seed, dev):
    """fit_serial of a block solver: losses, executed iterations, launches
    as the path implies, ms an epoch by segment."""
    piters, seg_log = [], []
    timer = segment_timer(torch, seg_log)

    def cb(start, aux):
        timer(start, aux)
        piters.extend(int(p_) for p_ in aux.piters if p_ == p_)

    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dfw.fit_serial(task, x, y, cfg=cfg, key=seed, device=dev, callback=cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = kernels.launches(), kernels.route_launches()
    want = expected_block_launches(kind, piters, cfg.verify_kernels, cfg.comm,
                                   cfg.step_size == "linesearch")
    label = f"{kind} {cfg.solver}/{cfg.comm}"
    check(launches == want, f"{label}: launches {launches} != expected {want}")
    if kind == "mc":
        check(routes["update_resid"]["block"] == want["update_resid"],
              f"{label}: update_resid's block route")
    check(len(piters) == res.epochs_run and all(1 <= p_ <= k for p_, k in zip(
        piters, res.history["k"])), f"{label}: executed iterations {piters} past K")
    loss = res.history["loss"] + [res.final_loss]
    check(all(math.isfinite(v) for v in loss), f"{label}: non-finite loss")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: {res.epochs_run} epochs in {wall:.2f} s, executed iterations {piters}, "
          f"peak {peak:.2f} GB; loss " + ", ".join(f"{v:.6g}" for v in loss))
    for s_ in seg_log:
        print(f"  segment from epoch {s_['start']}: {s_['ms_per_epoch']:.2f} ms/epoch")
    return res, launches, dict(wall_s=wall, segments=seg_log, loss=loss, piters=piters,
                               launches=launches, peak_gb=peak,
                               block_route=routes["update_resid"]["block"])


def table1_data(torch, gen, dev, task):
    """benchmarks/block_fw_convergence.py's Table-1 problem, made on the card:
    W* = U diag(sv / sum sv) V^T (rank 32, trace norm 1); MTLS X (2048, 1024)
    Gaussian, Y = X W*; MC 5% of W*'s entries observed."""
    t = TABLE1
    u = torch.linalg.qr(torch.randn(t["d"], t["rank"], generator=gen, device=dev))[0]
    v = torch.linalg.qr(torch.randn(t["m"], t["rank"], generator=gen, device=dev))[0]
    sv = torch.linspace(1.0, 0.1, t["rank"], device=dev)
    w = (u * (sv / sv.sum())) @ v.T
    if task == "mtls":
        x = torch.randn(t["n"], t["d"], generator=gen, device=dev)
        return x, x @ w
    mask = torch.rand(t["d"], t["m"], generator=gen, device=dev) < t["obs"]
    rows, cols = torch.nonzero(mask, as_tuple=True)
    from repro_torch.core import tasks

    idx, yw = tasks.pack_observations(rows, cols, w[rows, cols])
    return idx.to(dev), yw.to(dev)


def table1_cell(torch, kernels, dfw, tasks, dev, seed):
    """(e) epochs to 10% of rank1's first gap: rank1 const:2 (line search)
    within a budget of 160 epochs against block:32:adapt and its :cold
    ablation at const:8, stopped by gap_tol, on MTLS and MC, over
    TABLE1_INSTANCES problems, each drawn from a generator of its own seeded
    from (--seed, instance), as the benchmark draws its one problem from its
    own key. Every warm block run must reach the target, every problem's
    speedup TABLE1_EACH, and the median speedup the floor of
    benchmarks/baselines.json. One problem
    cannot certify that floor for matrix completion: its count moves by two
    epochs a step (the block gaps zig-zag), the reference's own speedup
    spans 5.0-7.8x across problems (tools/torch_block_epochs_to_gap.py
    --seed 0..5, CPU), and the reference's own benchmark cell gives 4.77x
    (105 / 22 epochs) with JAX 0.9.0 on the CPU, its record's 6.73x coming
    from JAX 0.4.37 (BENCH_smoke.json), another problem. Returns (report,
    summed launches, update_resid's block-route launches)."""
    t, out = TABLE1, {}
    total = dict.fromkeys(kernels.launches(), 0)
    route_block = 0

    def epochs_to(hist, target):
        return next((i + 1 for i, g in enumerate(hist["gap"]) if g <= target), None)

    for kind in ("mtls", "mc"):
        task = (tasks.MultiTaskLeastSquares if kind == "mtls" else tasks.MatrixCompletion)(
            t["d"], t["m"])
        t0 = time.perf_counter()
        cells = []
        for instance in range(TABLE1_INSTANCES):
            gen = torch.Generator(device=dev)
            gen.manual_seed(_table1_seed(seed, instance))
            x, y = table1_data(torch, gen, dev, kind)

            def run(solver, schedule, gap_tol=None):
                nonlocal route_block
                cfg = dfw.DFWConfig(mu=1.0, num_epochs=t["budget"], schedule=schedule,
                                    step_size="linesearch", solver=solver, gap_tol=gap_tol,
                                    block_epochs=5, verify_kernels=False)
                kernels.reset_launches()
                res = dfw.fit_serial(task, x, y, cfg=cfg, key=seed, device=dev)
                for key_, val in kernels.launches().items():
                    total[key_] += val
                route_block += kernels.route_launches()["update_resid"]["block"]
                return res

            r1_run = run("rank1", "const:2")
            target = t["frac"] * r1_run.history["gap"][0]
            warm = run(f"block:{t['k']}:adapt", "const:8", target)
            cold = run(f"block:{t['k']}:adapt:cold", "const:8", target)
            e1, ew, ec = (epochs_to(r.history, target) for r in (r1_run, warm, cold))
            check(ew is not None,
                  f"table-1 {kind} #{instance}: block:{t['k']}:adapt never reached the target")
            matched = min(len(warm.history["gap"]), len(cold.history["gap"]))
            cells.append(dict(
                rank1_epochs=e1, warm_epochs=ew, cold_epochs=ec,
                speedup=(e1 if e1 is not None else t["budget"]) / ew,
                cold_over_warm_epochs=(ec if ec is not None else t["budget"]) / ew,
                cold_over_warm_gap=cold.history["gap"][matched - 1]
                / max(warm.history["gap"][matched - 1], 1e-12)))
            del x, y, r1_run, warm, cold
        speedup = statistics.median(c["speedup"] for c in cells)
        out[kind] = dict(instances=cells, speedup=speedup, wall_s=time.perf_counter() - t0,
                         cold_over_warm_epochs=statistics.median(
                             c["cold_over_warm_epochs"] for c in cells))
        print(f"(e) table-1 {kind}, epochs to 10% of rank1's first gap on "
              f"{TABLE1_INSTANCES} problems (rank1 / block:{t['k']}:adapt / :cold): "
              + "; ".join(f"{c['rank1_epochs'] if c['rank1_epochs'] is not None else 'budget'}"
                          f" / {c['warm_epochs']} / {c['cold_epochs']} ({c['speedup']:.2f}x)"
                          for c in cells)
              + f"; median speedup {speedup:.2f}x (floor {TABLE1_FLOOR}x, each "
              f"{TABLE1_EACH}x), median cold/warm "
              f"epochs {out[kind]['cold_over_warm_epochs']:.2f} (BENCH_smoke.json, JAX on its "
              "one problem: mtls 79/5, mc 101/15)")
        check(speedup >= TABLE1_FLOOR,
              f"table-1 {kind}: median speedup {speedup:.2f} below the floor {TABLE1_FLOOR}")
        low = min(c["speedup"] for c in cells)
        check(low >= TABLE1_EACH,
              f"table-1 {kind}: a problem's speedup {low:.2f} below {TABLE1_EACH}")
    return out, total, route_block


def _table1_seed(seed: int, instance: int) -> int:
    return (seed * 1_000_003 + 0x7AB1E1 + instance) % (1 << 63)


def block_phase(torch, np, kernels, dfw, comm, tasks, low_rank, NoiseStream, pm, r1, mc, dev,
                args, peaks, rank1_ms_of):
    """Phase 25 (see the module doc). Returns (kernel rows, report, summed
    launches of its fits, their update_resid block-route launches)."""
    report, total = {}, dict.fromkeys(kernels.launches(), 0)
    route_block = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 25)
    t_phase = time.perf_counter()
    X, Y = dense_data(torch, gen, dev, args.rows)
    krows = block_dense_kernels(torch, pm, r1, dev, X, Y, gen, args.reps, peaks)
    block_odd_shapes(torch, pm, r1, mc, dev, gen)

    def add(launches):
        for key_, val in launches.items():
            total[key_] += val

    # (b) full-width fits: MTLS block:32:adapt, logistic block:8
    mtls = tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M)
    res, launches, report["mtls"] = block_fit(
        torch, kernels, dfw, "mtls", mtls, X, Y, dfw.DFWConfig(
            mu=1.0, num_epochs=10, schedule="const:8", step_size="linesearch",
            solver="block:32:adapt", block_epochs=5), args.seed, dev)
    add(launches)
    loss = report["mtls"]["loss"]
    check(all(b_ <= a_ * (1 + 1e-6) for a_, b_ in zip(loss, loss[1:])),
          "block mtls: loss increased")
    del res
    torch.cuda.empty_cache()
    labels = planted_labels(torch, gen, dev, X)
    res, launches, report["logistic"] = block_fit(
        torch, kernels, dfw, "logistic", tasks.MultinomialLogistic(PAPER_D, PAPER_M), X, labels,
        dfw.DFWConfig(mu=10.0, num_epochs=3, schedule="log_half", solver="block:8"),
        args.seed, dev)
    add(launches)
    loss = report["logistic"]["loss"]
    check(loss[-1] < loss[0] and loss[-1] < X.shape[0] * math.log(PAPER_M),
          f"block logistic: final loss {loss[-1]} not below its first and n ln m")
    del res, labels
    torch.cuda.empty_cache()

    # (c) block:32 through fit over one NCCL worker = fit_serial
    report["world_one"], launches = world_one_phase(
        torch, np, kernels, dfw, comm, low_rank, NoiseStream, dev, [
            ("mtls block:32", mtls, X, Y, dfw.DFWConfig(
                mu=1.0, num_epochs=3, schedule="const:2", step_size="linesearch",
                solver="block:32"))], args.seed)
    add(launches)

    # (d) four gloo workers, hier:2 with block:8, against fit_serial
    nw = MULTI_WORKERS
    n4 = X.shape[0] - X.shape[0] % nw
    kw = dict(mu=1.0, num_epochs=5, schedule="const:3", step_size="linesearch",
              solver="block:8")
    ref = dfw.fit_serial(mtls, X[:n4], Y[:n4], cfg=dfw.DFWConfig(**kw), key=args.seed,
                         device=dev)
    ref_w = low_rank.materialize(ref.iterate).cpu().numpy()
    ref_hist, ref_final = ref.history, ref.final_loss
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dfw.run_workers(nw, multi_worker_rank, [("mtls", mtls, X[:n4], Y[:n4], dict(
        kw, topology="hier:2"))], args.seed, backend="gloo", device=dev)
    got = [r[0] for r in ranks]
    head = got[0]
    for j, g in enumerate(got):
        want = expected_block_launches("mtls", g["history"]["k"], True)
        check(g["launches"] == want, f"(d) hier:2 block:8: worker {j} launched "
              f"{g['launches']}, expected {want}")
        add(g["launches"])
        check(g["history"] == head["history"] and all(np.array_equal(
            g["packed"][k_], head["packed"][k_]) for k_ in head["packed"]),
            f"(d) worker {j}'s history or iterate is not worker 0's")
        st, epochs = g["stats"], len(g["history"]["k"])
        counted = st["bytes_all_reduce"] + st["bytes_all_gather"] + st["bytes_send"]
        scalars = epochs * (2 + 2) * 2 * 4 + 2 * 4
        check(counted == st["comm_wire_bytes"] + scalars,
              f"(d) worker {j} counted {counted} bytes, analytic {st['comm_wire_bytes']} + "
              f"{scalars} scalars")
    a_, b_ = (np.asarray(h, np.float64) for h in (head["history"]["loss"], ref_hist["loss"]))
    loss_dev = float(np.max(np.abs(a_ - b_) / np.abs(b_)))
    w_head = low_rank.materialize(low_rank.unpack_live(
        head["packed"], len(head["packed"]["s"]), device="cpu")).numpy()
    w_dev = float(np.max(np.abs(w_head - ref_w)) / np.max(np.abs(ref_w)))
    final_dev = abs(head["final_loss"] - ref_final) / abs(ref_final)
    check(loss_dev <= 1e-4 and final_dev <= 1e-4 and w_dev <= 1e-4,
          f"(d) hier:2 block:8 leaves fit_serial: loss {loss_dev:.2e}, final {final_dev:.2e}, "
          f"W {w_dev:.2e} (limits 1e-4)")
    st = head["stats"]
    report["hier"] = dict(loss_dev=loss_dev, final_dev=final_dev, w_dev=w_dev,
                          wall_s=time.perf_counter() - t0,
                          bytes_per_epoch=(st["bytes_all_reduce"] + st["bytes_all_gather"]
                                           + st["bytes_send"]) / len(head["history"]["k"]),
                          wire_bytes_per_epoch=st["comm_wire_bytes"] / len(head["history"]["k"]))
    print(f"(d) hier:2 block:8 on {nw} gloo workers: from fit_serial loss {loss_dev:.2e}, final "
          f"{final_dev:.2e}, W {w_dev:.2e} of max (limits 1e-4); counted bytes an epoch "
          f"{report['hier']['bytes_per_epoch']:.1f} = exchanges "
          f"{report['hier']['wire_bytes_per_epoch']:.1f} + scalar sums, exactly")
    del X, Y, ranks, got, head
    torch.cuda.empty_cache()

    # (a) the MC forms and (b) the MC fits at the Netflix shapes
    idx, yw, (te_rows, te_cols, te_vals), mu = make_mc_data(
        torch, gen, dev, args.mc_entries, NF_TEST, d=NF_D, m=NF_M)
    mc_task = tasks.MatrixCompletion(NF_D, NF_M)
    state = mc_task.init_state(idx, yw)
    krows += block_mc_kernels(torch, mc, dev, state, mu, gen, args.reps, peaks)
    del state
    torch.cuda.empty_cache()
    for comm_name, epochs in (("dense", 10), ("int8", 5)):
        res, launches, report[f"mc_{comm_name}"] = block_fit(
            torch, kernels, dfw, "mc", mc_task, idx, yw, dfw.DFWConfig(
                mu=mu, num_epochs=epochs, schedule="const:4", step_size="linesearch",
                solver="block:8:adapt", comm=comm_name, block_epochs=5), args.seed, dev)
        add(launches)
        route_block += report[f"mc_{comm_name}"]["block_route"]
        loss = report[f"mc_{comm_name}"]["loss"]
        if comm_name == "dense":
            check(all(b_ <= a_ * (1 + 1e-6) for a_, b_ in zip(loss, loss[1:])),
                  "block mc: loss increased")
            pred = low_rank.gather_entries(res.iterate, te_rows, te_cols)
            rmse = float(torch.sqrt(torch.mean((pred - te_vals) ** 2)))
            rmse0 = float(torch.sqrt(torch.mean(te_vals ** 2)))
            report["mc_dense"].update(heldout_rmse=rmse, heldout_rmse_w0=rmse0)
            check(math.isfinite(rmse) and rmse < rmse0,
                  f"block mc: held-out RMSE {rmse:.4f} not below W = 0's {rmse0:.4f}")
            print(f"block mc: held-out RMSE {rmse:.4f} (W = 0: {rmse0:.4f})")
            del pred
        else:
            check(loss[-1] < loss[0], "block mc int8: final loss not below the first")
        del res
        torch.cuda.empty_cache()
    del idx, yw, te_rows, te_cols, te_vals
    torch.cuda.empty_cache()

    # (e) the Table-1 cell of benchmarks/block_fw_convergence.py
    report["table1"], launches, routed = table1_cell(torch, kernels, dfw, tasks, dev, args.seed)
    add(launches)
    route_block += routed

    for kind, rank1_ms in (("mtls", rank1_ms_of.get("mtls")), ("mc_dense", rank1_ms_of.get("mc"))):
        seg = report[kind]["segments"]
        report[kind]["ms_per_epoch"] = statistics.mean(s_["ms_per_epoch"] for s_ in seg[1:]) \
            if len(seg) > 1 else seg[0]["ms_per_epoch"]
        print(f"block {kind}: {report[kind]['ms_per_epoch']:.2f} ms an epoch (after the first "
              f"segment, executed iterations {report[kind]['piters']}) against the rank1 main "
              f"path's {rank1_ms} ms an epoch by K")
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 25 took {report['wall_s']:.1f} s")
    return krows, report, total, route_block


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=PAPER_N, help="n (depth cut only)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--logistic-epochs", type=int, default=10)
    ap.add_argument("--mc-entries", type=int, default=NF_P,
                    help="training ratings (depth cut only; d, m and the held-out set stay; "
                    "the held-out RMSE check needs the full count)")
    ap.add_argument("--mc-epochs", type=int, default=30)
    ap.add_argument("--mc-int8-epochs", type=int, default=10)
    ap.add_argument("--serve-rows", type=int, default=16384,
                    help="n of the fit that writes the served checkpoints (the width stays)")
    ap.add_argument("--serve-epochs", type=int, default=64)
    ap.add_argument("--serve-batches", type=int, default=200)
    ap.add_argument("--lm-batch", type=int, default=4,
                    help="prompts of the full-width prefill (phase 14; depth cut only)")
    ap.add_argument("--lm-seq", type=int, default=8192,
                    help="tokens per prompt of the full-width prefill (phase 14)")
    ap.add_argument("--lm-layers", type=int, default=28,
                    help="layers of qwen2-1.5b in phases 14 and 16 (depth cut only; the "
                    "width stays)")
    ap.add_argument("--ssm-batch", type=int, default=SSM_BATCH,
                    help="prompts of the full-width rwkv6-7b prefill (phase 18; depth cut only)")
    ap.add_argument("--ssm-seq", type=int, default=SSM_SEQ,
                    help="tokens per prompt of the rwkv6-7b prefill (phase 18; a multiple of "
                    "the 256-token chunk)")
    ap.add_argument("--ssm-layers", type=int, default=32,
                    help="layers of rwkv6-7b in phases 18-20 (depth cut only; the width stays)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--report", default=None, help="also write the full report here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3-epoch fits (device time by kernel, idle share)")
    ap.add_argument("--coo-bits", default=None, metavar="PATH",
                    help="only time coo_matvec at the full MC shape and save its results here")
    ap.add_argument("--coo-ref", default=None, metavar="PATH",
                    help="with --coo-bits: compare the results bit for bit with this file's")
    ap.add_argument("--src", default=None,
                    help="import the port from this src directory (default: the checkout's)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available; this script runs the port on a GPU")
    src = Path(args.src).resolve() if args.src else Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch import NoiseStream, V0Stream, checkpoint, comm, kernels, resolve_device
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, frank_wolfe, low_rank, tasks
    from repro_torch.kernels import _build
    from repro_torch.kernels import factor_matvec as fm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mc_matvec as mc
    from repro_torch.kernels import power_matvec as pm
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rank1_update as r1
    from repro_torch.kernels import wkv6_chunk as wkv
    from repro_torch.launch import dfw, steps
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import lm, rwkv6

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    report = dict(device=name, torch=torch.__version__, cuda=torch.version.cuda)
    try:
        # 1. build + card
        t0 = time.perf_counter()
        _build.build_all()
        report["build_s"] = time.perf_counter() - t0
        print(f"built kernels in {report['build_s']:.1f} s into {_build.BUILD_DIR}")
        for src_name in ("power_matvec", "rank1_update", "mc_matvec", "quantize",
                         "factor_matvec", "flash_attention", "wkv6_chunk"):
            for line in _build.build_log(src_name).splitlines():
                if "registers" in line or "spill" in line or "wgmma" in line:
                    print(f"  ptxas {src_name}: {line.strip()}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        report["nvidia_smi"] = smi
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
        peaks = card_peaks(name)

        # data for the main path, made on the card from --seed
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        if args.coo_bits:
            print(json.dumps({"coo_bits": coo_bits_phase(torch, mc, tasks, dev, gen, args)}))
            return 0
        n = args.rows
        t0 = time.perf_counter()
        X, Y = dense_data(torch, gen, dev, n)
        torch.cuda.synchronize()
        print(f"data: X {tuple(X.shape)}, Y {tuple(Y.shape)} f32 made in "
              f"{time.perf_counter() - t0:.1f} s")

        # 2. kernels against their plain versions
        R = -Y
        krows = kernel_phase(torch, pm, r1, dev, X, R, Y, gen, args.reps, peaks)
        del R
        torch.cuda.empty_cache()

        # 3. MTLS main path
        cfg = dfw.DFWConfig(mu=1.0, num_epochs=args.epochs, schedule="log",
                            step_size="linesearch")
        res, mtls_launch, report["mtls"] = run_path(
            torch, kernels, dfw, "mtls", tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M), X, Y,
            cfg, args.seed, dev)
        loss = res.history["loss"] + [res.final_loss]
        check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])),
              "mtls: loss increased")
        check(res.final_loss < loss[0], "mtls: final loss not below the initial loss")
        if args.profile:
            del res
            report["mtls_profile"] = profile_fit(torch, "mtls", lambda: dfw.fit_serial(
                tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M), X, Y, cfg=dfw.DFWConfig(
                    mu=1.0, num_epochs=3, schedule="const:3", step_size="linesearch",
                    verify_kernels=False), key=args.seed, device=dev))
            res = None
        del res, Y
        torch.cuda.empty_cache()

        # 4. logistic main path: planted rank-10 labels with 5% label noise
        labels = planted_labels(torch, gen, dev, X)
        cfg = dfw.DFWConfig(mu=10.0, num_epochs=args.logistic_epochs, schedule="log_half")
        res, log_launch, report["logistic"] = run_path(
            torch, kernels, dfw, "logistic", tasks.MultinomialLogistic(PAPER_D, PAPER_M), X,
            labels, cfg, args.seed, dev)
        bound = n * math.log(PAPER_M)
        check(res.final_loss < bound, f"logistic: final loss {res.final_loss} >= n ln m {bound}")
        print(f"logistic final loss {res.final_loss:.6g} < n ln m = {bound:.6g}")
        if args.profile:
            del res
            report["logistic_profile"] = profile_fit(torch, "logistic", lambda: dfw.fit_serial(
                tasks.MultinomialLogistic(PAPER_D, PAPER_M), X, labels, cfg=dfw.DFWConfig(
                    mu=10.0, num_epochs=3, schedule="const:2", verify_kernels=False),
                key=args.seed, device=dev))
            res = None
        del res, X, labels
        torch.cuda.empty_cache()

        # 5. small fits, card against CPU
        small_parity(torch, np, V0Stream, dfw, tasks, dev)

        # 6. matrix-completion data at the Netflix shapes, made on the card
        t0 = time.perf_counter()
        idx, yw, (te_rows, te_cols, te_vals), mu = make_mc_data(
            torch, gen, dev, args.mc_entries, NF_TEST)
        torch.cuda.synchronize()
        report["mc_data"] = mc_stats(torch, idx, NF_D, NF_M)
        report["mc_data"].update(entries=args.mc_entries, held_out=NF_TEST, mu=mu,
                                 made_s=time.perf_counter() - t0)
        print(f"mc data: d={NF_D} m={NF_M} {args.mc_entries} training + {NF_TEST} held-out "
              f"ratings made in {report['mc_data']['made_s']:.1f} s; {report['mc_data']}")
        mc_task = tasks.MatrixCompletion(NF_D, NF_M)

        # 7. the state build; COO matvec, the copies' gathers and the quantize
        # pair against their plain versions
        state, report["mc_state_build"] = state_build_phase(torch, mc_task, idx, yw)
        report["mc_init_state_s"] = report["mc_state_build"]["wall_s"]
        krows += mc_kernel_phase(torch, mc, qz, dev, state, gen, args.reps, peaks)
        krows += update_resid_phase(torch, mc, tasks, dev, state, mu, gen, args.reps, peaks)
        del state
        torch.cuda.empty_cache()

        # 8. MC main path, comm dense
        cfg = dfw.DFWConfig(mu=mu, num_epochs=args.mc_epochs, schedule="log",
                            step_size="linesearch")
        res, mc_launch, report["mc"] = run_path(
            torch, kernels, dfw, "mc", mc_task, idx, yw, cfg, args.seed, dev)
        loss = res.history["loss"] + [res.final_loss]
        check(all(b <= a * (1 + 1e-6) for a, b in zip(loss, loss[1:])), "mc: loss increased")
        pred = low_rank.gather_entries(res.iterate, te_rows, te_cols)
        rmse = float(torch.sqrt(torch.mean((pred - te_vals) ** 2)))
        rmse0 = float(torch.sqrt(torch.mean(te_vals ** 2)))
        report["mc"].update(heldout_rmse=rmse, heldout_rmse_w0=rmse0,
                            train_rmse=float(mc_task.rmse(res.state)))
        check(math.isfinite(rmse) and rmse < rmse0,
              f"mc: held-out RMSE {rmse:.4f} not below that of W = 0 ({rmse0:.4f})")
        print(f"mc: held-out RMSE {rmse:.4f} (W = 0: {rmse0:.4f}), training RMSE "
              f"{report['mc']['train_rmse']:.4f}")
        del res, pred
        torch.cuda.empty_cache()
        if args.profile:
            ktask = dfw.kernelize(mc_task)
            state = ktask.init_state(idx, yw)
            report["mc_profile"] = profile_fit(torch, "mc", lambda: frank_wolfe.fit(
                ktask, state, mu=mu, num_epochs=3, schedule="const:3",
                step_size="linesearch", key=args.seed, device=dev))
            del state
            torch.cuda.empty_cache()

        # 9. MC main path, comm int8
        cfg = dfw.DFWConfig(mu=mu, num_epochs=args.mc_int8_epochs, schedule="log",
                            step_size="linesearch", comm="int8")
        res, mc8_launch, report["mc_int8"] = run_path(
            torch, kernels, dfw, "mc", mc_task, idx, yw, cfg, args.seed, dev)
        check(res.final_loss < res.history["loss"][0],
              "mc int8: final loss not below the first")
        del res
        torch.cuda.empty_cache()
        if args.profile:
            ktask = dfw.kernelize(mc_task)
            state = ktask.init_state(idx, yw)
            report["mc_int8_profile"] = profile_fit(torch, "mc int8", lambda: frank_wolfe.fit(
                ktask, state, mu=mu, num_epochs=3, schedule="const:3",
                step_size="linesearch", reducer=comm.Int8Reducer(), key=args.seed, device=dev))
            del state
        del idx, yw, te_rows, te_cols, te_vals
        torch.cuda.empty_cache()

        # 10. small MC fits, dense and int8, card against CPU
        mc_small_parity(torch, np, V0Stream, NoiseStream, comm, qz.ref, dfw, frank_wolfe,
                        tasks, dev)

        # 11. factor_matvec against its plain version at the serving shapes
        krows += factor_kernel_phase(torch, fm, _build, dev, gen, args.reps, peaks)
        if args.profile:
            report["factor_sweep_profile"] = profile_factor_sweep(torch, fm, dev, gen)
        torch.cuda.empty_cache()

        # 12. train, checkpoint, serve
        report["serve"], fit12_launch, serve_launch, eng = train_then_serve(
            torch, np, dfw, tasks, checkpoint, serve, low_rank, kernels, dev, gen, args)
        if args.profile:
            report["serve_profile"] = profile_serving(torch, np, eng)
        del eng
        torch.cuda.empty_cache()

        # 13. flash_attention against its plain version
        fa_rows, report["hgmma"] = flash_kernel_phase(torch, fa, kernels, _build, dev, gen,
                                                      args.reps, peaks)
        krows += fa_rows
        torch.cuda.empty_cache()

        # 14. full-width prefill of qwen2-1.5b (depth --lm-layers)
        lm_cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=args.lm_layers)
        report["lm_prefill"], prefill_launch, lm_params, lm_toks = lm_prefill_phase(
            torch, kernels, lm, steps, lm_cfg, dev, gen, args)
        if args.profile:
            report["lm_profile"] = profile_lm(torch, lm_serve, steps, lm_cfg, lm_params, lm_toks,
                                              dev, args.seed)
        del lm_toks
        torch.cuda.empty_cache()

        # 15. full-width decode through generate
        report["lm_decode"], decode_launch = lm_decode_phase(
            torch, np, kernels, lm_serve, get_config(LM_ARCH), dev, args.seed)
        torch.cuda.empty_cache()

        # 16. cross-checks: prefill against decode (f32, bf16), card against CPU
        report["lm_checks"] = lm_crosscheck_phase(torch, lm, steps, get_config, kernels, lm_cfg,
                                                  lm_params, dev, gen)
        del lm_params
        torch.cuda.empty_cache()

        # 17. wkv6_chunk against its plain versions
        krows += wkv6_kernel_phase(torch, wkv, _build, dev, gen, args.reps, peaks)
        torch.cuda.empty_cache()

        # 18. full-width prefill of rwkv6-7b (depth --ssm-layers)
        ssm_cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=args.ssm_layers)
        report["ssm_prefill"], ssm_prefill_launch, ssm_params, ssm_toks = ssm_prefill_phase(
            torch, kernels, lm, steps, ssm_cfg, dev, gen, args)
        if args.profile:
            report["ssm_profile"] = profile_ssm(torch, lm_serve, steps, ssm_cfg, ssm_params,
                                                ssm_toks, dev, args.seed)
        del ssm_toks
        torch.cuda.empty_cache()

        # 19. full-width decode through generate, with the prefill's weights
        report["ssm_decode"], ssm_decode_launch = ssm_decode_phase(
            torch, np, kernels, lm_serve, ssm_cfg, ssm_params, dev, args.seed)
        torch.cuda.empty_cache()

        # 20. cross-checks: prefill against decode (f32, bf16; 64 and 256 tokens), card
        # against CPU
        report["ssm_checks"] = ssm_crosscheck_phase(torch, lm, steps, rwkv6, get_config, kernels,
                                                    ssm_cfg, ssm_params, dev, gen)
        del ssm_params
        torch.cuda.empty_cache()

        # 21. (a) fit over one NCCL worker against fit_serial at the main path's
        # shapes: the same data as phases 3 and 4 (from --seed), new ratings
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        X, Y = dense_data(torch, gen, dev, n)
        labels = planted_labels(torch, gen, dev, X)
        mc_data = make_mc_data(torch, gen, dev, args.mc_entries, NF_TEST)
        idx, yw, _, mu = mc_data
        mc_dense = dfw.DFWConfig(mu=mu, num_epochs=args.mc_epochs, schedule="log",
                                 step_size="linesearch")
        report["world_one"], world_one_launch = world_one_phase(
            torch, np, kernels, dfw, comm, low_rank, NoiseStream, dev, [
                ("mtls", tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M), X, Y, dfw.DFWConfig(
                    mu=1.0, num_epochs=args.epochs, schedule="log", step_size="linesearch")),
                ("logistic", tasks.MultinomialLogistic(PAPER_D, PAPER_M), X, labels, dfw.DFWConfig(
                    mu=10.0, num_epochs=args.logistic_epochs, schedule="log_half")),
                ("mc dense", mc_task, idx, yw, mc_dense),
                ("mc int8", mc_task, idx, yw, dataclasses.replace(
                    mc_dense, num_epochs=args.mc_int8_epochs, comm="int8")),
            ], args.seed)
        torch.cuda.empty_cache()

        # 22. (b) four gloo workers on the one card
        report["multi_worker"], multi_launch = multi_worker_phase(
            torch, np, kernels, dfw, tasks, low_rank, dev, X, Y, mc_data, args.seed, args)
        torch.cuda.empty_cache()

        # 23. NAIVE-DFW and SVA at the ImageNet shapes; NAIVE on logistic
        # regression and on a small MC made on the card
        t0 = time.perf_counter()
        report["baselines"], baselines_launch = baselines_phase(
            torch, np, kernels, dfw, tasks, baselines, low_rank, dev, X, Y, labels, gen,
            args.seed)
        report["baselines"]["wall_s"] = time.perf_counter() - t0
        del labels
        torch.cuda.empty_cache()

        # 24. the exchange graphs: topk:16 over one NCCL worker; ring, hier:2
        # (dense, int8) and topk:16 on four gloo workers
        t0 = time.perf_counter()
        report["graphs"], graphs_launch = graphs_phase(
            torch, np, kernels, dfw, comm, tasks, low_rank, NoiseStream, dev, X, Y, mc_data,
            args.seed, args, report["world_one"])
        report["graphs"]["wall_s"] = time.perf_counter() - t0
        print(f"phase 23 took {report['baselines']['wall_s']:.1f} s, phase 24 "
              f"{report['graphs']['wall_s']:.1f} s ({smi})")
        del X, Y, idx, yw, mc_data
        torch.cuda.empty_cache()

        # 25. the block:k solver tier: its kernel forms, full-width block fits,
        # one NCCL worker, hier:2 on four gloo workers, the Table-1 cell
        rank1_ms = {kind: steady_ms(report[kind]["segments"], report[kind]["ks"])
                    for kind in ("mtls", "mc")}
        block_rows, report["block"], block_launch, block_route = block_phase(
            torch, np, kernels, dfw, comm, tasks, low_rank, NoiseStream, pm, r1, mc, dev, args,
            peaks, rank1_ms)
        krows += block_rows
        print(f"phase 25 took {report['block']['wall_s']:.1f} s ({smi})")
        torch.cuda.empty_cache()
    except Check as e:
        return fail(str(e))

    out = []
    paths = (mtls_launch, log_launch, mc_launch, mc8_launch, fit12_launch, serve_launch,
             prefill_launch, decode_launch, ssm_prefill_launch, ssm_decode_launch,
             world_one_launch, multi_launch, baselines_launch, graphs_launch, block_launch)
    for kname in (*TPU_KERNEL, *HELPER_KERNELS, *BLOCK_KERNELS, "update_resid_block"):
        rows = [r for r in krows if r["name"] == kname]
        main_row = next((r for r in rows if r.get("main")), None) or max(
            rows, key=lambda r: r["bytes"])
        if kname in BLOCK_OF:  # a block form, under the TPU kernel the reference vmaps
            helper = {"form_of": BLOCK_OF[kname]}
            if kname in ("update_resid_block", "update_resid_caller"):
                helper["part_of"] = "coo_matvec"
            replaces = TPU_KERNEL[BLOCK_OF[kname]]
        else:
            helper = {} if kname in TPU_KERNEL else {"part_of": "coo_matvec"}
            replaces = TPU_KERNEL[kname if kname in TPU_KERNEL else "coo_matvec"]
        if kname == "update_resid_block":  # a route of the update_resid wrapper
            launches = block_route
        else:
            launches = sum(path[kname] for path in paths) - (
                block_route if kname == "update_resid" else 0)
        out.append(dict(
            name=kname, route="cuda", source=SOURCE[kname], replaces=replaces, **helper,
            launches=launches,
            max_abs_err=main_row["max_abs_err"], max_rel_err=main_row["max_rel_err"],
            ms=main_row["ms"], plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
            shape=main_row["shape"],
            by_operand={r["operand"]: {k: r[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "library_rel_err", "library_chain_ms",
                "library_ratio", "exact_ms", "bound_ms", "bound_f32_cores_ms", "bound_by",
                "max_rel_err", "device_ms", "random_floor_ms", "random_floor_with_passes_ms")
                if k in r}
                for r in rows},
        ))
    report["kernels"] = krows
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
