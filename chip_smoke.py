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
   bits. The rank-1 updates also in place, as the fits call them: the
   out-of-place bits, timed in turns against ``addr_`` in place
   (``rank1_update``) and against the chain ``addr_`` + ``add_``
   (``rank1_update_axpy``, which no one call computes).
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
   flight, walks every step, swaps inside one rank bucket while a batch is
   in flight, dispatches a full batch under its contract's guard (no
   implicit host sync), serves 640 single requests through a
   ``MicroBatcher`` (ten batches in flight) and a transposed engine. Each
   rank bucket is one captured CUDA graph of ``factor_matvec`` (compilations
   = buckets visited; capture ms and pool bytes printed), each dispatch a
   replay. Every score is checked against x @ W on the card and bit for bit
   against the uncaptured kernel on the same padded inputs and factors
   (in-flight handles keep their rows and their model); the launches the
   device ran (one replay a dispatch, one warm-up a bucket), rank buckets
   and the device memory the scoring adds are checked too.

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
   prompt and 32 new tokens, one captured step replayed for every position:
   its tokens and the cache it filled the same bits as a loop of the
   uncaptured serve step on the same weights and prompt; no launch of
   flash_attention on the device (decode attention is the dense path); ms
   per step of both, the capture's ms and its graph pool's bytes.
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
   prompt and 32 new tokens, captured as in phase 15 and held bit for bit
   to the uncaptured step loop (tokens, wkv states and token-shift inputs);
   no wkv6_chunk launch (decode is the exact recurrence in plain PyTorch);
   ms per step of both, capture ms, pool bytes.
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
   call (``A @ V``, ``addmm``, cuSPARSE's CSR SpMM; ``matmat``/``rmatmat``
   against ``A @ V`` and the rank-k updates against ``addmm`` (+ ``add_``)
   timed in turns, kernel, call, call, kernel), its bits repeated; the
   rank-k updates also in place (out is the operand, as the fits call
   them), held to the out-of-place bits and timed in turns against
   ``addmm_`` (+ ``add_``); the block ``update_resid`` and its caller order alone
   (``update_resid_caller``, the line search's) bit for bit; ``coo_matmat``
   bit for bit to ``ref.coo_matmat_chain`` (its association); the MC forms'
   gather floors (``tools/torch_gather_probe.py``'s rate of random 32-byte
   sectors, measured in the run, plus the sequential bytes); tiny odd shapes
   at k = 1, 3, 17, 33, the MC forms' X and factors also 4 bytes off
   16-byte alignment.
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
26. Resume from a run checkpoint (``DFWConfig(resume_from=...,
   resume_step=...)``), on phase 21's draws (phase 3's X and Y, new ratings
   at the Netflix shapes), checkpoints in a temporary directory under
   ``build/``. Every resumed run must give its uninterrupted run's bits
   (history, final loss, iterate, final residual or logits, probe, reducer
   state) and launch what the epochs after the step and one state build
   imply. (a) Matrix completion dense, phase 8's configuration, 10 epochs
   in segments of at most 5 (checkpoint steps 2, 7, 10 under the log
   schedule), resumed at 7, after the first run's state is freed; the
   bytes of a step and the restore's wall time by part (disk read, host to
   device, state build). (b) ``block:8:adapt`` const:4 (phase 25's), 10
   epochs, resumed at 5: the probe carried. (c) Least squares ``topk:16``
   and (d) logistic regression int8 at d = 2048, m = 1000 with n cut to
   --serve-rows (a full-n least-squares step is 20.7 GB), 8 epochs,
   resumed at 4: the residuals and the noise stream. (e) Four gloo workers
   on the card (phase 22's MC setup, --mc-int8-epochs), resumed at the
   interior step on four (every worker its bits) and on two (phase 22's
   tolerances against the four-worker run); a check, not a timing. (f) The
   dense MTLS operator (X^T X, X^T Y, gradient) on phase 3's X and Y
   against the factored operator: matvec, rmatvec and the gradient within
   1e-3 of max, fresh and after an update.
27. The engine on the card (``core/engine.py``: one CUDA graph a (K, length)
   segment program of at most ``MAX_PROGRAM_EPOCHS`` epochs, IF nodes for
   ``gap_tol`` and ``:adapt``; every earlier phase's fits run that way
   too, and phase 21 checks each of its runs was captured). From built
   states, through ``frank_wolfe.fit``: (a) scan against legacy on MTLS
   (phase 3's configuration), MTLS ``block:32:adapt`` and logistic
   regression (phase 4's) at the ImageNet shapes, MC dense and int8
   (phases 8, 9) and ``block:8:adapt`` (phase 25's) at the Netflix
   shapes, and the Table-1 problem's rank1 and ``block:32:adapt`` (MTLS
   and MC, 40 and 20 epochs): the same history, final loss and iterate
   bits, and (e) the launches the device ran (counted on the device,
   graph replays included) the same in both modes and equal to legacy's
   wrapper calls; each scan run's stats, capture ms, pool and
   table bytes, the draws' host µs and peak memory; ms an epoch of both
   modes, unprofiled, over the segments after the first of a const
   schedule in blocks (a callback timing each segment). (b) Every scan run
   within ``engine.dispatch_contract(segments=...)``; a const:2 MC run
   under ``Contract.guard()``. (c) MTLS with ``gap_tol`` (the gap an
   unstopped run reaches at 60% of its epochs) in one const:2 segment:
   scan stops at legacy's epoch, past the first and before the last, with
   the same bits and launches and one sync at the boundary;
   ``block:8:adapt``'s executed iterations the same in both modes. (f) One
   long const segment each of MTLS (48 epochs) and MC int8 (100): replays
   of pieces, at most two graphs, their capture ms and table bytes.
28. Telemetry (``repro_torch.obs``) and the op recorder
   (``analysis.recorder``). (a) MTLS ``fit_serial`` (phase 3's
   configuration, 5 epochs; with a checkpoint dir at n = --serve-rows, a
   full-n step being 20.7 GB) and MC dense (phase 8's, 5 epochs), each with
   an enabled handle and without, on the same draws: the same history,
   final loss and iterate bits, the same ``stats`` and the same launches on
   the device; both sinks written and parsed, the events covering
   ``engine.segment``, ``comm.exchange`` and ``checkpoint.write``; each
   fit run four times in turns (off, on, on, off), its whole wall and its
   programs' capture ms printed (an enabled handle records each capture);
   ms an epoch with the handle off and on, in turns (off, on, on, off; MTLS
   const:2 and MC const:3 in blocks of 4 from built states; printed, not a
   gate). (b) An enabled MC const:2 run under
   ``dispatch_contract().guard()`` and the recorder: nothing raises, no
   implicit device read, explicit fetches that read the device =
   ``host_syncs``, a ``comm.executable`` op log per captured program. (c)
   Phase 21's one-worker NCCL ``fit``, MC int8, under the recorder:
   all-reduces an epoch from each captured program's log = 1 + 2K x 2 + 1,
   explicit fetches that read = ``host_syncs``. (d)
   ``Telemetry(profiler_dir=...)`` on a 3-epoch MTLS fit (const:3, no IF
   node): the torch.profiler trace names the port's matvec, rmatvec and
   rank-1 kernels. (e) Phase 12's serving shapes at rank 48 on four
   engines, built without a handle, with, with, without; each of 2,000
   requests (``TELEMETRY_REQUESTS``) scored on all four, the first engine
   turning with the request, then all again with the garbage collector
   off: p50/p99 a side and an engine, the host µs of ``score_async`` and
   ``block()``, the same scores, ``check_contract()`` on every bucket's
   capture log (no d x m tensor), histogram count = dispatches. (f)
   ``analysis.contracts.verify_declared()`` with its default device, the
   card: the engine's and the scorer's contracts read from their captures.
   About 45 s of command time.
29. The paper's head (``core.dfw_head``). (a) ``train_head`` at the
   ImageNet shapes (X n x 2048 standard normal, planted rank-10 labels with
   5% noise over m = 1000, made on the card from --seed; 10 epochs const:2,
   mu 10): ``fit_serial``'s history, final loss and iterate bits, final
   loss below n ln m, the device's launches of matvec, rmatvec and
   rank1_update what the path implies; ms an epoch (a const:2
   ``fit_serial`` in segments of 5, the second's). (b) ``sharded_fit`` over
   one NCCL worker on (a)'s data and draws: (a)'s bits and launches; at n
   cut to 16,384 (phase 26's cut) with a ``RunCheckpointer``, 12 epochs in
   segments of 4: steps [4, 8, 12], a resume from 8 the uninterrupted
   run's bits, a resume from 12 returns it and launches nothing. (e)
   PowerSGD (``optim.compression``) at rank 4 on a (1536, 8960) gradient
   (qwen2-1.5b's MLP), 5 steps: the CPU's result on the same draws within
   rtol 1e-4 (atol 1e-4 of max), over one NCCL worker the serial bits; ms
   a step, wire bytes against dense. (c) ``top_k_error`` of (a)'s head over
   all n rows, one ``factor_matvec`` launch a chunk of 65,536 rows, ties
   broken as ``jax.lax.top_k`` breaks them (the lower index first): every
   row's hit is the first 5 of a stable descending sort of the same logits;
   a row's hit may differ from the plain chain's (the same rule on its
   logits) only where the two chains' logits differ by more than half the
   row's 5th-to-6th gap; the tie probe of ROADMAP section 3 (a rank-1 head
   with one nonzero logit column on features >= 0) gives the reference's
   errors 0 (labels 0) and 1 (labels 5); the error below W = 0's (1 -
   5/1000); its wall ms, and in turns with the loop before the tie rule
   (torch.topk's indices); the kernel at the chunk operand timed beside its
   plain version and einsum (a row of the kernels line). (d) ``extract_features`` from
   qwen2-1.5b at full width and depth (bf16, weights drawn on the card) on
   8 batches of 4 x 2048 tokens: 65,536 x 1536 f32 features, 224
   flash_attention launches all on wgmma; ``train_head`` on labels from a
   planted rank-10 head over 1000 classes: the loss falls, the top-5 error
   below chance; then rwkv6-7b on one batch of 4 x 1024 tokens (128
   wkv6_chunk launches). About 10 s of command time.
30. LM training (4 x 2048 tokens a step, bf16, weights drawn on the card
   from --seed). (a) qwen2-1.5b at full width and depth through
   ``launch.train.train`` (AdamW, ``SyntheticLMStream``), 10 steps: losses
   finite, every parameter a nonzero gradient at every step (read from the
   steps' own ``lm.value_and_grad``), no flash_attention or wkv6_chunk
   launch in a train step (the reference's differentiable attention), then
   a prefill on the trained weights with one flash_attention launch a
   layer, all on wgmma; ms a step, tokens/s, peak memory. At a depth cut of
   2 layers (full width; a step's checkpoint ~2.8 GB): checkpoints at steps
   5 and 10, a run resumed at 5 gives the uninterrupted run's parameters
   and AdamW state bit for bit. (b) The hybrid optimizer (AdamW + the
   DFW-Trace head) on codeqwen1.5-7b at full width, 16 of 32 layers, mu
   100, 2 power iterations, 5 steps: each step matvec and rmatvec 2
   launches and the bf16 rank1_update 1 (device counts); after step 1
   (gamma = 1) the head's trace norm (f64 Gram eigenvalues) at most mu |u|
   |v| + sqrt(min(d, V)) ||E||_F, E the head's bf16 rounding; step 2's head
   update the bits of ((1 - gamma) W - gamma mu u v^T) in f32 rounded to
   bf16 on the step's own u and v, and within one bf16 ulp of the update's
   terms of the whole plain chain (torch.mv power iterations on the same
   f32 gradient and v0, then that update); every parameter a nonzero gradient;
   ms a step, the head's share (power method + update, CUDA events), peak
   memory. (c) rwkv6-7b at full width, 8 of 32 layers, 2 AdamW steps:
   losses finite, every parameter a nonzero gradient, no wkv6_chunk launch
   (the plain chunk form under autograd). (d) The bf16 rank1_update at
   4096 x 92,416 in place against its plain version (one bf16 ulp) and
   ``torch.addr_`` in bf16 (in turns), and matvec/rmatvec at the head
   gradient's shape against torch.mv (in turns), each beside its bound.
   (e) is phase 29 (c)'s tie rule. About a minute of command time.
31. Serving of the LM zoo's audio, vlm and hybrid families (bf16, weights
   drawn on the card from --seed, full width), after a check that the
   earlier phases hold under 2 GB of the card. (a) hubert-xlarge, all 48
   layers: the encoder step (``make_prefill_step`` of an encoder-only
   config) on 8 x 1,500 frames of 512 (30 s of audio at 50 frames/s):
   logits (8, 1500, 504) finite, no cache, 48 flash_attention launches all
   on the generic route (Dh 80, non-causal, ragged against its tiles); in
   f32 on 2 x 300 frames the encoder through the kernel against the plain
   attention (autograd recording through the frames sends
   ``layers.attention`` down the reference's differentiable path), 1e-3 of
   max. (b) zamba2-2.7b, all 54 Mamba-2 layers and the shared block's 9
   applications: prefill 4 x 4096 tokens, caches k/v (9, 4, 32, 4096, 80),
   mamba_h (54, 4, 80, 64, 64) f32, mamba_conv (54, 4, 3, 5248), 9 flash
   launches (generic); ``generate`` at batch 4 (64 + 32 tokens) captured,
   the step loop's bits and no flash launch; prefill against decode_step
   fed the same 4 x 64 prompt token by token: in f32 the logits and every
   layer's caches within 1e-3; in bf16 layer 0's Mamba-2 state and conv
   window and the first shared block's k and v within 5e-2 (the same
   inputs on both paths), the logits' distance printed beside each bf16
   path's distance from the f32 computation, not held (bf16 rounding
   through 63 blocks of a random-init model moves both paths about as far
   from f32 as from each other). (c) qwen2-vl-72b cut to 32 of its 80 layers
   (61 GB of bf16 weights; the whole model is 145 GB): first, in f32 at 4
   layers, a prefill of 2 x (64 vision embeddings + 63 tokens) and one
   decode step against the full forward's last logits (1e-3); then prefill
   4 x (1,024 vision embeddings + 1,024 tokens) with Qwen2-VL's positions
   (patches at (0, row, column) of a 32 x 32 grid, text from 32 on in all
   three streams), 32 flash launches all on wgmma; ``generate`` captured
   (the M-RoPE positions made in the captured step from the device
   position), the step loop's bits. ms per prefill (median of 3),
   tokens (frames) a second, ms per decode step captured and uncaptured,
   peak memory. (d) flash_attention at the three prefills' operands (B 8,
   H 16, S 1500, Dh 80, full; B 4, H 32, S 4096, Dh 80, causal; B 4, Hq 64
   / Hkv 8, S 2048, Dh 128, causal; bf16) against its plain version (1e-2
   of each row's max), the same bits on repeat, timed beside SDPA and the
   bound: rows of the kernels line. Under --profile, device time by kind
   (flash, GEMMs, the rest) of one prefill of each family and the idle
   share of a replayed decode step of zamba2 and qwen2-vl.
32. Serving of the moe family (bf16, weights drawn on the card from
   --seed, full width), after a check that the earlier phases hold under
   2 GB of the card (its allocation printed at its start and end). (a)
   arctic-480b (128 experts, top-2, a dense residual MLP beside them) cut
   to 2 of its 35 layers (27.2 GB a layer; three and the embeddings would
   be 82.6 GB): prefill 4 x 2048 tokens, 2 flash_attention launches all on
   wgmma (a GQA group of 7), last logits finite, cache (2, 4, 8, 2048,
   128); each layer's share of routed (token, expert) pairs the capacity
   (160 slots an expert) dropped and its busiest expert's load, from a
   recording wrapper around ``moe.moe_block`` in one more forward; the
   summed aux loss finite and positive; ``generate`` at batch 4 (64 + 32
   tokens) captured, the step loop's bits, no flash launch; the decode
   floor (every weight read once at the memory rate: each expert runs its
   MLP on its 4 slots). (b) llama4-scout-17b-a16e (16 experts, top-1,
   vocab 202,048) cut to 16 of 48 layers (4.16 GB a layer, 4.14 GB of
   embeddings, 3.3 GB of prefill logits: the prefill peaks near 74.6 GB
   alone; 17 peaked at 78.8 alone and ran out of memory after the earlier
   phases), the same, capacity 640, a group of 5. (c) ``moe_block`` in f32 on the card against the CPU at D 1024, F
   512, 8192 tokens, arctic's routing (E 128, top-2) and llama4-scout's (E
   16, top-1), router column 0 times 3 so that expert 0 drops tokens:
   picks index for index (a differing pick must sit at a k-th/(k+1)-th
   gap under 1e-6, and is named), each expert's selection slot for slot
   (a slot may hold another token only if the two tokens' CPU gates are
   within 1e-6: near-equal gates the two softmaxes order by rounding; the
   count of such slots printed), out within 1e-5 of max|CPU| on the tokens
   kept alike, aux within rtol 1e-6, the card's bits on repeat; the
   smallest gap printed. (d) flash_attention at both prefills' operands (B 4, Hq 56
   / Hkv 8 and Hq 40 / Hkv 8, S 2048, Dh 128, causal, bf16) on wgmma, as
   phase 31 (d): rows of the kernels line. ms per prefill (median of 3),
   tokens a second, peak memory, ms per decode step captured and
   uncaptured. Under --profile, device time by kind (flash, GEMMs, routing
   and dispatch, the rest) of one prefill of each and the idle share of a
   replayed decode step.
33. The sharded LM paths (``launch.mesh``/``sharding``/``params``,
   ``comm.spmd``). (a) ``launch.train.train(mesh_shape=(1, 1))`` over one
   NCCL worker: qwen2-1.5b whole, bf16, 2 steps of 2 x 2048, its losses,
   parameters and AdamW m the unsharded run's bits. (b)-(d) a (2, 2)
   (data, model) mesh on four gloo workers sharing the card (NCCL refuses
   two ranks on one device: a check, not a timing), in f32 against the
   unsharded runs on the card from the same --seed: qwen2-1.5b at full
   width cut to 2 of 28 layers (2 train steps of 4 x 1024, losses rtol
   2e-5; a prefill of 4 x 2048, last logits within 1e-4 of max; a batch-4
   decode step; 4 sequence-sharded batch-1 decode steps; each worker's
   share of the parameter bytes at most 0.26, its peak memory, the
   collectives a train step by kind and bytes), rwkv6-7b cut to 1 of 32
   layers (2 train steps and a prefill of 4 x 1024, ``wkv6_chunk`` on 32
   of 64 heads), llama4-scout cut to 1 of 48 layers (a prefill of 4 x 1024
   at capacity factor 32, where nothing drops, within 1e-4 of max; at the
   configured factor each data shard's dropped share by layer; and at the
   configured factor the gradient at the initial weights
   on 4 x 1024 tokens against one device's gradient with each data
   shard's rows routed on their own, which is what the mesh computes: its
   capacity and its Switch loss, averaged over the data shards, are per
   data shard; that 16.5 GB gradient stays on the host, each worker
   reading its blocks leaf by leaf). In (b)
   and (c) each worker holds its blocks of the gradient at the initial
   weights and of AdamW's m after the steps against the unsharded run's
   (read over CUDA IPC; (d) runs in a second spawn, once they are freed),
   each leaf within the larger of 1e-4 and 3x its spread in this run (the
   unsharded gradient's change when every weight moves by one rounding),
   and its parameters within 2.1 lr_1 of the unsharded run's (the
   schedule's one nonzero step, each side). (e) every worker launched
   ``flash_attention`` 4 times and ``wkv6_chunk`` 4 times
   (``kernels.Executed``). Then both kernels on the operands the shards
   give them, as strided views of a worker's projections (f32 as in
   (b)-(d) and bf16 as the configurations run), against their plain
   versions at phases 13 and 17's tolerances, with their times: rows of
   the kernels line. The phase prints its wall time.
34. LM training of the moe, hybrid, vlm and audio families (bf16, weights
   drawn on the card from --seed, full width, 2 steps each; what the
   earlier phases hold printed at its start). (a) hubert-xlarge whole on
   8 x 1,500 frames, (b) zamba2-2.7b whole on 4 x 2,048 tokens, (c)
   qwen2-vl-72b cut to 2 of its 80 layers on 4 x 2,048 positions (1,024
   vision embeddings, the loss over the 1,024 text positions), each
   through ``launch.train.train`` (AdamW): losses finite, every parameter
   a nonzero gradient (hubert's token embedding, which its frames never
   read, excepted), no flash_attention or wkv6_chunk launch; ms of the
   second step, tokens (frames) a second, peak memory, the launches. (d)
   llama4-scout-17b-a16e cut to 1 of 48 layers (4.1 B parameters) with
   the hybrid optimizer (AdamW + DFW-Trace on its 5120 x 202,048 head, mu
   100, 2 power iterations), 2 steps of 4 x 2,048 tokens: matvec and
   rmatvec 2 launches a step and the bf16 rank1_update one; the head's
   share of a step (CUDA events around the power method and the update);
   the layer's dropped share of the routed picks (one forward before the
   steps); the state after step 1 copied to the host, put back and step 2
   run again: the parameters and AdamW's m and v the uninterrupted run's
   bits (two 64-bit digests of each leaf's bit patterns: the card cannot
   hold two copies). (e) each family's ``lm.value_and_grad`` in f32 on
   the card, twice, against the CPU at a width that the CPU runs (d 256,
   2 layers): arctic's routing (E 16, top-2, the dense residual),
   llama4-scout's (E 16, top-1), zamba2 (2 Mamba-2 layers at q 256, the
   shared block applied twice), qwen2-vl (64 vision + 128 text), hubert
   (1,500 frames: one loss chunk); the loss within rtol 1e-5 and every
   gradient leaf within 1e-4 of its max (the CPU parity tests' bounds),
   the card's bits on repeat. (f) the hybrid step's kernels at
   llama4-scout's head: matvec and rmatvec on the 5120 x 202,048 f32
   gradient against their plain versions and ``torch.mv``, the bf16
   rank1_update in place against its plain version and ``addr_`` in
   bf16, each beside its bound (the gradient's 4.14 GB over the memory
   rate, 1.235 ms): rows of the kernels line.

The launches each fit phase checks (and the kernels line sums) are the
device's: ``counting`` opens ``kernels.Executed``, which adds a counter on
the device beside each launch (in the graph with it), since a wrapper
counts a captured call once, when captured; those fits' times carry the
counters' small kernels. Fits that are never captured (gloo workers, the
baselines) count their wrappers' calls.

``--coo-bits PATH`` runs only phases 1 and 6 and then G.v and G^T.u of
``coo_matvec`` at the full shape (x drawn from --seed), saving the results
and their times to PATH; ``--coo-ref`` names such a file from another run
and says whether the bits are the same; ``--src`` imports the port from
another checkout's ``src``, so two versions of the kernel are compared in
one call (old, new, new, old), each on the same data made from --seed.

``--profile`` adds 3-epoch fits of the three tasks, 50 captured serving
dispatches, one prefill and a short captured decode of each LM under
``torch.profiler`` (device time by kernel, the device's idle share; the
decode's over its replayed steps); ``--report PATH`` writes every
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
import contextlib
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
            "update_resid_block": "coo_matvec", "update_resid_caller": "coo_matvec",
            # not a block form: the bf16 Z route of the rank1_update wrapper (phase 30)
            "rank1_update_bf16": "rank1_update"}
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
    "rank1_update_bf16": "src/repro_torch/csrc/rank1_update.cu",
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
# decode's. The hybrid family (phase 31) in bf16: its logits after 54
# Mamba-2 layers and 9 shared blocks are not held (on an NVIDIA H100 80GB
# HBM3, bf16 prefill and bf16 decode each landed about 6e-2 from the f32
# computation on the same weights, 7e-2 from each other; the JAX package's
# own bf16 prefill and decode part likewise, growing with depth, on the
# smoke config); layer 0's caches and the first shared block's
# k and v, computed from the same inputs on both paths, are held to 5e-2.
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
    # In place, as the fits call them (out is the operand): held to the
    # out-of-place bits and timed in turns against addr_ (rank1_update) and
    # against the chain addr_ + add_ (rank1_update_axpy: no one call computes it).
    W = torch.empty_like(R)
    rows_out.append(block_row_in_place(
        torch, "rank1_update", "R in place", R.shape,
        lambda: r1.rank1_update(W, x_n, y_m, a, b, out=W),
        lambda: W.addr_(x_n, y_m, beta=0.7, alpha=-0.3), W, R,
        r1.rank1_update(R, x_n, y_m, a, b), 8 * nm + 4 * (n + PAPER_M), 4 * nm, peaks, reps))
    rows_out.append(block_row_in_place(
        torch, "rank1_update_axpy", "R, Y in place", R.shape,
        lambda: r1.rank1_update_axpy(W, Y, x_n, y_m, a, b, c, out=W),
        lambda: W.addr_(x_n, y_m, beta=0.7, alpha=-0.3).add_(Y, alpha=-0.15), W, R,
        r1.rank1_update_axpy(R, Y, x_n, y_m, a, b, c), 12 * nm + 4 * (n + PAPER_M), 6 * nm,
        peaks, reps, chain=True))
    del out, W
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


@contextlib.contextmanager
def counting(kernels):
    """The launches the device runs inside the block, graph replays and
    IF-node bodies included (``kernels.Executed``, counted on the device),
    with the wrappers' call counts from 0: yields the Executed, whose
    ``launches`` and ``routes`` hold the counts after the block. A wrapper
    counts a captured call once, when captured, so on a captured fit only
    the device's count says what ran. Times taken inside carry the
    counters' cost (one small kernel a launch)."""
    kernels.reset_launches()
    with kernels.Executed() as ex:
        yield ex


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
    seg_log = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting(kernels) as ran:  # its times carry the counters' cost
        t0 = time.perf_counter()
        res = dfw.fit_serial(task, X, target, cfg=cfg, key=seed, device=dev,
                             callback=segment_timer(torch, seg_log))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ran.launches
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
                "ring_matmat_kernel", "rmatmat_finish_kernel",
                "rankk_kernel", "piece_sum_block_kernel", "segment_sum_block_kernel",
                "update_resid_block_kernel",
                # the engine's graphs: an IF node's predicate
                "set_if_kernel",
                # the hybrid optimizer's bf16 head update
                "rank1_bf16_kernel")
RECORD_KERNELS = ("pack_records_kernel", "gather_records_kernel")  # the state build's copies


def is_kernel(part: str, key: str) -> bool:
    """Whether the profiler's kernel name ``key`` is the kernel ``part`` (a
    whole word: quantize_kernel is not dequantize_kernel)."""
    return re.search(rf"\b{part}\b", key) is not None
FLASH_KERNELS = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")  # the two routes
WKV6_KERNEL = "wkv6_chunk_kernel"  # the ssm profile's own sum


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
    """update_resid (through MatrixCompletion.update, in place) against the
    update's plain chain followed by gather_sorted, bit for bit, at the MC shape and
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
                # the chain from the residual before the update, which runs
                # in place, as the fits call it
                want = mc.ref.resid_step(gamma, mu_, st.resid, st.vals, st.weight, u[st.rows],
                                         v[st.cols])
                got = tasks.MatrixCompletion(st.by_row.out_dim, st.by_col.out_dim).update(
                    st, u, v, gamma, mu_)
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
    row = dict(name="update_resid", operand=f"resid in three orders, in place, {p} entries",
               shape=[d, m, p], max_abs_err=0.0, max_rel_err=0.0, bits_identical=True,
               ms=time_ms(torch, lambda: tasks.MatrixCompletion(d, m).update(
                   state, u, v, gamma, mu), reps),
               plain_ms=time_ms(torch, plain, reps), library_ms=None,
               bound_ms=1e3 * nbytes / peaks[0], bound_by="bytes", bytes=nbytes)
    print(f"kernel update_resid ({p} entries, caller, row and column order, in place): "
          f"{row['ms']:.3f} ms "
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
        self.stochastic = True  # the engine hands it each exchange's noise

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
        # the recorder reads every exchange on the host, which no graph can
        # hold: the card runs the engine's uncaptured mode
        res.append(fw.fit(ktask, state, key=V0Stream.from_table(table), noise=noise,
                          reducer=rec, device=where, mode="legacy" if where == dev else "scan",
                          **kw))
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


def timed_fit(torch, kernels, run, dev, captured=True):
    """run() under fresh launch counts: (result, launches, wall s, segment
    log). ``captured``: under ``counting`` (the launches the device ran; the
    wall time carries the counters' cost); else (a gloo worker, whose fit
    is never captured) the wrappers' calls, which are its launches."""
    seg_log = []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with counting(kernels) if captured else contextlib.nullcontext() as ran:
        kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        res = run(segment_timer(torch, seg_log))
        sync()
        wall = time.perf_counter() - t0
    return res, ran.launches if captured else kernels.launches(), wall, seg_log


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
                    check(res.stats["graph_replays"] >= res.stats["segments_run"],
                          f"(a) {label}: {side} ran {res.stats['graph_replays']} of "
                          f"{res.stats['segments_run']} segments as graph replays")
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
            callback=cb), device, captured=False)
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
# phase 28 (e): requests a pass on each of four engines; 4,000 dispatches a
# side a pass put each side's p99 among 40 samples, not 2
TELEMETRY_REQUESTS = 2000


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
                    print(f"  device time per call: kernel {fmt_ms(row['device_ms'])} ms, einsum "
                          f"{fmt_ms(row['library_device_ms'])}, chain "
                          f"{fmt_ms(row['library_chain_device_ms'])}; plan {row['plan']}")
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


def step_bytes(directory, step: int) -> int:
    """The bytes of one checkpoint step on disk."""
    return sum(f.stat().st_size for f in Path(directory, f"step_{step:08d}").iterdir())


def train_then_serve(torch, np, dfw, tasks, ckpt, serve, low_rank, kernels, fm, dev, gen, args):
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
        with counting(kernels) as ran:
            t0 = time.perf_counter()
            res = dfw.fit_serial(tasks.MultiTaskLeastSquares(SERVE_D, SERVE_M), X, Y, cfg=cfg,
                                 key=args.seed, device=dev)
            torch.cuda.synchronize()
            rep["fit_s"] = time.perf_counter() - t0
        fit_launch = ran.launches
        want = expected_launches("mtls", res.history["k"], cfg.verify_kernels)
        check(fit_launch == want, f"serve fit: launches {fit_launch} != expected {want}")
        steps = ckpt.store.list_steps(ckdir)
        check(steps[-1] == args.serve_epochs and len(steps) == res.stats["segments_run"],
              f"serve fit: checkpoint steps {steps} for {res.stats['segments_run']} segments")
        nbytes = step_bytes(ckdir, steps[-1])
        rep.update(steps=steps, step_bytes=nbytes, fit_stats=res.stats)
        print(f"serve fit: MTLS n={n} d={SERVE_D} m={SERVE_M}, {res.epochs_run} epochs in "
              f"{rep['fit_s']:.2f} s, checkpoint steps {steps} ({nbytes / 1e9:.3f} GB each)")
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
        caps = {s: serve.rank_bucket(int(ckpt.read_iterate_packed(ckdir, s)[1]["count"]),
                                     SERVE_BLOCK) for s in steps}
        torch.cuda.synchronize()
        # the main path's serving run: launches counted on the device (a
        # dispatch is a graph replay, which calls no wrapper)
        with counting(kernels) as ran:
            t0 = time.perf_counter()
            eng = serve.ServingEngine.from_checkpoint(ckdir, scfg, step=steps[0], device=dev)
            rep["first_load_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            served = []  # (step, capacity, x, scores) checked after the scoring window
            lat, lat_async = [], []  # a round trip (score), its dispatch (score_async)
            for _ in range(args.serve_batches):
                x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
                t0 = time.perf_counter()
                pending = eng.score_async(x)
                t1 = time.perf_counter()
                got = pending.block()
                lat.append(time.perf_counter() - t0)
                lat_async.append(t1 - t0)
                served.append((steps[0], eng.model.capacity, x, got))
            # hot-swap to the latest step (another bucket) while a batch is in flight
            x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
            cap = eng.model.capacity
            first = eng.score_async(x)
            t0 = time.perf_counter()
            eng.load(ckdir)
            swap_s = [time.perf_counter() - t0]
            second = eng.score_async(x)
            check(first.version == 0 and second.version == 1 and second.step == steps[-1],
                  f"in-flight swap: versions {first.version}, {second.version}")
            served += [(steps[0], cap, x, first.block()),
                       (steps[-1], eng.model.capacity, x, second.block())]
            # every step in turn, one batch each
            for step in steps[1:]:
                t0 = time.perf_counter()
                eng.load(ckdir, step=step)
                swap_s.append(time.perf_counter() - t0)
                x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
                served.append((step, eng.model.capacity, x, eng.score(x)))
            # a swap inside one bucket while a batch is in flight: the new
            # factors overwrite the bucket's slots, after the pending replay
            pair = next(((a, b) for a, b in zip(steps, steps[1:]) if caps[a] == caps[b]), None)
            check(pair is not None, f"no two consecutive steps share a bucket: {caps}")
            eng.load(ckdir, step=pair[0])
            x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
            held = eng.score_async(x)
            eng.load(ckdir, step=pair[1])
            after = eng.score_async(x)
            check(held.step == pair[0] and after.step == pair[1],
                  f"same-bucket swap: steps {held.step}, {after.step} != {pair}")
            served += [(pair[0], caps[pair[0]], x, held.block()),
                       (pair[1], caps[pair[1]], x, after.block())]
            check(not np.array_equal(held.block(), after.block()),
                  f"same-bucket swap: steps {pair} scored alike")
            buckets = {caps[s] for s in steps}
            check(eng.stats["compilations"] == len(buckets),
                  f"rank buckets prepared {eng.stats['compilations']} != visited {len(buckets)}")
            # a full batch under the serving contract: no implicit host sync
            x = rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
            with eng.contract().guard():
                guarded = eng.score_async(x)
            served.append((eng.model.step, eng.model.capacity, x, guarded.block()))
            eng.check_contract(eng.contract(max_compilations=len(buckets)))
            # 640 single requests through a MicroBatcher: ten batches in flight
            batcher = serve.MicroBatcher(eng, flush_at=SERVE_BATCH)
            singles = rng.standard_normal((10 * SERVE_BATCH, SERVE_D), dtype=np.float32)
            tickets = [batcher.submit(q) for q in singles]
            check(batcher.pending_count == 0 and all(tk.dispatched for tk in tickets),
                  "micro-batcher left requests queued")
            served.append((eng.model.step, eng.model.capacity, singles,
                           np.stack([tk.result() for tk in tickets])))
            rise = torch.cuda.max_memory_allocated() - base_mem
            dispatches = eng.stats["dispatches"]
            check(dispatches == args.serve_batches + 2 + len(steps) - 1 + 2 + 1 + 10,
                  f"serving dispatches {dispatches}")
            # a transposed engine on the latest step (the first engine's
            # start-up check covered both directions)
            teng = serve.ServingEngine.from_checkpoint(
                ckdir, serve.ServeConfig(max_batch=SERVE_BATCH, rank_block=SERVE_BLOCK,
                                         transpose=True, verify_kernels=False), device=dev)
            tserved = []
            for _ in range(20):
                x = rng.standard_normal((SERVE_BATCH, SERVE_M), dtype=np.float32)
                tserved.append((teng.model.step, teng.model.capacity, x, teng.score(x)))
        serve_launch = ran.launches
        calls = kernels.launches()["factor_matvec"]
        dispatches += teng.stats["dispatches"]
        graphs = eng.stats["compilations"] + teng.stats["compilations"]
        # the device ran: the start-up check's 2, one warm-up a captured
        # bucket, one replay a dispatch; the wrapper was called for the
        # check, the warm-ups and the captures
        check(serve_launch["factor_matvec"] == 2 + graphs + dispatches,
              f"factor_matvec launches {serve_launch['factor_matvec']} != 2 + {graphs} warm-ups "
              f"+ {dispatches} dispatches")
        check(calls == 2 + 2 * graphs, f"factor_matvec calls {calls} != 2 + 2 x {graphs} graphs")
        check(rise < 4 * SERVE_D * SERVE_M,
              f"scoring raised device memory by {rise} bytes, a d x m f32 matrix is "
              f"{4 * SERVE_D * SERVE_M}")
        # every score against x @ W (or x @ W^T) on the card, and bit for bit
        # against the uncaptured kernel on the same padded inputs and factors
        ws = {s: dense(s) for s in steps}
        worst = max(score_err(got, x, ws[s]) for s, _, x, got in served)
        worst_t = max(score_err(got, x, ws[s].T) for s, _, x, got in tserved)
        check(worst <= TOL["serve"] and worst_t <= TOL["serve"],
              f"served scores differ from x @ W: rel err {worst:.3e} / transposed {worst_t:.3e}")
        del ws
        factors = {}  # (step, capacity) -> the device factors a load makes of them

        def model_at(step, cap):
            if (step, cap) not in factors:
                packed = ckpt.read_iterate_packed(ckdir, step)[1]
                it = low_rank.unpack_live(packed, cap, device=dev)
                factors[step, cap] = (it.u, it.s * it.alpha, it.v)
            return factors[step, cap]

        bits = all(np.array_equal(got, uncaptured_scores(torch, np, fm, dev, model_at(s, c), x,
                                                         False))
                   for s, c, x, got in served) and all(
            np.array_equal(got, uncaptured_scores(torch, np, fm, dev, model_at(s, c), x, True))
            for s, c, x, got in tserved)
        check(bits, "captured scores differ from the uncaptured factor_matvec's bits")
    lat_ms = sorted(1e3 * v for v in lat)
    rep.update(
        dispatches=dispatches, compilations=eng.stats["compilations"], buckets=sorted(buckets),
        launches=serve_launch["factor_matvec"], wrapper_calls=calls, memory_rise_bytes=rise,
        latency_p50_ms=statistics.median(lat_ms),
        latency_p99_ms=lat_ms[min(len(lat_ms) - 1, math.ceil(0.99 * len(lat_ms)) - 1)],
        dispatch_host_p50_us=1e6 * statistics.median(lat_async),
        requests_per_s=SERVE_BATCH * len(lat) / sum(lat), swap_ms=[1e3 * v for v in swap_s],
        capture_ms=eng.timings["capture_ms"] + teng.timings["capture_ms"],
        pool_bytes=eng.timings["pool_bytes"] + teng.timings["pool_bytes"],
        same_bucket_swap=list(pair), max_rel_err=worst, max_rel_err_transposed=worst_t)
    print(f"serve: {len(lat)} batches of {SERVE_BATCH} at live rank {steps[0]} (bucket "
          f"{caps[steps[0]]}), one graph replay each: per dispatch p50 "
          f"{rep['latency_p50_ms']:.4f} ms, p99 {rep['latency_p99_ms']:.4f} ms (score_async "
          f"p50 {rep['dispatch_host_p50_us']:.1f} us of host time), "
          f"{rep['requests_per_s']:.0f} requests/s")
    print(f"serve: hot-swaps {', '.join(f'{v:.2f}' for v in rep['swap_ms'])} ms (in flight "
          f"across buckets and inside bucket {caps[pair[0]]}, steps {pair}); buckets "
          f"{sorted(buckets)} captured {eng.stats['compilations']} (+{teng.stats['compilations']} "
          f"transposed) in {', '.join(f'{v:.2f}' for v in rep['capture_ms'])} ms, pool bytes "
          f"{rep['pool_bytes']}; {dispatches} dispatches, {serve_launch['factor_matvec']} "
          f"factor_matvec launches run, {calls} calls; scoring added {rise} bytes of device "
          f"memory; max rel err {worst:.2e} (transposed {worst_t:.2e}); every score the "
          f"uncaptured kernel's bits; a full batch under the contract's guard")
    return rep, fit_launch, serve_launch, eng


def uncaptured_scores(torch, np, fm, dev, factors, x, transpose: bool):
    """``factor_matvec`` called directly (no graph) on a model's device
    factors (u, s * alpha, v at its bucket's capacity, as ``load`` makes
    them) and x zero-padded to full batches, as the engine stages it: the
    caller's rows."""
    u, s_alpha, v = factors
    a, b = (v, u) if transpose else (u, v)
    out = []
    for i in range(0, x.shape[0], SERVE_BATCH):
        pad = torch.zeros((SERVE_BATCH, x.shape[1]), dtype=torch.float32, device=dev)
        rows = x[i:i + SERVE_BATCH]
        pad[:rows.shape[0]] = torch.from_numpy(rows).to(dev)
        out.append(fm.factor_matvec(pad, a, s_alpha, b)[:rows.shape[0]].cpu().numpy())
    return np.concatenate(out)


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


def fa_routed(kernels, call, want):
    """Run ``call`` and check that it launched flash_attention once, on
    route ``want``."""
    before = kernels.route_launches()["flash_attention"]
    out = call()
    after = kernels.route_launches()["flash_attention"]
    moved = {r: after[r] - before[r] for r in after if after[r] != before[r]}
    check(moved == {want: 1}, f"flash_attention took {moved}, expected {{{want!r}: 1}}")
    return out


def fa_plain(torch, fa, q, k, v, scale, causal, chunk=1024):
    """flash_attention's plain version; past 4096 rows over 1024-row query
    chunks (the whole score matrix would take 13 GB at the main shape, 52 GB
    at 32k)."""
    if q.shape[2] <= FA_ALL_ROWS:
        return fa.ref.attention(q, k, v, scale=scale, causal=causal)
    return torch.cat([fa.ref.attention(q[:, :, i:i + chunk], k, v, scale=scale, causal=causal,
                                       q_offset=i)
                      for i in range(0, q.shape[2], chunk)], dim=2)


def fa_error(torch, fa, got, q, k, v, scale, causal):
    """Each query row against its own max|plain|, the plain version on the
    f32 upcast: every row up to S = 4096, else the first and last 256 query
    rows. Returns max |kernel - plain|, the worst row's share of its
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


def flash_row(torch, fa, kernels, label, q, k, v, causal, nrep, peaks, main=False):
    """flash_attention at one operand: the route it takes (bf16 with Dh 64
    or 128 on wgmma, the rest generic), each query row held to the plain
    version (``fa_error``; bf16 1e-2, f32 1e-4), the same bits on repeat;
    times of kernel, plain version and scaled_dot_product_attention (median
    of ``nrep``) beside the bound. Returns the kernels line's row."""
    bw, f32_peak, bf16_peak = peaks[:3]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, hq, s, dh = q.shape
    hkv, skv, dtype = k.shape[1], k.shape[2], q.dtype
    scale = dh ** -0.5
    route = "wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "generic"
    got = fa_routed(kernels, lambda: fa.flash_attention(q, k, v, scale=scale, causal=causal),
                    route)
    torch.cuda.synchronize()
    err_abs, err_rel, err_last = fa_error(torch, fa, got, q, k, v, scale, causal)
    tol = TOL["flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention"]
    check(math.isfinite(err_rel) and err_rel <= tol,
          f"flash_attention {label}: row-relative err {err_rel:.3e} > {tol:.0e}")
    check(torch.equal(fa.flash_attention(q, k, v, scale=scale, causal=causal), got),
          f"flash_attention {label} is not bit-stable")
    del got
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * b * hq * s * dh + 2 * b * hkv * skv * dh)
    nflops = 4 * dh * b * hq * attention_pairs(s, skv, causal)
    peak = bf16_peak if dtype == torch.bfloat16 else f32_peak
    row = dict(
        name="flash_attention", operand=f"{label}: B={b} Hq={hq} Hkv={hkv} S={s} Dh={dh} "
        f"{'causal' if causal else 'full'} {str(dtype)[6:]}",
        shape=[b, hq, hkv, s, skv, dh], max_abs_err=err_abs, max_rel_err=err_rel,
        last_rows_rel_err=err_last, tol=tol,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, scale=scale, causal=causal), nrep),
        plain_ms=time_ms(torch, lambda: fa_plain(torch, fa, q, k, v, scale, causal), nrep),
        library_ms=time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True,
                                               scale=scale), nrep),
        bound_ms=1e3 * max(nbytes / bw, nflops / peak),
        bound_by="bytes" if nbytes / bw >= nflops / peak else "operations",
        bytes=nbytes, flops=nflops, main=main, route=route)
    if route == "wgmma":
        # the p_hi/p_lo split runs the P.V products twice: 1.5x the work
        row["split_floor_ms"] = 1.5 * 1e3 * nflops / peak
    row["tflops"] = nflops / row["ms"] / 1e9
    print(f"kernel flash_attention {row['operand']} ({route} route): {row['ms']:.3f} ms "
          f"({row['tflops']:.1f} TFLOP/s; plain {row['plain_ms']:.3f}, sdpa "
          f"{row['library_ms']:.3f}, bound {row['bound_ms']:.4f} by {row['bound_by']}"
          + (f", split floor {row['split_floor_ms']:.4f}" if route == "wgmma" else "")
          + f") row-relative err {err_rel:.2e}, last rows {err_last:.2e} (limit {tol:.0e}), "
          "bit-stable")
    return row


def flash_kernel_phase(torch, fa, kernels, _build, dev, gen, reps, peaks):
    """flash_attention against its plain version: the main path's shape (B 4,
    S 8192, causal, bf16), prefill_32k's length (B 1, S 32,768), non-causal
    cases, tiny odd f32 ones and ragged bf16 ones; identical bits on repeat;
    the route each took; the HGMMA count of the wgmma kernels; times of
    kernel, plain version and scaled_dot_product_attention."""
    counts = hgmma_counts(_build)
    for fn, n in sorted(counts.items()):
        print(f"  SASS of {fn}: {n} HGMMA instructions")
    check(len(counts) == 2 and all(n > 0 for n in counts.values()),
          f"no HGMMA in the wgmma kernels' SASS: {counts}")

    def routed(call, want):
        return fa_routed(kernels, call, want)

    def inputs(b, hq, hkv, sq, skv, dh, dtype):
        return [torch.randn(b, h, s, dh, generator=gen, device=dev).to(dtype)
                for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]

    def error(got, q, k, v, scale, causal):
        return fa_error(torch, fa, got, q, k, v, scale, causal)

    rows_out = []
    big = [  # (label, b, sq, causal, dtype, reps)
        ("main path", *FA_MAIN, True, torch.bfloat16, max(3, reps // 3)),
        ("prefill_32k length", 1, PREFILL_32K, True, torch.bfloat16, 3),
        ("non-causal", 1, FA_ALL_ROWS, False, torch.bfloat16, reps),
        ("non-causal f32", 1, FA_ALL_ROWS, False, torch.float32, reps),
    ]
    for label, b, s, causal, dtype, nrep in big:
        q, k, v = inputs(b, FA_HQ, FA_HKV, s, s, FA_DH, dtype)
        rows_out.append(flash_row(torch, fa, kernels, label, q, k, v, causal, nrep, peaks,
                                  main=label == "main path"))
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


def captured_decode(torch, np, kernels, lm, steps, lm_serve, arch, cfg, params, dev, seed,
                    label, absent):
    """``generate`` at batch DECODE_BATCH, a DECODE_PROMPT-token prompt and
    DECODE_NEW new tokens, greedy: one captured step replayed for every
    position. Its tokens and the cache it filled are held bit for bit to a
    loop of the uncaptured serve step on the same weights and prompt (the
    prompt fed token by token, then the last token); the device runs no
    launch of ``absent`` (decode is plain PyTorch, as in the reference)."""
    b, plen, new_n = DECODE_BATCH, DECODE_PROMPT, DECODE_NEW
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen, device=dev)
    cache = lm.init_cache(cfg, b, plen + new_n, device=dev)
    stats = {}
    torch.cuda.synchronize()
    with counting(kernels) as ran:
        new = lm_serve.generate(arch=arch, smoke=False, batch=b, prompt_len=plen,
                                max_new_tokens=new_n, seed=seed, device=dev, params=params,
                                prompt=prompt.cpu().numpy(), cache=cache, stats=stats)
    launches = ran.launches
    check(all(v == 0 for v in launches.values()), f"{label}: launches {launches}")
    check(stats["captures"] == 1 and stats["graph_replays"] == plen + new_n - 1,
          f"{label}: {stats['captures']} captures, {stats['graph_replays']} replays")
    check(new.shape == (b, new_n) and int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size,
          f"{label}: tokens {new.shape} out of range")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_cache = step_loop(torch, lm, steps, cfg, params, prompt, new_n)
    want = want.cpu().numpy()
    eager_s = time.perf_counter() - t0
    check(np.array_equal(new, want), f"{label}: captured tokens differ from the step loop's")
    for name in cache:
        check(torch.equal(cache[name], want_cache[name]),
              f"{label}: the captured run's cache {name!r} differs from the step loop's")
    eager_ms = 1e3 * eager_s / (plen + new_n - 1)
    rep = dict(stats, batch=b, prompt_len=plen, new_tokens=new_n,
               ms_per_token=stats["ms_per_step"], uncaptured_ms_per_step=eager_ms,
               distinct_tokens=int(np.unique(new).size), layers=len(params["layers"]))
    print(f"decode {cfg.name} at batch {b}: {stats['steps']} steps, one graph replay each: "
          f"{stats['ms_per_step']:.3f} ms per step (uncaptured step loop {eager_ms:.3f} ms); "
          f"capture {stats['capture_ms']:.1f} ms, graph pool {stats['pool_bytes']} bytes; "
          f"tokens and every cache the step loop's bits; 0 {absent} launches")
    return rep, launches


def step_loop(torch, lm, steps, cfg, params, prompt, new_n: int):
    """Greedy decode by a loop of the uncaptured serve step: the prompt fed
    token by token, then each step's argmax, with the position an int (vlm:
    and M-RoPE positions built on the host each step). Returns (new tokens
    (B, new_n), the cache it filled)."""
    b, plen = prompt.shape
    step = steps.make_serve_step(cfg)
    cache = lm.init_cache(cfg, b, plen + new_n, device=prompt.device)
    toks = []
    for t in range(plen + new_n - 1):
        cur = prompt[:, t:t + 1] if t < plen else toks[-1]
        batch = {"tokens": cur, "cache_pos": t}
        if cfg.family == "vlm":  # M-RoPE positions (t, t, t), as the reference's generate
            batch["positions"] = torch.full((b, 3, 1), t, dtype=torch.int64,
                                            device=prompt.device)
        logits, _ = step(params, cache, batch)
        if t >= plen - 1:
            toks.append(torch.argmax(logits[:, 0, :].float(), dim=-1, keepdim=True))
    return torch.cat(toks, dim=1), cache


def lm_decode_phase(torch, np, kernels, lm, steps, lm_serve, cfg, dev, seed):
    """Phase 15: ``generate`` at full width, captured, against the step
    loop; weights drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = lm.init_params(cfg, gen)
    return captured_decode(torch, np, kernels, lm, steps, lm_serve, LM_ARCH, cfg, params, dev,
                           seed, "decode", "flash_attention")


def prefill_and_decode(torch, lm, steps, cfg, params, toks):
    """The prefill (flash kernel) and decode_step fed the prompt token by
    token (dense path): ((last-position logits in f32, cache) of each)."""
    last, pcache = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    cache = lm.init_cache(cfg, toks.shape[0], toks.shape[1], device=toks.device)
    for t in range(toks.shape[1]):
        logits, cache = lm.decode_step(params, cache, {"tokens": toks[:, t:t + 1],
                                                       "cache_pos": t}, cfg)
    return (last.float(), pcache), (logits[:, 0].float(), cache)


def prefill_vs_decode(torch, lm, steps, cfg, params, toks):
    """Last-position logits of ``prefill_and_decode``: max diff / max
    |decode|."""
    (last, _), (logits, _) = prefill_and_decode(torch, lm, steps, cfg, params, toks)
    return rel_err(torch, last, logits)[1]


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


def decode_idle(row, stats, busy_us) -> None:
    """The captured decode's idle share: the device time of one step (the
    profiled call's device time over its warm-up step and replays, which run
    the same kernels) against the wall time of a replayed step. The call's
    own wall time also holds the capture, so its idle share says little."""
    if not busy_us:
        return
    step_busy_ms = busy_us / 1e3 / (stats["graph_replays"] + 1)
    row.update(step_busy_ms=step_busy_ms, ms_per_step=stats["ms_per_step"],
               capture_ms=stats["capture_ms"],
               captured_idle_share=1.0 - step_busy_ms / stats["ms_per_step"])
    print(f"profile decode, captured: device {step_busy_ms:.3f} ms a step, wall "
          f"{stats['ms_per_step']:.3f} ms a replayed step: idle share "
          f"{row['captured_idle_share']:.3f}")


def profile_lm(torch, lm, lm_serve, steps, cfg, params, toks, dev, seed):
    """Device time by kernel and the idle share of one prefill and of a
    short decode (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out, dstats = {}, {}
    step = steps.make_prefill_step(cfg)
    runs = (("prefill", lambda: step(params, {"tokens": toks})),
            ("decode", lambda: lm_serve.generate(
                arch=LM_ARCH, smoke=False, batch=DECODE_BATCH, prompt_len=8,
                max_new_tokens=8, seed=seed, device=dev, params=params, stats=dstats)),
            ("decode, uncaptured", lambda: step_loop(
                torch, lm, steps, cfg, params, toks[:DECODE_BATCH, :8].expand(DECODE_BATCH, 8),
                8)))
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
        if label == "decode":
            decode_idle(out[label], dstats, busy)
        elif label == "decode, uncaptured":
            out[label]["step_busy_ms"] = busy / 1e3 / 15
            out[label]["ms_per_step"] = wall_us / 1e3 / 15
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


def ssm_decode_phase(torch, np, kernels, lm, steps, lm_serve, cfg, params, dev, seed):
    """Phase 19: ``generate`` at full width with the prefill's weights,
    captured, against the step loop; no wkv6_chunk launch (decode is the
    exact recurrence in plain PyTorch, as in the reference)."""
    return captured_decode(torch, np, kernels, lm, steps, lm_serve, SSM_ARCH, cfg, params, dev,
                           seed, "ssm decode", "wkv6_chunk")


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


def profile_ssm(torch, lm, lm_serve, steps, cfg, params, toks, dev, seed):
    """Device time by kernel and the idle share of one ssm prefill and of a
    short decode (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    out, dstats = {}, {}
    step = steps.make_prefill_step(cfg)
    runs = (("prefill", lambda: step(params, {"tokens": toks})),
            ("decode", lambda: lm_serve.generate(
                arch=SSM_ARCH, smoke=False, batch=DECODE_BATCH, prompt_len=8,
                max_new_tokens=8, seed=seed, device=dev, params=params, stats=dstats)),
            ("decode, uncaptured", lambda: step_loop(
                torch, lm, steps, cfg, params, toks[:DECODE_BATCH, :8].expand(DECODE_BATCH, 8),
                8)))
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
        wkv = sum(t for k, t in dev_us.items() if WKV6_KERNEL in k)
        out[label] = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3, wkv6_ms=wkv / 1e3,
                          idle_share=1.0 - busy / wall_us if busy else None,
                          top=sorted(((k[:90], t / 1e3) for k, t in dev_us.items()),
                                     key=lambda kv: -kv[1])[:10])
        if label == "decode":
            decode_idle(out[label], dstats, busy)
        elif label == "decode, uncaptured":
            out[label]["step_busy_ms"] = busy / 1e3 / 15
            out[label]["ms_per_step"] = wall_us / 1e3 / 15
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
              plain_reps=None, exact=False, main=False, in_turns=False, floor_ms=None):
    """One block form against its plain version at one shape: the error (or
    the bits), the bits on repeat, and the times of kernel, plain version and
    library call beside the bound. ``in_turns``: kernel and library call are
    timed kernel, call, call, kernel (as phase 2 times matvec against
    torch.mv), ms and library_ms the means of the two rounds. ``floor_ms``:
    the gather floor (random sectors at the rate measured in this run, plus
    the sequential bytes), printed and kept beside the bound."""
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
               library_ms=time_ms(torch, lfn, reps) if lfn is not None else None,
               bound_ms=1e3 * max(nbytes / bw, nflops / flops),
               bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
               bytes=nbytes, main=main)
    if floor_ms is not None:
        row["gather_floor_ms"] = floor_ms
    if in_turns:
        lib2, ms2 = time_ms(torch, lfn, reps), time_ms(torch, kfn, reps)
        row.update(ms_rounds=[row["ms"], ms2], library_ms_rounds=[row["library_ms"], lib2],
                   ms=(row["ms"] + ms2) / 2, library_ms=(row["library_ms"] + lib2) / 2)
        row["library_ratio"] = row["ms"] / row["library_ms"]
    row["plain_ms"] = time_ms(torch, pfn, plain_reps or reps)
    print(f"kernel {name:18s} {label}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
          f"library {row['library_ms']}, bound {row['bound_ms']:.3f} by {row['bound_by']}) "
          f"rel err {err_rel:.2e}, bits repeat")
    if floor_ms is not None:
        print(f"  gather floor {floor_ms:.3f} ms: the kernel at {floor_ms / row['ms']:.3f} of it, "
              f"{row['bound_ms'] / row['ms']:.3f} of the bound")
    if in_turns:
        print(f"  in turns: {name} {row['ms_rounds']} ms against the library's "
              f"{row['library_ms_rounds']}: {row['library_ratio']:.4f} of its time, "
              f"{row['bound_ms'] / row['ms']:.3f} of the bound")
    return row


def block_dense_kernels(torch, pm, r1, dev, X, Y, gen, reps, peaks):
    """(a) matmat/rmatmat on R and X, the rank-k updates on R (and Y) at
    n = 1,281,167, k = 8 and 32: out of place against their plain versions
    and in place (as the fits call them) against the out-of-place bits, each
    timed in turns with its library call."""
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    R = torch.neg(Y)
    g = torch.full((), 0.3, device=dev)
    a, b, c = 1.0 - g, -g * 1.5, -g
    scal2, scal3 = torch.stack([a, b]), torch.stack([a, b, c])
    rows = []
    out, W = torch.empty_like(R), torch.empty_like(R)
    for k in BLOCK_KS:
        for label, A in (("R", R), ("X", X)):
            n, m = A.shape
            v, u = rn(m, k), rn(n, k)
            nbytes, nflops = 4 * (n * m + (n + m) * k), 2 * n * m * k
            main = label == "X" and k == 32  # block:32's widest pass
            rows.append(block_row(torch, "matmat", f"{label} k={k}", (n, m, k),
                                  lambda: pm.matmat(A, v), lambda: pm.ref.matmat(A, v),
                                  lambda: torch.matmul(A, v), nbytes, nflops, peaks, reps,
                                  main=main, in_turns=True))
            rows.append(block_row(torch, "rmatmat", f"{label} k={k}", (n, m, k),
                                  lambda: pm.rmatmat(A, u), lambda: pm.ref.rmatmat(A, u),
                                  lambda: torch.matmul(A.T, u), nbytes, nflops, peaks, reps,
                                  main=main, in_turns=True))
            del v, u
        n, m = R.shape
        p_, q_ = rn(n, k), rn(m, k)
        nm = n * m
        shape, nflops = (n, m, k), 2 * nm * k
        rows.append(block_row(
            torch, "rankk_update", f"Z k={k}", shape,
            lambda: r1.rankk_update(R, p_, q_, a, b, out=out),
            lambda: r1.ref.rankk_update(R, p_, q_, scal2),
            lambda: torch.addmm(R, p_, q_.T, beta=0.7, alpha=-0.45),
            8 * nm + 4 * (n + m) * k, nflops + 3 * nm, peaks, reps, main=k == 8,
            in_turns=True))
        rows.append(block_row_in_place(
            torch, "rankk_update", f"Z k={k} in place", shape,
            lambda: r1.rankk_update(W, p_, q_, a, b, out=W),
            lambda: W.addmm_(p_, q_.T, beta=0.7, alpha=-0.45), W, R,
            r1.rankk_update(R, p_, q_, a, b), 8 * nm + 4 * (n + m) * k, nflops + 3 * nm,
            peaks, reps))
        rows.append(block_row(
            torch, "rankk_update_axpy", f"R, Y k={k}", shape,
            lambda: r1.rankk_update_axpy(R, Y, p_, q_, a, b, c, out=out),
            lambda: r1.ref.rankk_update_axpy(R, Y, p_, q_, scal3),
            lambda: torch.addmm(R, p_, q_.T, beta=0.7, alpha=-0.45).add_(Y, alpha=-0.3),
            12 * nm + 4 * (n + m) * k, nflops + 5 * nm, peaks, reps, main=k == 32,
            in_turns=True))
        rows.append(block_row_in_place(
            torch, "rankk_update_axpy", f"R, Y k={k} in place", shape,
            lambda: r1.rankk_update_axpy(W, Y, p_, q_, a, b, c, out=W),
            lambda: W.addmm_(p_, q_.T, beta=0.7, alpha=-0.45).add_(Y, alpha=-0.3), W, R,
            r1.rankk_update_axpy(R, Y, p_, q_, a, b, c), 12 * nm + 4 * (n + m) * k,
            nflops + 5 * nm, peaks, reps))
        del p_, q_
        torch.cuda.empty_cache()
    del out, W, R
    return rows


def block_row_in_place(torch, name, label, shape, kfn, lfn, W, src, want, nbytes, nflops, peaks,
                       reps, chain=False):
    """A rank-1 or rank-k update called in place, as the fits call it
    (``kfn`` writes into its operand ``W``): from a copy of ``src``, the
    out-of-place bits ``want``, twice; then the kernel and the library call
    in place (``lfn``) timed in turns on ``W``, whose values drift from call
    to call (a = 0.7 keeps them finite). ``chain``: ``lfn`` is a chain of
    calls, kept as ``library_chain_ms`` (``library_ms`` None)."""
    bw, flops = peaks[:2]
    for _ in range(2):
        W.copy_(src)
        check(kfn() is W and torch.equal(W, want),
              f"{name} {label}: not the out-of-place call's bits")
    del want
    W.copy_(src)
    ms1, lib1 = time_ms(torch, kfn, reps), time_ms(torch, lfn, reps)
    lib2, ms2 = time_ms(torch, lfn, reps), time_ms(torch, kfn, reps)
    row = dict(name=name, operand=label, shape=list(shape), ms=(ms1 + ms2) / 2,
               library_ms=(lib1 + lib2) / 2, ms_rounds=[ms1, ms2], library_ms_rounds=[lib1, lib2],
               bound_ms=1e3 * max(nbytes / bw, nflops / flops),
               bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
               bytes=nbytes, main=False)
    row["library_ratio"] = row["ms"] / row["library_ms"]
    print(f"kernel {name:18s} {label}: in turns {row['ms_rounds']} ms against the "
          f"{'chain' if chain else 'library'}'s {row['library_ms_rounds']} in place: "
          f"{row['library_ratio']:.4f} of its time, {row['bound_ms'] / row['ms']:.3f} of the "
          "bound; the out-of-place bits")
    if chain:
        row.update(library_chain_ms=row["library_ms"], library_ms=None,
                   library_chain_ms_rounds=row.pop("library_ms_rounds"),
                   library_chain_ratio=row.pop("library_ratio"))
    return row


def gather_rates(torch, dev):
    """The card's rate of random 32-byte sectors from tables the size of the
    block forms' (``tools/torch_gather_probe.py``, built and run here)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    try:
        import torch_gather_probe
    finally:
        sys.path.pop(0)
    rates = torch_gather_probe.measure(torch, dev)
    for (width, table), r in rates.items():
        print(f"random {4 * width}-byte rows from {table} ({r['bytes'] / 1e6:.2f} MB): "
              + ", ".join(f"{lpr} lanes a row {ms:.3f} ms, {rate / 1e9:.1f} G sectors/s"
                          for lpr, (ms, rate) in r["lanes"].items()))
    return rates, torch_gather_probe.floor_ms


def block_mc_kernels(torch, mc, dev, state, mu, gen, reps, peaks):
    """(a) coo_matmat (G V in the row order, G^T U in the column order) and
    the block update_resid at the Netflix shapes, k = 8 and 32; cuSPARSE's
    CSR SpMM as the library call (its CSR tensor is set-up, not timed);
    coo_matmat's bits held to ref.coo_matmat_chain's association; each
    kernel's gather floor beside its bound: its random factor rows (one
    32-byte sector an entry and side at k = 8, four at k = 32) at the rate
    measured here, plus its sequential bytes over the memory rate."""
    rows = []
    p = state.rows.numel()
    rates, floor_of = gather_rates(torch, dev)

    def floor(k, sectors, nbytes):
        per_row = 4 * k // 32
        return floor_of(rates, 8 if k <= 8 else 32, {t: n * per_row for t, n in sectors.items()},
                        nbytes, peaks[0])

    for k in BLOCK_KS:
        V = torch.randn(NF_M, k, generator=gen, device=dev)
        U = torch.randn(NF_D, k, generator=gen, device=dev) / math.sqrt(NF_D)
        for label, order, vals, x, table in (
                ("G V", state.by_row, state.resid_by_row, V, "V"),
                ("G^T U", state.by_col, state.resid_by_col, U, "U")):
            check(torch.equal(mc.coo_matmat(order, vals, x),
                              mc.ref.coo_matmat_chain(order, vals, x)),
                  f"coo_matmat {label} k={k}: not the bits of its association")
            csr = torch.sparse_csr_tensor(order.seg_ptr.to(torch.int32), order.gat_sorted,
                                          vals, size=(order.out_dim, order.in_dim))
            nbytes = 8 * p + 4 * k * (order.in_dim + order.out_dim)
            rows.append(block_row(
                torch, "coo_matmat", f"{label} k={k}", (order.out_dim, order.in_dim, p, k),
                lambda: mc.coo_matmat(order, vals, x),
                lambda: mc.ref.coo_matvec_sorted(order, vals, x),
                lambda: csr @ x, nbytes, 2 * p * k, peaks, reps, plain_reps=2, main=k == 8,
                floor_ms=floor(k, {table: p}, nbytes)))
            del csr
        gamma = torch.full((), 0.05, device=dev)
        args = (gamma, mu, U, V, state.rows, state.cols, state.resid, state.vals, state.weight,
                state.by_row, state.copies("row"), state.by_col, state.copies("col"))
        nbytes = 64 * p + 4 * k * (NF_D + NF_M)
        rows.append(block_row(
            torch, "update_resid_block", f"p={p}, k={k}, three orders", (NF_D, NF_M, p, k),
            lambda: mc.update_resid(*args), lambda: mc.ref.update_resid(*args), None,
            nbytes, 3 * p * (2 * k + 6), peaks, reps, plain_reps=1, exact=True, main=k == 8,
            floor_ms=floor(k, {"U": 2 * p, "V": 2 * p}, nbytes)))
        ones = torch.ones((), device=dev)
        args = (ones, mu, U, V, state.rows, state.cols, state.resid, state.vals, state.weight)
        nbytes = 24 * p + 4 * k * (NF_D + NF_M)
        rows.append(block_row(
            torch, "update_resid_caller", f"p={p}, k={k}, caller order, gamma = 1",
            (NF_D, NF_M, p, k), lambda: mc.update_resid_caller(*args),
            lambda: mc.ref.update_resid_caller(*args), None,
            nbytes, p * (2 * k + 6), peaks, reps, plain_reps=1, exact=True, main=k == 8,
            floor_ms=floor(k, {"U": p, "V": p}, nbytes)))
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
        # X and the factors 16-byte aligned, then 4 bytes off (the scalar paths)
        for off in (0, 1):
            xv, xu = rn(77 * k + off)[off:].view(77, k), rn(301 * k + off)[off:].view(301, k)
            where = f"k={k}" + (", 4 bytes off alignment" if off else "")
            for label, got, want in (
                    ("G V", mc.coo_matmat(by_row, vr, xv), mc.ref.coo_matvec(rows_, cols_, vals,
                                                                             xv, 301)),
                    ("G^T U", mc.coo_matmat(by_col, vc, xu), mc.ref.coo_matvec(
                        cols_, rows_, vals, xu, 77))):
                err = rel_err(torch, got, want)[1]
                check(err <= TOL["coo_matmat"], f"coo_matmat {label} {where}: rel err {err:.3e}")
            check(torch.equal(mc.coo_matmat(by_row, vr, xv),
                              mc.ref.coo_matmat_chain(by_row, vr, xv)),
                  f"coo_matmat G V {where}: not the bits of its association")
            if k > 1:
                weight = (torch.arange(5003, device=dev) % 3 != 0).float()
                resid = weight * rn(5003)
                args = (torch.full((), 0.2, device=dev), 1.5, xu, xv, rows_, cols_, resid, vals,
                        weight, by_row,
                        (resid[by_row.perm.long()], vr, weight[by_row.perm.long()]), by_col,
                        (resid[by_col.perm.long()], vc, weight[by_col.perm.long()]))
                check(all(torch.equal(a_, b_) for a_, b_ in zip(mc.update_resid(*args),
                                                                mc.ref.update_resid(*args))),
                      f"update_resid block {where}: not the plain chain's bits")
                check(torch.equal(mc.update_resid_caller(*args[:9]),
                                  mc.update_resid(*args)[0]),
                      f"update_resid_caller {where}: not update_resid's caller-order bits")
    torch.cuda.synchronize()
    print("block forms match their plain versions at k = 1, 3, 17, 33 and odd shapes, "
          "the MC forms also with X and the factors 4 bytes off alignment")


def block_fit(torch, kernels, dfw, kind, task, x, y, cfg, seed, dev):
    """fit_serial of a block solver: losses, executed iterations, launches
    as the path implies, ms an epoch by segment."""
    piters, seg_log = [], []
    timer = segment_timer(torch, seg_log)

    def cb(start, aux):
        timer(start, aux)
        piters.extend(int(p_) for p_ in aux.piters if p_ == p_)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting(kernels) as ran:  # its times carry the counters' cost
        t0 = time.perf_counter()
        res = dfw.fit_serial(task, x, y, cfg=cfg, key=seed, device=dev, callback=cb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, routes = ran.launches, ran.routes
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
                with counting(kernels) as ran:
                    res = dfw.fit_serial(task, x, y, cfg=cfg, key=seed, device=dev)
                for key_, val in ran.launches.items():
                    total[key_] += val
                route_block += ran.routes["update_resid"]["block"]
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
    mc_forms = ("coo_matmat", "update_resid", "update_resid_caller")
    netflix = dict.fromkeys(mc_forms, 0)
    for comm_name, epochs in (("dense", 10), ("int8", 5)):
        res, launches, report[f"mc_{comm_name}"] = block_fit(
            torch, kernels, dfw, "mc", mc_task, idx, yw, dfw.DFWConfig(
                mu=mu, num_epochs=epochs, schedule="const:4", step_size="linesearch",
                solver="block:8:adapt", comm=comm_name, block_epochs=5), args.seed, dev)
        add(launches)
        for f_ in mc_forms:  # update_resid: its block route
            netflix[f_] += (report[f"mc_{comm_name}"]["block_route"] if f_ == "update_resid"
                            else launches[f_])
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
    table1 = {f_: routed if f_ == "update_resid" else launches[f_] for f_ in mc_forms}
    report["mc_form_launches"] = dict(netflix=netflix, table1=table1)
    print("MC block forms' launches (update_resid: its block route): the Netflix-shape fits "
          + ", ".join(f"{f_} {n_}" for f_, n_ in netflix.items()) + "; the Table-1 cell "
          + ", ".join(f"{f_} {n_}" for f_, n_ in table1.items()))

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

# ---------------------------------------------------------------------------
# Phase 26: resume a run from its checkpoint
# ---------------------------------------------------------------------------


def interior_step(steps, epochs: int) -> int:
    """The saved step before the run's end nearest half of it."""
    inner = [s_ for s_ in steps if s_ < epochs]
    check(bool(inner), f"no checkpoint step before epoch {epochs} in {steps}")
    return min(inner, key=lambda s_: abs(s_ - epochs / 2))


def kept_run(torch, low_rank, res):
    """What the bit checks keep of a run on the host, so that its device
    state can be freed: history, final loss, the packed iterate, the state's
    updated field (MTLS r, logistic z, MC resid), probe, reducer state."""
    last = next(getattr(res.state, f) for f in ("resid", "r", "z") if hasattr(res.state, f))
    return dict(history=res.history, final_loss=res.final_loss, epochs_run=res.epochs_run,
                packed=low_rank.pack_live(res.iterate), last=last.cpu(),
                probe=res.probe.cpu() if isinstance(res.probe, torch.Tensor) else None,
                comm_state={k: v.cpu() for k, v in (res.comm_state or {}).items()})


def same_run(torch, np, low_rank, label, res, want):
    """A resumed run against its uninterrupted run's ``kept_run``: every
    part bit for bit."""
    got = kept_run(torch, low_rank, res)
    check(got["epochs_run"] == want["epochs_run"] and got["history"] == want["history"],
          f"{label}: history differs from the uninterrupted run's")
    check(got["final_loss"] == want["final_loss"],
          f"{label}: final loss {got['final_loss']!r} != {want['final_loss']!r}")
    check(all(np.array_equal(got["packed"][k], want["packed"][k]) for k in want["packed"]),
          f"{label}: iterate differs from the uninterrupted run's")
    check(torch.equal(got["last"], want["last"]), f"{label}: final state differs")
    check((got["probe"] is None) == (want["probe"] is None) and (
        got["probe"] is None or torch.equal(got["probe"], want["probe"])),
        f"{label}: probe differs")
    check(got["comm_state"].keys() == want["comm_state"].keys() and all(
        torch.equal(got["comm_state"][k], v) for k, v in want["comm_state"].items()),
        f"{label}: reducer state differs")


def resumed_fit(torch, np, kernels, low_rank, dfw, kind, task, x, y, cfg, seed, dev, want,
                label):
    """``fit_serial(resume_from=...)`` under fresh launch counts: the
    uninterrupted run's bits (``want``), and the launches of the epochs
    after the resume step plus one state build (and the start-up checks).
    Returns (result, launches, update_resid's block-route launches, wall s)."""
    piters = []

    def cb(start, aux):
        piters.extend(int(p_) for p_ in aux.piters if p_ == p_)

    with counting(kernels) as ran:
        t0 = time.perf_counter()
        res = dfw.fit_serial(task, x, y, cfg=cfg, key=seed, device=dev, callback=cb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, route = ran.launches, ran.routes["update_resid"]["block"]
    t = cfg.resume_step
    check(len(piters) == cfg.num_epochs - t, f"{label}: ran {len(piters)} epochs from {t}")
    if cfg.solver.startswith("block"):
        exp = expected_block_launches(kind, piters, cfg.verify_kernels, cfg.comm,
                                      cfg.step_size == "linesearch")
    else:
        exp = expected_launches(kind, res.history["k"][t:], cfg.verify_kernels, cfg.comm)
    check(launches == exp, f"{label}: launches {launches} != expected {exp}")
    same_run(torch, np, low_rank, label, res, want)
    print(f"{label}: resumed at epoch {t}, {cfg.num_epochs - t} epochs in {wall:.2f} s: the "
          f"uninterrupted run's bits (history, final loss, iterate, state, probe, reducer "
          f"state); launches {launches}")
    return res, launches, route, wall


def resume_worker_rank(group, device, task, x, y, kw, ckdir, seed):
    """One worker of phase 26 (e) (module level: run_workers starts it by
    name): ``fit`` with checkpoints, then resumed at its interior step on
    the same four workers and, on workers 0 and 1, on two."""
    import dataclasses as dc

    import torch

    from repro_torch import kernels
    from repro_torch.checkpoint.store import list_steps
    from repro_torch.core import low_rank
    from repro_torch.launch import dfw

    def run(cfg, grp):
        kernels.reset_launches()
        res = dfw.fit(task, x, y, cfg=cfg, key=seed, group=grp, device=device)
        out = dict(history=res.history, final_loss=res.final_loss, epochs_run=res.epochs_run,
                   packed=low_rank.pack_live(res.iterate), launches=kernels.launches(),
                   last=res.state.resid.cpu())
        del res
        torch.cuda.empty_cache()
        return out

    cfg = dfw.DFWConfig(checkpoint_dir=ckdir, **kw)
    out = {"full": run(cfg, group)}
    out["step"] = interior_step(list_steps(ckdir), kw["num_epochs"])
    rcfg = dc.replace(cfg, checkpoint_dir=None, resume_from=ckdir, resume_step=out["step"])
    out["four"] = run(rcfg, group)
    two = group.split([[0, 1], [2, 3]])
    if group.rank < 2:
        out["two"] = run(rcfg, two)
    return out


def resume_phase(torch, np, kernels, dfw, tasks, low_rank, checkpoint, convert, dev, args):
    """Phase 26: resume runs from their checkpoints on the card. Returns
    (report, summed launches of the resumed and checkpointed runs,
    update_resid's block-route launches among them)."""
    import shutil
    import tempfile

    report = {}
    total = dict.fromkeys(kernels.launches(), 0)
    route_total = 0

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    print(f"checkpoints under {build}: {free_gb:.1f} GB free on its disk")
    check(free_gb > 12, f"phase 26 needs about 12 GB of disk for MC checkpoints, {free_gb:.1f} free")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)  # phase 21's draws: phase 3's X and Y, its ratings
    X, Y = dense_data(torch, gen, dev, args.rows)
    labels = planted_labels(torch, gen, dev, X)
    idx, yw, (te_rows, te_cols, te_vals), mu = make_mc_data(torch, gen, dev, args.mc_entries,
                                                           NF_TEST, d=NF_D, m=NF_M)

    # (f) the dense MTLS operator against the factored one, on phase 3's X, Y
    dtask = tasks.MultiTaskLeastSquaresDense(PAPER_D, PAPER_M)
    ftask = dfw.kernelize(tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = dtask.init_state(X, Y)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sf = ftask.init_state(X, Y)
    v = torch.randn(PAPER_M, generator=gen, device=dev)
    u = torch.randn(PAPER_D, generator=gen, device=dev)
    v, u = v / torch.linalg.vector_norm(v), u / torch.linalg.vector_norm(u)
    errs = {}
    for stage in ("fresh", "updated"):
        for op, got, want in (("matvec", dtask.matvec(sd, v), ftask.matvec(sf, v)),
                              ("rmatvec", dtask.rmatvec(sd, u), ftask.rmatvec(sf, u)),
                              ("local_grad", dtask.local_grad(sd), ftask.local_grad(sf))):
            errs[f"{op} {stage}"] = err = rel_err(torch, got, want)[1]
            check(err <= 1e-3, f"(f) dense MTLS {op} ({stage}): {err:.2e} of max from the "
                  "factored operator (limit 1e-3)")
        if stage == "fresh":
            sd, sf = dtask.update(sd, u, v, 0.5, 1.0), ftask.update(sf, u, v, 0.5, 1.0)
    report["dense_mtls"] = dict(init_s=init_s, errors=errs)
    print(f"(f) dense MTLS operator at d = {PAPER_D}, m = {PAPER_M} (state X^T X, X^T Y, grad: "
          f"{4 * (PAPER_D ** 2 + 2 * PAPER_D * PAPER_M) / 1e6:.1f} MB; built from n = "
          f"{X.shape[0]} rows in {init_s:.3f} s) against the factored operator, fresh and after "
          "an update, max error over max: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    del sd, sf
    torch.cuda.empty_cache()

    ck = tempfile.TemporaryDirectory(dir=build, prefix="resume_ckpt_")
    try:
        # (c), (d) MTLS topk:16 and logistic int8 at d = 2048, m = 1000, n cut
        # to --serve-rows (the full MTLS state is 20.7 GB a step)
        ns = args.serve_rows
        for label, kind, task, target, kw in (
            ("(c) mtls topk:16", "mtls", tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M), Y,
             dict(mu=1.0, schedule="const:2", step_size="linesearch", comm="topk:16")),
            ("(d) logistic int8", "logistic", tasks.MultinomialLogistic(PAPER_D, PAPER_M),
             labels, dict(mu=10.0, schedule="const:2", comm="int8")),
        ):
            d_ = f"{ck.name}/{kind}"
            cfg = dfw.DFWConfig(num_epochs=8, block_epochs=4, checkpoint_dir=d_,
                                checkpoint_keep=None, **kw)
            res, launches, _ = run_path(torch, kernels, dfw, kind, task, X[:ns], target[:ns],
                                        cfg, args.seed, dev)
            add(launches)
            want = kept_run(torch, low_rank, res)
            del res
            rcfg = dataclasses.replace(cfg, checkpoint_dir=None, resume_from=d_, resume_step=4)
            res, launches, _, wall = resumed_fit(torch, np, kernels, low_rank, dfw, kind, task,
                                                 X[:ns], target[:ns], rcfg, args.seed, dev,
                                                 want, label)
            add(launches)
            report[label] = dict(step_bytes=step_bytes(d_, 4), resumed_wall_s=wall)
            del res, want
            torch.cuda.empty_cache()
        del X, Y, labels
        torch.cuda.empty_cache()

        # (a) MC dense at the Netflix shapes, phase 8's configuration
        mc_task = tasks.MatrixCompletion(NF_D, NF_M)
        d_ = f"{ck.name}/mc"
        cfg = dfw.DFWConfig(mu=mu, num_epochs=10, schedule="log", step_size="linesearch",
                            block_epochs=5, checkpoint_dir=d_)
        res, launches, rep = run_path(torch, kernels, dfw, "mc", mc_task, idx, yw, cfg,
                                      args.seed, dev)
        add(launches)
        want = kept_run(torch, low_rank, res)
        del res
        torch.cuda.empty_cache()
        steps = checkpoint.store.list_steps(d_)
        step = interior_step(steps, cfg.num_epochs)
        nbytes = {s_: step_bytes(d_, s_) for s_ in steps}
        # the restore by part: disk read, host to device, the state build
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = checkpoint.restore_run(d_, task=mc_task, step=step)
        t1 = time.perf_counter()
        fields = convert.state_tensors(snap.state, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = convert.task_state(fields, device=dev, d=NF_D, m=NF_M)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts = dict(read_s=t1 - t0, to_device_s=t2 - t1, build_s=t3 - t2)
        del snap, fields, state
        torch.cuda.empty_cache()
        rcfg = dataclasses.replace(cfg, checkpoint_dir=None, resume_from=d_, resume_step=step)
        res, launches, _, wall = resumed_fit(torch, np, kernels, low_rank, dfw, "mc", mc_task,
                                             idx, yw, rcfg, args.seed, dev, want, "(a) mc dense")
        add(launches)
        report["(a) mc dense"] = dict(steps=steps, step=step, step_bytes=nbytes,
                                      fit_wall_s=rep["wall_s"], resumed_wall_s=wall, **parts)
        print(f"(a) mc dense: checkpoint steps kept {steps}, bytes a step "
              + ", ".join(f"{s_}: {b_} ({b_ / 1e9:.3f} GB)" for s_, b_ in nbytes.items())
              + f"; restore of step {step}: disk read {parts['read_s']:.3f} s, host to device "
              f"{parts['to_device_s']:.3f} s, state build {parts['build_s']:.3f} s; the fit with "
              f"checkpoints {rep['wall_s']:.2f} s")
        del res, want
        shutil.rmtree(d_)
        torch.cuda.empty_cache()

        # (b) MC block:8:adapt, phase 25's configuration, resumed at 5: the probe
        d_ = f"{ck.name}/mc_block"
        cfg = dfw.DFWConfig(mu=mu, num_epochs=10, schedule="const:4", step_size="linesearch",
                            solver="block:8:adapt", block_epochs=5, checkpoint_dir=d_)
        res, launches, rep = block_fit(torch, kernels, dfw, "mc", mc_task, idx, yw, cfg,
                                       args.seed, dev)
        add(launches)
        route_total += rep["block_route"]
        want = kept_run(torch, low_rank, res)
        del res
        torch.cuda.empty_cache()
        rcfg = dataclasses.replace(cfg, checkpoint_dir=None, resume_from=d_, resume_step=5)
        res, launches, route, wall = resumed_fit(torch, np, kernels, low_rank, dfw, "mc",
                                                 mc_task, idx, yw, rcfg, args.seed, dev, want,
                                                 "(b) mc block:8:adapt")
        add(launches)
        route_total += route
        report["(b) mc block:8:adapt"] = dict(step_bytes=step_bytes(d_, 5), resumed_wall_s=wall)
        del res, want
        shutil.rmtree(d_)
        torch.cuda.empty_cache()

        # (e) four gloo workers on the card, phase 22's MC setup: resumed on
        # four (bits) and on two (phase 22's tolerances)
        nw = MULTI_WORKERS
        idx4, yw4 = dfw.shard_observations(idx[:, 0], idx[:, 1], yw[:, 0], nw, NF_D, m=NF_M)
        idx4, yw4 = idx4.to(dev), yw4.to(dev)
        del idx, yw
        torch.cuda.empty_cache()
        kw = dict(mu=mu, num_epochs=args.mc_int8_epochs, schedule="log",
                  step_size="linesearch", block_epochs=5)
        t0 = time.perf_counter()
        ranks = dfw.run_workers(nw, resume_worker_rank, mc_task, idx4, yw4, kw,
                                f"{ck.name}/mc4", args.seed, backend="gloo", device=dev)
        wall = time.perf_counter() - t0
        step = ranks[0]["step"]
        full = ranks[0]["full"]
        for j, r_ in enumerate(ranks):
            for part, ks in (("full", r_["full"]["history"]["k"]),
                             ("four", r_["full"]["history"]["k"][step:])):
                exp = expected_launches("mc", ks, True)
                check(r_[part]["launches"] == exp,
                      f"(e) worker {j} {part}: launches {r_[part]['launches']} != {exp}")
                add(r_[part]["launches"])
            got, mine = r_["four"], r_["full"]
            check(got["history"] == mine["history"] and got["final_loss"] == mine["final_loss"]
                  and all(np.array_equal(got["packed"][k], mine["packed"][k])
                          for k in mine["packed"]) and torch.equal(got["last"], mine["last"]),
                  f"(e) worker {j}: resumed on four is not its uninterrupted run's bits")
            check(got["history"] == full["history"], f"(e) worker {j}'s history is not worker 0's")
        for j in (0, 1):
            exp = expected_launches("mc", full["history"]["k"][step:], True)
            check(ranks[j]["two"]["launches"] == exp, f"(e) two workers: worker {j} launches")
            add(ranks[j]["two"]["launches"])
        two = ranks[0]["two"]
        check(two["history"] == ranks[1]["two"]["history"], "(e) the two workers part")
        it_two = low_rank.unpack_live(two["packed"], int(two["packed"]["count"]), device=dev)
        it_full = low_rank.unpack_live(full["packed"], int(full["packed"]["count"]), device=dev)
        deviation = fits_agree(np, two["history"], full["history"], "(e) resumed on two",
                               low_rank.gather_entries(it_two, te_rows, te_cols).cpu().numpy(),
                               low_rank.gather_entries(it_full, te_rows, te_cols).cpu().numpy())
        report["(e) four gloo workers"] = dict(
            step=step, wall_s=wall, deviation_on_two={
                k_: max(v_) if isinstance(v_, list) else v_ for k_, v_ in deviation.items()})
        print(f"(e) mc dense on {nw} gloo workers (the card shared; a check, not a timing), "
              f"{kw['num_epochs']} epochs, checkpoints at every boundary: resumed at epoch "
              f"{step} on four, every worker its uninterrupted run's bits; on two, largest "
              f"deviation from the four-worker run {report['(e) four gloo workers']['deviation_on_two']}"
              f"; {wall:.1f} s")
        del idx4, yw4, it_two, it_full
    finally:
        ck.cleanup()
    torch.cuda.empty_cache()
    return report, total, route_total


# ---------------------------------------------------------------------------
# Phase 27: the engine on the card (one CUDA graph a (K, length) segment)
# ---------------------------------------------------------------------------


def engine_fit(torch, kernels, frank_wolfe, ktask, state, mu, kw, mode, seed, dev,
               callback=None, count=False):
    """frank_wolfe.fit of a built state in ``mode``: (result, launches the
    device ran and their routes (``count``: under ``counting``; else
    None), the wrappers' calls, wall s, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting(kernels) if count else contextlib.nullcontext() as ran:
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = frank_wolfe.fit(ktask, state, mu=mu, key=seed, device=dev, callback=callback,
                              mode=mode, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (res, ran.launches if count else None, ran.routes if count else None,
            kernels.launches(), wall, torch.cuda.max_memory_allocated() / 1e9)


def same_fit(torch, a, b) -> bool:
    """History, final loss, iterate (and probe) the same bits."""
    return (a.history == b.history and a.final_loss == b.final_loss
            and all(torch.equal(p_, q_) for p_, q_ in zip(a.iterate, b.iterate))
            and (not isinstance(a.probe, torch.Tensor) or torch.equal(a.probe, b.probe)))


def steady_epoch_ms(seg_log) -> float:
    """ms an epoch over the segments after the first (segment_timer's log)."""
    rest = seg_log[1:] or seg_log
    return sum(s_["ms_per_epoch"] * s_["epochs"] for s_ in rest) / sum(s_["epochs"] for s_ in rest)


def engine_pair(torch, kernels, frank_wolfe, engine, label, ktask, fresh, mu, kw, timing, seed,
                dev, report):
    """(a) One configuration in scan, then legacy, from fresh states, both
    under ``counting``: the same bits and history, and (e) the launches the
    device ran in scan (graph replays) equal legacy's, which equal legacy's
    wrapper calls (uncaptured: a call is a launch); the stats within the
    dispatch contract (b). Then both timed, unprofiled, on ``timing`` (a
    const schedule of repeated segments) by segment_timer: ms an epoch over
    the segments after the first. Returns the scan run."""
    row = report[label] = {}
    for mode in ("scan", "legacy"):
        seg_log = []
        res = engine_fit(torch, kernels, frank_wolfe, ktask, fresh(), mu, timing, mode, seed, dev,
                         callback=segment_timer(torch, seg_log))[0]
        row[f"{mode}_ms_per_epoch"] = steady_epoch_ms(seg_log)
        del res
    runs = {mode: engine_fit(torch, kernels, frank_wolfe, ktask, fresh(), mu, kw, mode, seed, dev,
                             count=True) for mode in ("scan", "legacy")}
    (sc, sl, sr, scalls, _, sp), (lg, ll, lr, lcalls, _, lp) = runs["scan"], runs["legacy"]
    check(same_fit(torch, sc, lg), f"(a) {label}: scan's bits are not legacy's")
    check(ll == lcalls, f"(e) {label}: legacy's device count {ll} is not its calls {lcalls}")
    check(sl == ll and sr == lr, f"(e) {label}: the device ran {sl} in scan, {ll} in legacy")
    st, tm = sc.stats, sc.timings
    try:
        engine.dispatch_contract(segments=st["segments_planned"],
                                 max_compilations=None).check_stats(st)
    except AssertionError as e:
        check(False, f"(b) {label}: {e}")
    row.update(
        epochs=sc.epochs_run, captured=st["graph_replays"] >= st["segments_run"],
        stats={k: st[k] for k in ("segments_run", "dispatches", "host_syncs", "compilations",
                                  "graph_replays")},
        legacy_stats={k: lg.stats[k] for k in ("dispatches", "host_syncs")},
        capture_ms=tm["capture_ms"], instantiate_ms=tm["instantiate_ms"],
        pool_bytes=tm["pool_bytes"], table_bytes=tm["table_bytes"],
        draw_us=statistics.mean(tm["draw_us"]), draw_us_per_epoch=sum(tm["draw_us"])
        / sc.epochs_run, peak_gb=dict(scan=sp, legacy=lp), launches=sl, calls=scalls,
        block_route=sr["update_resid"]["block"])
    print(f"(a) {label}: scan = legacy bit for bit; (e) the device ran legacy's launches in "
          f"scan; stats {row['stats']}, legacy {row['legacy_stats']}; "
          f"{'captured' if row['captured'] else 'UNCAPTURED'}; capture ms "
          + ", ".join(f"{c:.1f} (instantiate {i:.1f})" for c, i in zip(
              tm["capture_ms"], tm["instantiate_ms"])) + "; pool MB "
          + ", ".join(f"{b_ / 2**20:.1f}" for b_ in tm["pool_bytes"]) + "; tables MB "
          + ", ".join(f"{b_ / 2**20:.1f}" for b_ in tm["table_bytes"])
          + f"; draws {row['draw_us']:.0f} us a piece ({row['draw_us_per_epoch']:.0f} an epoch)"
          f"; peak GB scan {sp:.2f}, legacy {lp:.2f}")
    print(f"(t) {label}: ms an epoch, steady segments ({timing['schedule']}, blocks of "
          f"{timing.get('block_epochs')}): scan {row['scan_ms_per_epoch']:.3f}, legacy "
          f"{row['legacy_ms_per_epoch']:.3f} (legacy / scan "
          f"{row['legacy_ms_per_epoch'] / row['scan_ms_per_epoch']:.3f})")
    del lg, runs
    torch.cuda.empty_cache()
    return sc


def long_segment(torch, kernels, frank_wolfe, engine, label, ktask, fresh, mu, kw, seed, dev,
                 report):
    """(f) One const segment of many epochs: pieces of MAX_PROGRAM_EPOCHS
    replayed back to back, so its graphs, their capture and their tables
    are a piece's whatever the segment's length."""
    res, _, _, _, wall, _ = engine_fit(torch, kernels, frank_wolfe, ktask, fresh(), mu, kw,
                                       "scan", seed, dev)
    st, tm, e = res.stats, res.timings, kw["num_epochs"]
    pieces = -(-e // engine.MAX_PROGRAM_EPOCHS)
    check(res.epochs_run == e and math.isfinite(res.final_loss)
          and st["segments_run"] == 1 and st["graph_replays"] == pieces
          and st["compilations"] == len(tm["capture_ms"]) <= 2,
          f"(f) {label}: {e} epochs in one segment: stats {st}")
    report[label] = dict(epochs=e, stats={k: st[k] for k in (
        "segments_run", "dispatches", "host_syncs", "compilations", "graph_replays")},
        capture_ms=tm["capture_ms"], instantiate_ms=tm["instantiate_ms"],
        pool_bytes=tm["pool_bytes"], table_bytes=tm["table_bytes"], wall_s=wall)
    whole_mb = tm["table_bytes"][0] * e / 2**20 / min(e, engine.MAX_PROGRAM_EPOCHS)
    print(f"(f) {label}: one segment of {e} epochs in {pieces} replays of pieces of at most "
          f"{engine.MAX_PROGRAM_EPOCHS}; graphs {st['compilations']}: capture ms "
          + ", ".join(f"{c:.1f} (instantiate {i:.1f})" for c, i in zip(
              tm["capture_ms"], tm["instantiate_ms"])) + "; pool MB "
          + ", ".join(f"{b_ / 2**20:.1f}" for b_ in tm["pool_bytes"]) + "; tables MB "
          + ", ".join(f"{b_ / 2**20:.1f}" for b_ in tm["table_bytes"])
          + f" (one table for the whole segment: {whole_mb:.1f})")
    del res
    torch.cuda.empty_cache()


def engine_phase(torch, np, kernels, dfw, comm, tasks, frank_wolfe, engine, dev, args):
    """Phase 27 (see the module doc). Returns (report, summed launches the
    device ran in its scan runs, their update_resid block-route launches)."""
    from repro_torch.core.cuda_graph import runtime_version

    report = {"cuda_runtime": runtime_version()}
    if_nodes = report["cuda_runtime"] >= 12040  # else gap_tol and :adapt run uncaptured
    print(f"phase 27: CUDA runtime {report['cuda_runtime']} (IF nodes: {if_nodes})")
    t_phase = time.perf_counter()
    seed = args.seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 27)
    total = dict.fromkeys(kernels.launches(), 0)
    routed = [0]

    def pair(label, ktask, fresh, mu, kw, timing=None):
        res = engine_pair(torch, kernels, frank_wolfe, engine, label, ktask, fresh, mu, kw,
                          timing or kw, seed, dev, report)
        for k_, v_ in report[label]["launches"].items():
            total[k_] += v_
        routed[0] += report[label]["block_route"]
        return res

    # the ImageNet shapes: MTLS and logistic (phases 3, 4), MTLS block:32:adapt (25)
    X, Y = dense_data(torch, gen, dev, args.rows)
    mtls = dfw.kernelize(tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M))
    base = mtls.init_state(X, Y)
    ls = dict(step_size="linesearch")
    pair("mtls", mtls, lambda: base._replace(r=-Y), 1.0,
         dict(ls, num_epochs=args.epochs, schedule="log"),
         dict(ls, num_epochs=12, schedule="const:2", block_epochs=4))
    pair("mtls block:32:adapt", mtls, lambda: base._replace(r=-Y), 1.0,
         dict(ls, num_epochs=10, schedule="const:8", solver="block:32:adapt", block_epochs=5))

    # (c) the IF nodes: gap_tol firing inside a segment. MTLS's gap falls
    # from its first epoch on: gap_tol is the gap an unstopped const:2 run
    # reaches at 60% of its --epochs, so the certificate fires after epoch
    # 0 and before the end of the one segment (pieces of 16 and the rest):
    # the epochs before it run their IF-gated bodies, the rest skip them.
    one = dict(ls, num_epochs=args.epochs, schedule="const:2")
    free = engine_fit(torch, kernels, frank_wolfe, mtls, base._replace(r=-Y), 1.0, one, "scan",
                      seed, dev)[0]
    gaps = free.history["gap"]
    tol = gaps[int(0.6 * len(gaps))]
    stop = next(e_ for e_, g_ in enumerate(gaps) if g_ <= tol)
    del free
    stops = {mode: engine_fit(torch, kernels, frank_wolfe, mtls, base._replace(r=-Y), 1.0,
                              dict(one, gap_tol=tol), mode, seed, dev, count=True)
             for mode in ("scan", "legacy")}
    (gs, gl_, gr_, *_), (lgs, ll_, lr_, *_) = stops["scan"], stops["legacy"]
    check(1 <= stop and gs.epochs_run == lgs.epochs_run == stop + 1 < args.epochs
          and same_fit(torch, gs, lgs),
          f"(c) gap_tol: scan stopped at {gs.epochs_run}, legacy at {lgs.epochs_run} (want "
          f"{stop + 1}, past the first epoch and before the last), or their bits part")
    check(gl_ == ll_ and gr_ == lr_, f"(c) gap_tol: the device ran {gl_} in scan, {ll_} in "
          "legacy")
    for k_, v_ in gl_.items():
        total[k_] += v_
    pieces = -(-args.epochs // engine.MAX_PROGRAM_EPOCHS)
    check(gs.stats["host_syncs"] == gs.stats["segments_run"] + 2 == 3
          and gs.stats["graph_replays"] == pieces * if_nodes,
          f"(c) gap_tol: stats {gs.stats}: want one segment, one sync at its boundary, every "
          "piece a replay")
    report["gap_tol"] = dict(tol=tol, stop=stop, epochs_run=gs.epochs_run, stats=gs.stats,
                             legacy_host_syncs=lgs.stats["host_syncs"])
    print(f"(c) mtls const:2 gap_tol {tol:.6g}: scan and legacy run {gs.epochs_run} of "
          f"{args.epochs} epochs, the certificate firing at epoch {stop} of the one segment "
          f"({pieces} pieces), with the same bits and the same launches on the device; scan "
          f"host syncs {gs.stats['host_syncs']}, legacy {lgs.stats['host_syncs']}")
    del stops, gs, lgs

    # (f) long const segments: MTLS (line search) and MC int8 below
    long_segment(torch, kernels, frank_wolfe, engine, "long mtls const:2", mtls,
                 lambda: base._replace(r=-Y), 1.0, dict(ls, num_epochs=48, schedule="const:2"),
                 seed, dev, report)
    del base, Y
    torch.cuda.empty_cache()
    labels = planted_labels(torch, gen, dev, X)
    logi = dfw.kernelize(tasks.MultinomialLogistic(PAPER_D, PAPER_M))
    base = logi.init_state(X, labels)
    pair("logistic", logi, lambda: base._replace(z=torch.zeros_like(base.z)), 10.0,
         dict(num_epochs=args.logistic_epochs, schedule="log_half"),
         dict(num_epochs=12, schedule="const:1", block_epochs=4))
    del base, labels, X
    torch.cuda.empty_cache()

    # the Netflix shapes: MC dense and int8 (phases 8, 9), block:8:adapt (25)
    idx, yw, _, mu = make_mc_data(torch, gen, dev, args.mc_entries, NF_TEST)
    mc = dfw.kernelize(tasks.MatrixCompletion(NF_D, NF_M))
    base = mc.init_state(idx, yw)
    del idx, yw
    torch.cuda.empty_cache()

    def mc_fresh():
        return base._replace(resid=base.resid.clone(), resid_by_row=base.resid_by_row.clone(),
                             resid_by_col=base.resid_by_col.clone())

    dense = dict(ls, num_epochs=args.mc_epochs, schedule="log")
    steady = dict(ls, num_epochs=16, schedule="const:3", block_epochs=4)
    sc = pair("mc dense", mc, mc_fresh, mu, dense, steady)
    int8 = dict(reducer=comm.Int8Reducer())
    pair("mc int8", mc, mc_fresh, mu, dict(dense, num_epochs=args.mc_int8_epochs, **int8),
         dict(steady, num_epochs=12, **int8))
    adapt = dict(ls, num_epochs=10, schedule="const:4", solver="block:8:adapt", block_epochs=5)
    pair("mc block:8:adapt", mc, mc_fresh, mu, adapt)
    long_segment(torch, kernels, frank_wolfe, engine, "long mc int8 const:4", mc, mc_fresh, mu,
                 dict(ls, num_epochs=100, schedule="const:4", **int8), seed, dev, report)

    # (b) a const:2 run under the contract's guard: no device read but the
    # engine's counted fetches
    contract = engine.dispatch_contract(name="engine.dispatch[mc const:2]")
    state = mc_fresh()
    torch.cuda.synchronize()
    with contract.guard():
        guarded = frank_wolfe.fit(mc, state, mu=mu, num_epochs=10, schedule="const:2",
                                  step_size="linesearch", key=seed, device=dev)
    try:
        contract.check_stats(guarded.stats)
    except AssertionError as e:
        check(False, f"(b) {e}")
    report["guarded"] = dict(stats=guarded.stats)
    print(f"(b) mc const:2 under Contract.guard(): no implicit device read; stats "
          f"{guarded.stats}")
    del state, guarded

    # (c) :adapt's executed iterations through its IF nodes
    piters = {}
    for mode in ("scan", "legacy"):
        col = []
        res = engine_fit(torch, kernels, frank_wolfe, mc, mc_fresh(), mu, adapt, mode, seed,
                         dev, callback=lambda s_, aux: col.extend(aux.piters.tolist()))[0]
        piters[mode] = col
        check(res.stats["graph_replays"] == res.stats["segments_run"] * (
              mode == "scan" and if_nodes), f"(c) :adapt {mode}: graph replays {res.stats}")
        del res
    check(piters["scan"] == piters["legacy"] and min(piters["scan"]) < 4,
          f"(c) :adapt's executed iterations: scan {piters['scan']}, legacy "
          f"{piters['legacy']}")
    report["adapt_piters"] = piters["scan"]
    print(f"(c) mc block:8:adapt: executed iterations {[int(p_) for p_ in piters['scan']]} "
          "in both modes")
    del base, sc
    torch.cuda.empty_cache()

    # the Table-1 cell's problem (phase 25 (e)): rank1 and block:32 at a
    # fixed epoch count, MTLS and MC
    g1 = torch.Generator(device=dev)
    for kind in ("mtls", "mc"):
        g1.manual_seed(_table1_seed(seed, 0))
        x, y = table1_data(torch, g1, dev, kind)
        task = dfw.kernelize((tasks.MultiTaskLeastSquares if kind == "mtls"
                              else tasks.MatrixCompletion)(TABLE1["d"], TABLE1["m"]))
        t_base = task.init_state(x, y)
        if kind == "mtls":
            def fresh():
                return t_base._replace(r=-y)
        else:
            def fresh():
                return t_base._replace(resid=t_base.resid.clone(),
                                       resid_by_row=t_base.resid_by_row.clone(),
                                       resid_by_col=t_base.resid_by_col.clone())
        pair(f"table-1 {kind} rank1", task, fresh, 1.0,
             dict(ls, num_epochs=40, schedule="const:2"),
             dict(ls, num_epochs=40, schedule="const:2", block_epochs=5))
        pair(f"table-1 {kind} block:32:adapt", task, fresh, 1.0,
             dict(ls, num_epochs=20, schedule="const:8", solver="block:32:adapt",
                  block_epochs=5))
        del x, y, t_base
    uncaptured = [k_ for k_, r_ in report.items() if isinstance(r_, dict)
                  and r_.get("captured") is False]
    if uncaptured:
        print("runs not captured (no IF nodes on this CUDA): " + ", ".join(uncaptured))
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 27 took {report['wall_s']:.1f} s")
    return report, total, routed[0]


def telemetry_phase(torch, np, kernels, dfw, comm, tasks, frank_wolfe, engine, serve, low_rank,
                    dev, args):
    """Phase 28 (see the module doc). Returns (report, summed launches the
    device ran in its fits and serving, their update_resid block-route
    launches)."""
    import gc
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.analysis.recorder import OpRecorder
    from repro_torch.obs import Telemetry

    report = {}
    t_phase = time.perf_counter()
    seed = args.seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)  # phase 3's X and Y, phase 8's ratings
    total = dict.fromkeys(kernels.launches(), 0)
    routed = [0]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build, prefix="telemetry_"))

    def add(ran):
        for k_, v_ in ran.launches.items():
            total[k_] += v_
        routed[0] += ran.routes["update_resid"]["block"]

    def sinks(label, tel, want):
        """Write both sinks, parse them back, check ``want`` among the names."""
        jl, ct = tmp / f"{label}.jsonl", tmp / f"{label}.trace.json"
        tel.write_jsonl(jl)
        tel.write_chrome_trace(ct)
        lines = [json.loads(s_) for s_ in jl.read_text().splitlines()]
        doc = json.loads(ct.read_text())
        n = tel.event_count()
        names = {ev["name"] for ev in doc["traceEvents"]}
        check(lines[0]["type"] == "meta" and lines[-1]["type"] == "metrics"
              and len(lines) - 2 == n == len(doc["traceEvents"]) and want <= names,
              f"(a) {label}: sinks {len(lines)} lines, {len(doc['traceEvents'])} trace events "
              f"for {n} events; missing {sorted(want - names)}")
        return dict(events=n, jsonl_bytes=jl.stat().st_size, trace_bytes=ct.stat().st_size,
                    names=sorted(names))

    def on_off(label, run, want):
        """(a) ``run(tel, turn)`` with telemetry off and on in turns (off,
        on, on, off; the same draws): the same bits, stats and launches on
        the device; each run's wall and its programs' capture ms, which
        with the handle on hold the op recorder's pass over each capture."""
        got = []
        for turn, on in enumerate((False, True, True, False)):
            tel = Telemetry() if on else None
            torch.cuda.synchronize()
            with counting(kernels) as ran:
                t0 = time.perf_counter()
                res = run(tel, turn)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            add(ran)
            got.append(dict(history=res.history, final_loss=res.final_loss, stats=res.stats,
                            iterate=[t_.clone() for t_ in res.iterate], launches=ran.launches,
                            wall_s=wall, capture_ms=sum(res.timings.get("capture_ms", [])),
                            tel=tel))
            del res
            torch.cuda.empty_cache()
        off = got[0]
        for turn, g_ in enumerate(got[1:], 1):
            check(g_["history"] == off["history"] and g_["final_loss"] == off["final_loss"]
                  and all(torch.equal(p_, q_) for p_, q_ in zip(g_["iterate"], off["iterate"])),
                  f"(a) {label}: turn {turn} changed the run's bits")
            check(g_["stats"] == off["stats"], f"(a) {label}: stats {g_['stats']} in turn "
                  f"{turn}, {off['stats']} in turn 0")
            check(g_["launches"] == off["launches"], f"(a) {label}: the device ran "
                  f"{g_['launches']} in turn {turn}, {off['launches']} in turn 0")
        tel = got[1]["tel"]
        row = report[label] = dict(stats=off["stats"], walls_s=[g_["wall_s"] for g_ in got],
                                   capture_ms=[g_["capture_ms"] for g_ in got],
                                   sinks=sinks(label.replace(" ", "_"), tel, want),
                                   counters=tel.registry.snapshot()["counters"])
        print(f"(a) {label}: telemetry on = off bit for bit (history, final loss, iterate), "
              f"stats and launches the same; {row['sinks']['events']} events, sinks "
              f"{row['sinks']['jsonl_bytes']} / {row['sinks']['trace_bytes']} bytes; "
              f"counters {row['counters']}; whole fit in turns off, on, on, off: walls "
              + ", ".join(f"{w_:.4f}" for w_ in row["walls_s"]) + " s, capture ms "
              + ", ".join(f"{c_:.1f}" for c_ in row["capture_ms"]))
        return tel

    def timed(label, ktask, fresh, mu, kw):
        """ms an epoch with telemetry off and on, in turns (off, on, on,
        off), over the segments after the first (segment_timer); not a gate."""
        ms = {False: [], True: []}
        for on in (False, True, True, False):
            seg_log = []
            res = engine_fit(torch, kernels, frank_wolfe, ktask, fresh(), mu,
                             dict(kw, telemetry=Telemetry() if on else None), "scan", seed, dev,
                             callback=segment_timer(torch, seg_log))[0]
            ms[on].append(steady_epoch_ms(seg_log))
            del res
        off, on = statistics.mean(ms[False]), statistics.mean(ms[True])
        # what the handle adds on the host at a boundary: one segment's
        # records (its spans, 4 epochs of samples, gauges and counters),
        # timed alone over 500 segments
        seg = engine.Segment(start=0, length=kw["block_epochs"], k=2)
        rows = np.random.default_rng(0).random((seg.length, 5)).astype(np.float32)
        per_k = engine._comm_cost_per_k(comm.DenseReducer(), ktask.d, ktask.m, 1)
        tel = Telemetry()
        t0 = time.perf_counter()
        for _ in range(500):
            engine._record_segment(tel, seg, 0.0, 1.0, rows, per_k, "dense", 1, None)
        record_us = 1e6 * (time.perf_counter() - t0) / 500
        report[label] = dict(ms_per_epoch_off=ms[False], ms_per_epoch_on=ms[True],
                             overhead=on / off - 1, segment_records_us=record_us)
        print(f"(a) {label} ({kw['schedule']}, blocks of {kw['block_epochs']}): ms an epoch in "
              f"turns off {ms[False][0]:.3f}, on {ms[True][0]:.3f}, on {ms[True][1]:.3f}, off "
              f"{ms[False][1]:.3f}: telemetry {100 * (on / off - 1):+.2f}%; a segment's "
              f"records take {record_us:.1f} us of host time")

    ls = dict(step_size="linesearch")
    seg_want = {"run.start", "engine.compile", "engine.dispatch", "engine.segment",
                "comm.exchange", "comm.executable", "engine.fetch", "engine.final_loss",
                "dfw.loss"}
    try:
        # (a) MTLS at the ImageNet shapes, phase 3's configuration, 5 epochs
        X, Y = dense_data(torch, gen, dev, args.rows)
        mtls_task = tasks.MultiTaskLeastSquares(PAPER_D, PAPER_M)
        main = dict(mu=1.0, num_epochs=5, schedule="log", **ls)
        on_off("mtls", lambda tel, turn: dfw.fit_serial(
            mtls_task, X, Y, cfg=dfw.DFWConfig(telemetry=tel, **main), key=seed, device=dev),
            seg_want)
        # with a checkpoint dir (n cut to --serve-rows: a full-n step is 20.7 GB)
        n_ck = args.serve_rows
        on_off("mtls checkpointed", lambda tel, turn: dfw.fit_serial(
            mtls_task, X[:n_ck], Y[:n_ck], key=seed, device=dev, cfg=dfw.DFWConfig(
                telemetry=tel, checkpoint_dir=str(tmp / f"ck_{turn}"),
                checkpoint_keep=1, **main)),
            seg_want | {"checkpoint.snapshot", "checkpoint.write", "checkpoint.prune",
                        "checkpoint.join"})
        mtls = dfw.kernelize(mtls_task)
        base = mtls.init_state(X, Y)
        timed("mtls timing", mtls, lambda: base._replace(r=-Y), 1.0,
              dict(ls, num_epochs=12, schedule="const:2", block_epochs=4))
        del base
        torch.cuda.empty_cache()

        # (d) torch.profiler through the handle: 3 epochs, no IF node
        prof = Telemetry(profiler_dir=str(tmp / "profile"))
        with counting(kernels) as ran:
            res = dfw.fit_serial(mtls_task, X, Y, key=seed, device=dev, cfg=dfw.DFWConfig(
                mu=1.0, num_epochs=3, schedule="const:3", verify_kernels=False,
                telemetry=prof, **ls))
            torch.cuda.synchronize()
        add(ran)
        del res
        (trace,) = prof.profiler_traces
        doc = json.loads(Path(trace).read_text())
        device = [ev["name"] for ev in doc["traceEvents"] if ev.get("cat") == "kernel"]
        named = {p_: sum(1 for k_ in device if is_kernel(p_, k_)) for p_ in (
            "matvec_kernel", "rmatvec_partial_kernel", "rmatvec_finish_kernel", "rank1_kernel")}
        check(all(named.values()), f"(d) the profiler's trace names {named} of the port's "
              f"kernels among {len(device)} device events")
        report["profiler"] = dict(trace_bytes=Path(trace).stat().st_size,
                                  device_events=len(device), port_kernels=named,
                                  launches=ran.launches)
        print(f"(d) Telemetry(profiler_dir=...): a {report['profiler']['trace_bytes']}-byte "
              f"torch.profiler trace of a 3-epoch MTLS fit, {len(device)} device events naming "
              f"the port's kernels {named} (launched {ran.launches['matvec']} matvec, "
              f"{ran.launches['rmatvec']} rmatvec, {ran.launches['rank1_update_axpy']} "
              "rank1_update_axpy)")
        os.remove(trace)
        del X, Y, doc, device
        torch.cuda.empty_cache()

        # (a) MC dense at the Netflix shapes, phase 8's configuration, 5 epochs
        idx, yw, _, mu = make_mc_data(torch, gen, dev, args.mc_entries, NF_TEST)
        mc_task = tasks.MatrixCompletion(NF_D, NF_M)
        on_off("mc dense", lambda tel, turn: dfw.fit_serial(
            mc_task, idx, yw, key=seed, device=dev, cfg=dfw.DFWConfig(
                mu=mu, num_epochs=5, schedule="log", telemetry=tel, **ls)), seg_want)
        mc = dfw.kernelize(mc_task)
        base = mc.init_state(idx, yw)

        def mc_fresh():
            return base._replace(resid=base.resid.clone(), resid_by_row=base.resid_by_row.clone(),
                                 resid_by_col=base.resid_by_col.clone())

        timed("mc timing", mc, mc_fresh, mu, dict(ls, num_epochs=16, schedule="const:3",
                                                  block_epochs=4))

        # (b) the enabled run under the dispatch contract's guard, and its op
        # log: no implicit device read, the engine's counted fetches only
        contract = engine.dispatch_contract(name="engine.dispatch[mc const:2, telemetry]")
        tel = Telemetry()
        state = mc_fresh()
        torch.cuda.synchronize()
        with counting(kernels) as ran, OpRecorder() as rec, contract.guard():
            res = frank_wolfe.fit(mc, state, mu=mu, num_epochs=10, schedule="const:2",
                                  key=seed, device=dev, telemetry=tel, **ls)
            torch.cuda.synchronize()
        add(ran)
        try:
            contract.check_stats(res.stats)
            seen = contract.check_ops(rec)
        except AssertionError as e:
            check(False, f"(b) {e}")
        check(seen["explicit_syncs"] == res.stats["host_syncs"] and res.stats["graph_replays"],
              f"(b) {seen['explicit_syncs']} explicit fetches that read the device for stats "
              f"{res.stats}")
        execs = [ev["args"] for ev in tel.events() if ev["name"] == "comm.executable"]
        check(len(execs) == res.stats["compilations"] and all(e_["captured"] for e_ in execs),
              f"(b) comm.executable events {execs} for {res.stats['compilations']} programs")
        report["guarded"] = dict(stats=res.stats, implicit_syncs=seen["implicit_syncs"],
                                 explicit_syncs=seen["explicit_syncs"], ops=seen["ops"],
                                 executables=execs)
        print(f"(b) mc const:2 with telemetry under Contract.guard(): nothing raised; op log "
              f"of the run: {seen['ops']} ops, {seen['implicit_syncs']} implicit device reads, "
              f"{seen['explicit_syncs']} explicit fetches that read the device = host_syncs; "
              f"stats {res.stats}; "
              f"captured programs' op logs " + ", ".join(
                  f"(K={e_['k']}, {e_['length']} epochs): {e_['ops']} ops" for e_ in execs))
        del res, state
        torch.cuda.empty_cache()

        # (c) phase 21's one-worker NCCL fit, MC int8, under the recorder
        with tempfile.TemporaryDirectory() as store_dir:
            dist.init_process_group("nccl", store=dist.FileStore(
                os.path.join(store_dir, "store"), 1), rank=0, world_size=1, device_id=dev)
            try:
                group = comm.WorkerGroup()
                tel = Telemetry()
                cfg = dfw.DFWConfig(mu=mu, num_epochs=5, schedule="log", comm="int8",
                                    telemetry=tel, **ls)
                with counting(kernels) as ran, OpRecorder() as rec:
                    res = dfw.fit(mc_task, idx, yw, cfg=cfg, key=seed, group=group, device=dev)
                    torch.cuda.synchronize()
                add(ran)
            finally:
                dist.destroy_process_group()
        seen = rec.analyze()
        execs = [ev["args"] for ev in tel.events() if ev["name"] == "comm.executable"]
        ks = res.history["k"]
        per_epoch = {e_["k"]: e_["hlo_collective_count"].get("all-reduce", 0) / e_["length"]
                     for e_ in execs}
        want = {k_: 1 + 2 * k_ * 2 + 1 for k_ in set(ks)}  # loss, 2K int8 exchanges, line search
        check(per_epoch == want and all(e_["captured"] for e_ in execs),
              f"(c) all-reduces an epoch from the captures' op logs {per_epoch}, want {want}")
        check(seen["explicit_syncs"] == res.stats["host_syncs"],
              f"(c) {seen['explicit_syncs']} explicit fetches that read, host_syncs {res.stats}")
        # the tally counts the group's calls; the recorder also sees the
        # engine's warm-up all-reduce before its first capture
        check(seen["collective_count"]["all-reduce"] == res.stats["all_reduces"] + 1,
              f"(c) the op log's all-reduces {seen['collective_count']} against the tally's "
              f"{res.stats['all_reduces']} + 1 warm-up")
        report["world_one_int8"] = dict(per_epoch=per_epoch, ks=ks, stats=res.stats,
                                        collective_count=seen["collective_count"],
                                        collective_bytes=seen["collective_bytes"],
                                        explicit_syncs=seen["explicit_syncs"],
                                        implicit_syncs=seen["implicit_syncs"])
        print(f"(c) mc int8 fit over one NCCL worker under the recorder: all-reduces an epoch "
              f"from each captured program {per_epoch} (1 + 2K x 2 + 1); {seen['explicit_syncs']}"
              f" explicit fetches that read = host_syncs; {seen['collective_count']} in the op "
              f"log = the "
              f"tally's {res.stats['all_reduces']} + the warm-up; implicit reads (the start-up "
              f"checks) {seen['implicit_syncs']}")
        del res, base, idx, yw
        torch.cuda.empty_cache()

        # (e) phase 12's serving shapes: four engines, built off, on, on, off;
        # each request on all four, the first engine turning with the request,
        # then all again with the garbage collector off. After each dispatch
        # of an engine without a handle, outside its latency, the records an
        # enabled engine makes in block() go into a probe handle, timed there
        # (the records' cost in place, on a host just back from the card).
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 12)
        rank = 48
        it = low_rank.FactoredIterate(
            u=torch.randn((rank, SERVE_D), generator=g, device=dev) / SERVE_D ** 0.5,
            s=torch.rand(rank, generator=g, device=dev),
            v=torch.randn((rank, SERVE_M), generator=g, device=dev) / SERVE_M ** 0.5,
            alpha=torch.tensor(0.9, device=dev), count=torch.tensor(rank, dtype=torch.int32))
        rng = np.random.default_rng(seed)
        xs = [rng.standard_normal((SERVE_BATCH, SERVE_D), dtype=np.float32)
              for _ in range(args.serve_batches)]
        sides = (False, True, True, False)  # has a handle, in the order built
        n_req = TELEMETRY_REQUESTS
        lat = {gc_off: [[] for _ in sides] for gc_off in (False, True)}
        in_place = {False: [], True: []}
        probe = Telemetry()
        probe_hist = probe.registry.histogram("probe.latency_us")
        same = True
        with counting(kernels) as ran:
            engines = []
            for on in sides:
                eng = serve.ServingEngine(
                    SERVE_D, SERVE_M, serve.ServeConfig(
                        max_batch=SERVE_BATCH, rank_block=SERVE_BLOCK,
                        telemetry=Telemetry() if on else None), device=dev)
                eng.load(it)
                eng.load(it._replace(s=it.s * 0.5))  # a hot swap inside the bucket
                engines.append(eng)
            for gc_off in (False, True):
                if gc_off:
                    gc.collect()
                    gc.disable()
                try:
                    for i in range(n_req):
                        x, first = xs[i % len(xs)], None
                        for j in range(len(engines)):
                            e_ = (i + j) % len(engines)
                            t0 = time.perf_counter()
                            pending = engines[e_].score_async(x)
                            t1 = time.perf_counter()
                            out = pending.block()
                            t2 = time.perf_counter()
                            lat[gc_off][e_].append((1e3 * (t2 - t0), 1e6 * (t1 - t0),
                                                    1e6 * (t2 - t1)))
                            if not sides[e_]:
                                dur = 1e6 * (time.perf_counter() - t0)
                                probe.complete("probe.dispatch", "serve", probe.now_us() - dur,
                                               dur, n=SERVE_BATCH, version=1)
                                probe_hist.observe(dur)
                                in_place[gc_off].append(1e6 * (time.perf_counter() - t2))
                            if first is None:
                                first = out
                            elif not np.array_equal(first, out):
                                same = False
                finally:
                    gc.enable()
            torch.cuda.synchronize()
        add(ran)
        check(same, "(e) telemetry changed served scores")
        for e_, eng in enumerate(engines):
            try:
                eng.check_contract(eng.contract(max_compilations=1))
            except AssertionError as e:
                check(False, f"(e) engine {e_} (telemetry {sides[e_]}): {e}")
        st = engines[0].stats
        check(all(eng.stats == st for eng in engines) and st["dispatches"] == 2 * n_req,
              f"(e) stats {[eng.stats for eng in engines]}")
        for e_ in (1, 2):
            tel = engines[e_].telemetry
            snap = tel.registry.snapshot()
            names = [ev["name"] for ev in tel.events()]
            check(snap["histograms"]["serve.latency_us"]["count"] == st["dispatches"]
                  == names.count("serve.dispatch")
                  and names.count("serve.hot_swap") == 1 and "serve.compile" in names
                  and "serve.executable" in names,
                  f"(e) engine {e_}: histogram {snap['histograms'].get('serve.latency_us')}, "
                  f"stats {st}, events {sorted(set(names))}")

        def pct(vals, q):
            vals = sorted(vals)
            return vals[min(len(vals) - 1, max(0, math.ceil(q * len(vals)) - 1))]

        def summary(samples):
            part = [[v_[j_] for v_ in samples] for j_ in range(3)]
            return dict(n=len(samples), p50_ms=pct(part[0], 0.5), p99_ms=pct(part[0], 0.99),
                        score_async_p50_us=pct(part[1], 0.5), block_p50_us=pct(part[2], 0.5))

        row = report["serving"] = {}
        for gc_off in (False, True):
            by = lat[gc_off]
            row["gc_off" if gc_off else "gc_on"] = dict(
                off=summary(by[0] + by[3]), on=summary(by[1] + by[2]),
                engines=[summary(b_) for b_ in by],
                records_in_place_p50_us=pct(in_place[gc_off], 0.5),
                records_in_place_mean_us=statistics.mean(in_place[gc_off]))
        row["log_ops"] = [b_.log["ops"] for b_ in engines[1]._buckets.values()]
        # what the handle adds to a dispatch on the host, timed alone: the
        # t0 stamp, the serve.dispatch span and the histogram observation;
        # and a span of the disabled handle (noop_contract's clause)
        tel = Telemetry()
        hist = tel.registry.histogram("probe.latency_us")
        t0 = time.perf_counter()
        for _ in range(10_000):
            t_ = tel.now_us()
            tel.complete("probe.dispatch", "serve", t_, tel.now_us() - t_, n=SERVE_BATCH,
                         version=1)
            hist.observe(5.0)
        row["dispatch_records_us"] = 1e6 * (time.perf_counter() - t0) / 10_000
        noop = Telemetry.noop()
        t0 = time.perf_counter()
        for _ in range(10_000):
            with noop.span("probe"):
                pass
        row["noop_span_us"] = 1e6 * (time.perf_counter() - t0) / 10_000

        def side(r_):
            return (f"{r_['p50_ms']:.4f} / {r_['p99_ms']:.4f} ms (score_async "
                    f"{r_['score_async_p50_us']:.1f} us, block {r_['block_p50_us']:.1f})")

        print(f"(e) serving {SERVE_BATCH} x {SERVE_D} -> {SERVE_M}, rank {rank}, four engines "
              f"built off, on, on, off, each of {n_req} requests on all four (the first "
              f"turning), {2 * n_req} dispatches a side; the same scores; check_contract "
              f"passes on every bucket's capture log ({row['log_ops']} ops, no {SERVE_D} x "
              f"{SERVE_M}); histogram counts = dispatches")
        for key in ("gc_on", "gc_off"):
            r_ = row[key]
            print(f"(e) {key.replace('_', ' ')}: p50 / p99 off {side(r_['off'])}, on "
                  f"{side(r_['on'])}; by engine (off, on, on, off) p50 "
                  + ", ".join(f"{e_['p50_ms']:.4f}" for e_ in r_["engines"]) + ", p99 "
                  + ", ".join(f"{e_['p99_ms']:.4f}" for e_ in r_["engines"]) + " ms; the "
                  f"records in place p50 {r_['records_in_place_p50_us']:.2f} us, mean "
                  f"{r_['records_in_place_mean_us']:.2f}")
        print(f"(e) a dispatch's records take {row['dispatch_records_us']:.2f} us of host "
              f"time back to back, a disabled handle's span {row['noop_span_us']:.3f} us")
        del engines, it, xs

        # (f) every declared contract, with the default device: the card
        from repro_torch.analysis import contracts

        t0 = time.perf_counter()
        with counting(kernels) as ran:
            rc = contracts.verify_declared(verbose=True)
            torch.cuda.synchronize()
        add(ran)
        check(rc == 0, "(f) verify_declared() found a broken contract on the card")
        report["verify_declared_s"] = time.perf_counter() - t0
        print(f"(f) verify_declared() on the card (its default device): every declared "
              f"contract holds, {report['verify_declared_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 28 took {report['wall_s']:.1f} s")
    return report, total, routed[0]


HEAD_EPOCHS = 10  # phase 29's head fits
# top_k_error's wall ms over 1,281,167 rows before the tie rule (torch.topk's
# indices; first call, again), measured by this script on an NVIDIA H100 80GB
# HBM3 at 700 W; printed beside this run's, which also times that rule
TOP_K_MS_BEFORE = (76.94, 69.96)
HEAD_CKPT_ROWS = 16_384  # phase 26's cut: a full-n logistic step holds X and Z (about 15.6 GB)
FEATURE_BATCHES, FEATURE_SHAPE = 8, (4, 2048)  # qwen2-1.5b: 65,536 feature rows
SSM_FEATURE_SHAPE = (4, 1024)  # rwkv6-7b: one batch
PSGD_SHAPE, PSGD_RANK, PSGD_STEPS = (1536, 8960), 4, 5  # qwen2-1.5b's MLP gradient


def head_summary(low_rank, res):
    return dict(history=res.history, final_loss=res.final_loss,
                packed=low_rank.pack_live(res.iterate))


def same_head(np, a, b) -> bool:
    """The same history, final loss and iterate, bit for bit."""
    return (a["history"] == b["history"] and a["final_loss"] == b["final_loss"]
            and all(np.array_equal(a["packed"][k], b["packed"][k]) for k in a["packed"]))


def top_k_rows(torch, fm, hits_fn, it, x, y, k, rows, plain: bool):
    """Per-row top-k hits of the head on x (``hits_fn``: the port's
    ``dfw_head.top_k_hits``, ties to the lower index as ``jax.lax.top_k``)
    and each row's gap between its k-th and (k+1)-th logit, chunk by chunk:
    from the kernel (``factor_matvec``), or with ``plain`` from its plain
    rank-by-rank chain on the same chunks, and then also each row's largest
    |kernel - plain| logit. Without ``plain``, the last value is the count
    of rows whose hit differs from the first k of a stable descending sort
    of the same logits (the reference's rule, taken the slow way)."""
    hits, gaps, parts = [], [], []
    off_rule = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], rows):
        xc, yc = x[lo:lo + rows], y[lo:lo + rows]
        kern = fm.factor_matvec(xc, it.u, it.s, it.v, alpha=it.alpha)
        logits = fm.ref.factor_matvec(xc, it.u, it.s * it.alpha, it.v) if plain else kern
        top = torch.topk(logits, k + 1, dim=1).values
        gaps.append(top[:, k - 1] - top[:, k])
        hit = hits_fn(logits, yc, k)
        hits.append(hit)
        if plain:
            parts.append(torch.max(torch.abs(kern - logits), dim=1).values)
        else:
            order = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :k]
            off_rule += (hit != (order == yc[:, None]).any(dim=1)).sum()
    return torch.cat(hits), torch.cat(gaps), torch.cat(parts) if parts else int(off_rule)


def top_k_tie_probe(torch, low_rank, dfw_head, x, dev):
    """ROADMAP section 3's probe at the card's shapes: a rank-1 head whose
    only nonzero logit column is 7, on features x >= 0, so every row's other
    logits tie at 0. With jax.lax.top_k's rule, column 0 is among the top 5
    and column 5 is not: labels 0 give an error of 0, labels 5 of 1."""
    m = PAPER_M
    v = torch.zeros((1, m), device=dev)
    v[0, 7] = 1.0
    it = low_rank.FactoredIterate(
        u=torch.ones((1, x.shape[1]), device=dev), s=torch.ones(1, device=dev), v=v,
        alpha=torch.ones((), device=dev), count=torch.ones((), dtype=torch.int32, device=dev))
    n = x.shape[0]
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    return (dfw_head.top_k_error(it, x, zeros, k=5), dfw_head.top_k_error(it, x, zeros + 5, k=5))


def head_phase(torch, np, kernels, dfw, comm, tasks, low_rank, checkpoint, dfw_head,
               compression, lm, get_config, fm, dev, args, peaks):
    """Phase 29 (see the module doc). Returns (report, summed launches of its
    main-path runs, its kernel rows: row 8's top_k_error chunk)."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    report, rows_out = {}, []
    t_phase = time.perf_counter()
    total = dict.fromkeys(kernels.launches(), 0)
    bw, flops = peaks[:2]

    def add(launches):
        for k_, v_ in launches.items():
            total[k_] += v_

    def sync_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) train_head at the ImageNet shapes, against fit_serial
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n = args.rows
    X = torch.randn(n, PAPER_D, generator=gen, device=dev)
    labels = planted_labels(torch, gen, dev, X)
    kw = dict(mu=10.0, num_epochs=HEAD_EPOCHS, schedule="const:2")
    with counting(kernels) as ran:
        head, wall = sync_wall(lambda: dfw_head.train_head(X, labels, PAPER_M, key=args.seed,
                                                           device=dev, **kw))
    add(ran.launches)
    want = expected_launches("logistic", head.history["k"], False)
    check(ran.launches == want, f"(a) train_head: launches {ran.launches} != expected {want}")
    head_s = head_summary(low_rank, head)
    bound = n * math.log(PAPER_M)
    check(head.final_loss < bound, f"(a) train_head: final loss {head.final_loss} >= n ln m")
    ser = dfw.fit_serial(tasks.MultinomialLogistic(PAPER_D, PAPER_M), X, labels, key=args.seed,
                         device=dev, cfg=dfw.DFWConfig(verify_kernels=False, **kw))
    check(same_head(np, head_s, head_summary(low_rank, ser)),
          "(a) train_head is not fit_serial, bit for bit")
    del ser
    torch.cuda.empty_cache()
    seg_log = []
    timed = dfw.fit_serial(tasks.MultinomialLogistic(PAPER_D, PAPER_M), X, labels, key=args.seed,
                           device=dev, callback=segment_timer(torch, seg_log),
                           cfg=dfw.DFWConfig(verify_kernels=False, block_epochs=5, **kw))
    ms_epoch = seg_log[-1]["ms_per_epoch"]
    del timed
    torch.cuda.empty_cache()
    report["a"] = dict(wall_s=wall, ms_per_epoch=ms_epoch, loss=head.history["loss"],
                       final_loss=head.final_loss, launches=ran.launches)
    print(f"(a) train_head, logistic head at n={n}, d={PAPER_D}, m={PAPER_M}, "
          f"{HEAD_EPOCHS} epochs const:2: fit_serial's bits; {wall:.3f} s whole, "
          f"{ms_epoch:.3f} ms an epoch (second segment of 5); final loss "
          f"{head.final_loss:.6g} < n ln m = {bound:.6g}; launches {ran.launches}")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build, prefix="head_"))
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            group = comm.WorkerGroup()
            # (b) sharded_fit over one NCCL worker; checkpoints and resume at n cut
            with counting(kernels) as ran:
                res = dfw_head.sharded_fit(group, X, labels, PAPER_M, key=args.seed, device=dev,
                                           **kw)
            add(ran.launches)
            check(same_head(np, head_summary(low_rank, res), head_s),
                  "(b) sharded_fit over one NCCL worker is not train_head, bit for bit")
            check(ran.launches == want, f"(b) sharded_fit launched {ran.launches}, not {want}")
            del res
            torch.cuda.empty_cache()
            xs, ys = X[:HEAD_CKPT_ROWS], labels[:HEAD_CKPT_ROWS]
            ckw = dict(mu=10.0, num_epochs=12, schedule="const:2", block_epochs=4)
            task = tasks.MultinomialLogistic(PAPER_D, PAPER_M)
            ck = checkpoint.RunCheckpointer(tmp / "ck", keep_last=None, extra=checkpoint.run_extra(
                task, num_workers=1, comm="dense", num_epochs=12, schedule="const:2", mu=10.0,
                step_size="default"))
            full = head_summary(low_rank, dfw_head.sharded_fit(
                group, xs, ys, PAPER_M, key=args.seed, checkpointer=ck, device=dev, **ckw))
            check(ck.store.steps() == [4, 8, 12], f"(b) checkpoint steps {ck.store.steps()}")
            snap = checkpoint.restore_run(tmp / "ck", task=task, step=8)
            with counting(kernels) as ran8:
                res8 = head_summary(low_rank, dfw_head.sharded_fit(
                    group, xs, ys, PAPER_M, key=args.seed, resume=snap, device=dev, **ckw))
            check(same_head(np, res8, full), "(b) the resume from step 8 is not the full run")
            snap = checkpoint.restore_run(tmp / "ck", task=task, step=12)
            with counting(kernels) as ran12:
                res12 = head_summary(low_rank, dfw_head.sharded_fit(
                    group, xs, ys, PAPER_M, key=args.seed, resume=snap, device=dev, **ckw))
            check(same_head(np, res12, full), "(b) the resume from step 12 is not the full run")
            check(not any(ran12.launches.values()),
                  f"(b) the resume from step 12 launched {ran12.launches}")
            report["b"] = dict(steps=ck.store.steps(), step_bytes=step_bytes(tmp / "ck", 8),
                               resume8_launches=ran8.launches)
            print(f"(b) sharded_fit over one NCCL worker = train_head bit for bit; at n = "
                  f"{HEAD_CKPT_ROWS} steps {ck.store.steps()} ({report['b']['step_bytes']} bytes "
                  f"a step), the resume from 8 the full run's bits, from 12 nothing launched")

            # (e) PowerSGD on qwen2-1.5b's MLP gradient shape
            pgen = torch.Generator(device=dev)
            pgen.manual_seed(args.seed)
            grads = [{"w": torch.randn(PSGD_SHAPE, generator=pgen, device=dev)}
                     for _ in range(PSGD_STEPS)]
            st0 = compression.init(grads[0], rank=PSGD_RANK, min_size=4096, gen=pgen)
            st_card = st_nccl = st0
            st_cpu = compression.PowerSGDState(q={"w": st0.q["w"].cpu()},
                                               error={"w": st0.error["w"].cpu()})
            errs, step_ms = [], []
            for g in grads:
                (out, st_card), wall = sync_wall(
                    lambda g=g, st=st_card: compression.compress_and_sync(g, st, min_size=4096))
                step_ms.append(1e3 * wall)
                out_n, st_nccl = compression.compress_and_sync(g, st_nccl, min_size=4096,
                                                               group=group)
                out_c, st_cpu = compression.compress_and_sync({"w": g["w"].cpu()}, st_cpu,
                                                              min_size=4096)
                check(torch.equal(out_n["w"], out["w"]) and torch.equal(st_nccl.q["w"],
                                                                        st_card.q["w"]),
                      "(e) PowerSGD over one NCCL worker is not the serial run, bit for bit")
                got, want_c = out["w"].cpu(), out_c["w"]
                # rtol 1e-4 with an atol of 1e-4 of max|CPU|
                err = float(torch.max(torch.abs(got - want_c) / (
                    torch.abs(want_c) + torch.max(torch.abs(want_c)))))
                errs.append(err)
                check(err <= 1e-4, f"(e) PowerSGD on the card departs from the CPU by {err:.2e}")
            wb = compression.wire_bytes(grads[0], rank=PSGD_RANK, min_size=4096)
            report["e"] = dict(ms_per_step=step_ms, max_err=errs, wire_bytes=wb)
            print(f"(e) PowerSGD rank {PSGD_RANK} on {PSGD_SHAPE}, {PSGD_STEPS} steps: the CPU's "
                  f"within {max(errs):.2e} (rtol 1e-4 with atol 1e-4 of max); over one NCCL worker "
                  f"the serial bits; ms a step {', '.join(f'{v:.3f}' for v in step_ms)}; wire "
                  f"bytes {wb['compressed']} against {wb['dense']} dense "
                  f"({wb['dense'] / wb['compressed']:.1f}x)")
            del grads, st0, st_card, st_nccl, st_cpu, out, out_n, out_c
        finally:
            comm.destroy_groups()
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) top_k_error over every row, factor_matvec in row chunks
    it = head.iterate
    rows = low_rank.RIGHT_MULTIPLY_ROWS
    with counting(kernels) as ran:
        err5, wall = sync_wall(lambda: dfw_head.top_k_error(it, X, labels, k=5))
    add(ran.launches)
    chunks = -(-n // rows)
    check(ran.launches["factor_matvec"] == chunks,
          f"(c) top_k_error launched factor_matvec {ran.launches['factor_matvec']} times, "
          f"not once a chunk ({chunks})")
    hits_k, _, off_rule = top_k_rows(torch, fm, dfw_head.top_k_hits, it, X, labels, 5, rows,
                                     plain=False)
    hits_p, gaps_p, parts = top_k_rows(torch, fm, dfw_head.top_k_hits, it, X, labels, 5, rows,
                                       plain=True)
    err_k = float(1.0 - hits_k.sum().to(torch.float32) / n)
    check(err_k == err5, f"(c) top_k_error {err5} is not its own chunks' hits' {err_k}")
    check(off_rule == 0, f"(c) {off_rule} rows' hits are not the first 5 of a stable descending "
          "sort of the same logits (jax.lax.top_k's rule)")
    # With the reference's tie rule on both sides, a row's hit may differ only
    # where the kernel's logits differ from the plain chain's by more than
    # half the row's 5th-to-6th gap: a tie of equal logits is broken alike.
    differ = hits_k != hits_p
    untied = differ & ~((gaps_p.abs() <= 2 * parts) & (parts > 0))
    check(not bool(untied.any()),
          f"(c) {int(untied.sum())} rows' hits differ from the plain chain's without a near tie")
    probe = top_k_tie_probe(torch, low_rank, dfw_head, X[:rows].abs(), dev)
    check(probe == (0.0, 1.0), f"(c) tie probe: top-5 errors {probe}, the reference's (0.0, 1.0)")

    def topk_indices_rule():  # the loop before the tie rule, for its time
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        for lo in range(0, n, rows):
            idx = torch.topk(low_rank.right_multiply(it, X[lo:lo + rows]), 5, dim=1).indices
            hits += (idx == labels[lo:lo + rows, None]).any(dim=1).sum()
        return float(1.0 - hits.to(torch.float32) / n)

    turns = []  # new, old, old, new
    for fn in (lambda: dfw_head.top_k_error(it, X, labels, k=5), topk_indices_rule,
               topk_indices_rule, lambda: dfw_head.top_k_error(it, X, labels, k=5)):
        turns.append(1e3 * sync_wall(fn)[1])
    err_plain = float(1.0 - hits_p.sum().to(torch.float32) / n)
    chance = 1.0 - 5 / PAPER_M
    check(err5 < chance, f"(c) top-5 error {err5} not below W = 0's {chance}")
    _, wall2 = sync_wall(lambda: dfw_head.top_k_error(it, X, labels, k=5))
    xc = X[:rows]
    r = int(it.u.shape[0])
    kern = lambda: fm.factor_matvec(xc, it.u, it.s, it.v, alpha=it.alpha)  # noqa: E731
    sa = it.s * it.alpha
    plain = lambda: fm.ref.factor_matvec(xc, it.u, sa, it.v)  # noqa: E731
    lib = lambda: torch.einsum("bi,ki,k,kj->bj", xc, it.u, sa, it.v)  # noqa: E731
    e_abs, e_rel = rel_err(torch, kern(), plain())
    check(e_rel <= TOL["factor_matvec"], f"(c) factor_matvec at the chunk: rel err {e_rel:.2e}")
    nbytes = 4 * (rows * PAPER_D + r * (PAPER_D + PAPER_M + 1) + rows * PAPER_M)
    nflops = 2 * rows * r * (PAPER_D + PAPER_M) + rows * r
    row = dict(name="factor_matvec", operand=f"b={rows} r={r} {PAPER_D}->{PAPER_M} "
               "(top_k_error chunk)", shape=[rows, PAPER_D, r, PAPER_M], max_abs_err=e_abs,
               max_rel_err=e_rel, ms=time_ms(torch, kern, args.reps),
               plain_ms=time_ms(torch, plain, args.reps), library_ms=time_ms(torch, lib, args.reps),
               library_rel_err=rel_err(torch, lib(), kern())[1],
               bound_ms=1e3 * max(nbytes / bw, nflops / flops),
               bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
               bytes=nbytes, flops=nflops, device_ms=device_ms(torch, kern, "factor_matvec_kernel"),
               library_device_ms=device_ms(torch, lib))
    rows_out.append(row)
    report["c"] = dict(top5_error=err5, plain_error=err_plain, rows_differing=int(differ.sum()),
                       wall_ms=1e3 * wall, wall_ms_again=1e3 * wall2, chunks=chunks, row=row,
                       tie_probe=probe, turns_ms=turns, pr30_ms=TOP_K_MS_BEFORE)
    print(f"(c) top_k_error over {n} rows, {chunks} factor_matvec launches of {rows} rows: top-5 "
          f"error {err5:.6f} (W = 0: {chance}; plain chain on the same chunks {err_plain:.6f}, "
          f"{int(differ.sum())} rows differing, each at a near tie; every row's hit the first 5 "
          f"of a stable sort's; tie probe {probe}); {1e3 * wall:.2f} ms ({1e3 * wall2:.2f} "
          f"again); in turns tie rule / torch.topk's indices / indices / tie rule: "
          f"{', '.join(f'{v:.2f}' for v in turns)} ms (the earlier measurement, indices: "
          f"{TOP_K_MS_BEFORE[0]} first, {TOP_K_MS_BEFORE[1]} again); "
          f"kernel at the chunk {row['ms']:.4f} ms (device "
          f"{fmt_ms(row['device_ms'])}), "
          f"einsum {row['library_ms']:.4f} (device {fmt_ms(row['library_device_ms'])}), plain "
          f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} by {row['bound_by']}, rel err "
          f"{e_rel:.2e}")
    del head, it, X, labels, hits_k, hits_p, gaps_p, parts, xc
    torch.cuda.empty_cache()

    # (d) features from qwen2-1.5b (full width and depth, bf16), a head on them
    cfg = get_config(LM_ARCH)
    params = lm.init_params(cfg, gen)
    b, s = FEATURE_SHAPE
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                "labels": torch.zeros((b, s), dtype=torch.int64, device=dev)}
               for _ in range(FEATURE_BATCHES)]
    with counting(kernels) as ran:
        (feats, _), wall = sync_wall(lambda: dfw_head.extract_features(params, batches, cfg))
    add(ran.launches)
    want_fa = cfg.num_layers * FEATURE_BATCHES
    check(ran.launches["flash_attention"] == want_fa and ran.routes["flash_attention"] == {
        "wgmma": want_fa, "generic": 0},
          f"(d) features: flash_attention {ran.launches['flash_attention']} launches, routes "
          f"{ran.routes['flash_attention']}; expected {want_fa}, all wgmma")
    rows_f = FEATURE_BATCHES * b * s
    check(tuple(feats.shape) == (rows_f, cfg.d_model) and feats.dtype == torch.float32
          and bool(torch.isfinite(feats).all()),
          f"(d) features {tuple(feats.shape)}: not finite f32 of the expected shape")
    del params, batches
    torch.cuda.empty_cache()
    w_plant = torch.randn(cfg.d_model, 10, generator=gen, device=dev) @ torch.randn(
        10, PAPER_M, generator=gen, device=dev)
    y_f = torch.argmax(feats @ w_plant, dim=1)
    with counting(kernels) as ran:
        fhead = dfw_head.train_head(feats, y_f, PAPER_M, key=args.seed, device=dev, **kw)
        ferr = dfw_head.top_k_error(fhead.iterate, feats, y_f, k=5)
    add(ran.launches)
    fwant = expected_launches("logistic", fhead.history["k"], False)
    fwant["factor_matvec"] = -(-rows_f // rows)
    check(ran.launches == fwant, f"(d) head on features: launches {ran.launches} != {fwant}")
    floss = fhead.history["loss"] + [fhead.final_loss]
    check(floss[-1] < floss[0], "(d) the head's loss on the features did not decrease")
    check(ferr < chance, f"(d) top-5 error {ferr} on the features not below chance {chance}")
    report["d"] = dict(feature_s=wall, rows=rows_f, d=cfg.d_model, loss=floss, top5_error=ferr)
    print(f"(d) {cfg.name} features ({cfg.num_layers} layers, {cfg.dtype}) over "
          f"{FEATURE_BATCHES} batches of {b} x {s} tokens: {rows_f} x {cfg.d_model} f32 in "
          f"{1e3 * wall:.1f} ms, {want_fa} flash_attention launches, all wgmma; head "
          f"{HEAD_EPOCHS} epochs: loss {floss[0]:.6g} -> {floss[-1]:.6g}, top-5 error "
          f"{ferr:.4f} (chance {chance})")
    del feats, y_f, fhead, w_plant
    torch.cuda.empty_cache()
    scfg = get_config(SSM_ARCH)
    params = lm.init_params(scfg, gen)
    nonzero_bonus(torch, params, gen)
    b, s = SSM_FEATURE_SHAPE
    toks = torch.randint(0, scfg.vocab_size, (b, s), generator=gen, device=dev)
    with counting(kernels) as ran:
        (feats, fy), wall = sync_wall(lambda: dfw_head.extract_features(
            params, [{"tokens": toks, "labels": toks}], scfg))
    add(ran.launches)
    want_wkv = scfg.num_layers * (s // min(scfg.ssm_chunk, s))
    check(ran.launches["wkv6_chunk"] == want_wkv,
          f"(d) rwkv features: wkv6_chunk {ran.launches['wkv6_chunk']} launches, not {want_wkv}")
    check(tuple(feats.shape) == (b * s, scfg.d_model) and bool(torch.isfinite(feats).all())
          and torch.equal(fy, toks.reshape(-1)), "(d) rwkv features or labels wrong")
    report["d"].update(ssm_feature_s=wall, ssm_rows=b * s)
    print(f"(d) {scfg.name} features ({scfg.num_layers} layers) on {b} x {s} tokens: "
          f"{b * s} x {scfg.d_model} in {1e3 * wall:.1f} ms, {want_wkv} wkv6_chunk launches")
    del params, toks, feats, fy
    torch.cuda.empty_cache()
    report["wall_s"] = time.perf_counter() - t_phase
    report["launches"] = total
    print(f"phase 29 took {report['wall_s']:.1f} s")
    return report, total, rows_out


TRAIN_ARCH = LM_ARCH  # qwen2-1.5b at full width and depth
TRAIN_SHAPE = (4, 2048)  # (B, S) of every phase-30 train step
TRAIN_STEPS = 10
TRAIN_RESUME_LAYERS, TRAIN_RESUME_AT = 2, 5  # (a)'s resume at a depth cut: ~2.8 GB a step
HYBRID_ARCH = "codeqwen1_5_7b"  # untied head (4096 x 92,416)
HYBRID_LAYERS = 16  # of 32: 53.7 GB of training state
HYBRID_STEPS, HYBRID_MU, HYBRID_ITERS = 5, 100.0, 2
HYBRID_CHECK_STEP = 1  # the step whose head update is held to the plain chain (gamma 2/3)
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS = 8, 2  # rwkv6-7b at full width: 8 of 32 layers


def leaf_names(tree, prefix=""):
    """Leaf paths of a parameter tree in ``tree_leaves``'s order (dict keys
    sorted, list items in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, sub in enumerate(tree) for n in leaf_names(sub, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


@contextlib.contextmanager
def grad_watch(torch, lm):
    """Inside the block every ``lm.value_and_grad`` call (the train steps')
    also records each gradient leaf's max |g| on the device: yields the list
    of (leaves,) tensors, one a step."""
    from repro_torch.optim.compression import tree_leaves

    seen, orig = [], lm.value_and_grad

    def watched(params, batch, cfg, **kw):
        out, grads = orig(params, batch, cfg, **kw)
        seen.append(torch.stack([g.detach().abs().amax().float() for g in tree_leaves(grads)]))
        return out, grads

    lm.value_and_grad = watched
    try:
        yield seen
    finally:
        lm.value_and_grad = orig


def zero_grad_leaves(torch, seen, names):
    """The leaves whose gradient was exactly zero (or not finite) at some step."""
    g = torch.stack(seen)
    bad = ~(torch.isfinite(g) & (g > 0)).all(dim=0)
    return [names[i] for i in torch.nonzero(bad).flatten().tolist()]


def bf16_ulps(torch, got, want) -> int:
    """Largest distance in bf16 units in the last place (ordered bits)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


def trace_norm_f64(torch, w):
    """||w||_*: the square roots of the eigenvalues of w w^T (the short
    side), in f64 on the card."""
    w64 = w.to(torch.float64)
    g = w64 @ w64.T if w.shape[0] <= w.shape[1] else w64.T @ w64
    del w64
    return float(torch.linalg.eigvalsh(g).clamp_min(0).sqrt().sum())


def held_memory(torch):
    """(GB allocated on the card, the largest live CUDA tensors the garbage
    collector can reach: (shape, dtype, GB))."""
    import gc

    found = {}
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                st = obj.untyped_storage()
                found[st.data_ptr()] = (tuple(obj.shape), str(obj.dtype), st.nbytes() / 1e9)
        except Exception:  # noqa: BLE001 - objects that refuse inspection are skipped
            continue
    top = sorted(found.values(), key=lambda t: -t[2])[:5]
    return torch.cuda.memory_allocated() / 1e9, top


def head_kernel_rows(torch, pm, r1, dev, gen, d, v, label, tag, reps, peaks, main=False):
    """The hybrid step's kernels at a head of d x v: the bf16 rank1_update
    in place against its plain version (one bf16 ulp) and ``torch.addr_``
    in bf16 (in turns), and matvec/rmatvec on the f32 gradient against
    their plain versions and ``torch.mv`` (in turns), each beside its bound
    (the bytes moved, 4 an element of Z for the update). Returns the rows
    of the kernels line (``main`` marks the update's as its main row)."""
    bw, flops = peaks[:2]
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    rows_out = []
    z0 = rn(d, v).bfloat16()
    x, y = rn(d), rn(v)
    a_, b_ = 0.75, -1.5
    scal = torch.tensor([a_, b_], device=dev)
    want = r1.ref.rank1_update(z0, x, y, scal)
    W = z0.clone()
    check(r1.rank1_update(W, x, y, a_, b_, out=W) is W, f"{tag} bf16 rank1_update not in place")
    torch.cuda.synchronize()
    ulps = bf16_ulps(torch, W, want)
    e_abs, e_rel = rel_err(torch, W.float(), want.float())
    check(ulps <= 1, f"{tag} bf16 rank1_update is {ulps} bf16 ulps from its plain version")
    check(torch.equal(r1.rank1_update(z0, x, y, a_, b_), W), f"{tag} bf16 out of place != in place")
    xb, yb = x.bfloat16(), y.bfloat16()
    lib_err = rel_err(torch, torch.addr(z0, xb, yb, beta=a_, alpha=b_).float(), want.float())[1]
    nbytes, nflops = 4 * d * v + 4 * (d + v), 4 * d * v
    kfn = lambda: r1.rank1_update(W, x, y, a_, b_, out=W)  # noqa: E731
    lfn = lambda: W.addr_(xb, yb, beta=a_, alpha=b_)  # noqa: E731
    ms1, lib1 = time_ms(torch, kfn, reps), time_ms(torch, lfn, reps)
    lib2, ms2 = time_ms(torch, lfn, reps), time_ms(torch, kfn, reps)
    row = dict(name="rank1_update_bf16", operand=f"{d}x{v} bf16 in place ({label})",
               shape=[d, v], max_abs_err=e_abs, max_rel_err=e_rel, ulps=ulps,
               ms=(ms1 + ms2) / 2, ms_rounds=[ms1, ms2],
               plain_ms=time_ms(torch, lambda: r1.ref.rank1_update(z0, x, y, scal), reps),
               library_ms=(lib1 + lib2) / 2, library_ms_rounds=[lib1, lib2],
               library_rel_err=lib_err,
               bound_ms=1e3 * max(nbytes / bw, nflops / flops),
               bound_by="bytes" if nbytes / bw >= nflops / flops else "operations",
               bytes=nbytes, flops=nflops, main=main,
               device_ms=device_ms(torch, kfn, "rank1_bf16_kernel"))
    rows_out.append(row)
    print(f"{tag} kernel rank1_update_bf16 {d}x{v} in place: {row['ms']:.4f} ms (turns "
          f"{row['ms_rounds']}; device {fmt_ms(row['device_ms'])}), plain "
          f"{row['plain_ms']:.4f}, torch.addr_ bf16 {row['library_ms']:.4f} (turns "
          f"{row['library_ms_rounds']}; rel err from the plain version {lib_err:.2e}), bound "
          f"{row['bound_ms']:.4f} by {row['bound_by']} ({row['bound_ms'] / row['ms']:.3f} of it); "
          f"within {ulps} bf16 ulp of its plain version")
    del z0, W, want, xb, yb
    torch.cuda.empty_cache()
    A = rn(d, v)
    vv, uu = rn(v), rn(d)
    for name, kfn, pfn, lfn in (
            ("matvec", lambda: pm.matvec(A, vv), lambda: pm.ref.matvec(A, vv),
             lambda: torch.mv(A, vv)),
            ("rmatvec", lambda: pm.rmatvec(A, uu), lambda: pm.ref.rmatvec(A, uu),
             lambda: torch.mv(A.t(), uu))):
        e_abs, e_rel = rel_err(torch, kfn(), pfn())
        check(e_rel <= TOL[name], f"{tag} {name} at the head gradient: rel err {e_rel:.2e}")
        nb, nf = 4 * (d * v + d + v), 2 * d * v
        ms1, lib1 = time_ms(torch, kfn, reps), time_ms(torch, lfn, reps)
        lib2, ms2 = time_ms(torch, lfn, reps), time_ms(torch, kfn, reps)
        row = dict(name=name, operand=f"head gradient {d}x{v} ({label})", shape=[d, v],
                   max_abs_err=e_abs, max_rel_err=e_rel, ms=(ms1 + ms2) / 2,
                   ms_rounds=[ms1, ms2], plain_ms=time_ms(torch, pfn, reps),
                   library_ms=(lib1 + lib2) / 2, library_ms_rounds=[lib1, lib2],
                   bound_ms=1e3 * max(nb / bw, nf / flops),
                   bound_by="bytes" if nb / bw >= nf / flops else "operations", bytes=nb)
        rows_out.append(row)
        print(f"{tag} kernel {name} at the head gradient {d}x{v}: {row['ms']:.4f} ms (turns "
              f"{row['ms_rounds']}), plain {row['plain_ms']:.4f}, torch.mv "
              f"{row['library_ms']:.4f} (turns {row['library_ms_rounds']}), bound "
              f"{row['bound_ms']:.4f} ({row['bound_ms'] / row['ms']:.3f} of it), rel err "
              f"{e_rel:.2e}")
    del A
    torch.cuda.empty_cache()
    return rows_out


def train_phase(torch, np, kernels, lm, steps, train_mod, hybrid, adamw, data, ShapeSpec,
                power_method, pm, r1, get_config, dev, args, peaks):
    """Phase 30 (see the module doc). Returns (report, summed launches of its
    train runs, prefill and hybrid steps, its kernel rows)."""
    import shutil
    import tempfile
    import types

    from repro_torch.optim.compression import tree_leaves

    import gc

    report, rows_out = {}, []
    t_phase = time.perf_counter()
    total = dict.fromkeys(kernels.launches(), 0)
    bf16_total = 0
    b, s = TRAIN_SHAPE
    # what the earlier phases leave on the card: the training configurations
    # need most of it (codeqwen1.5-7b at 16 layers peaks at about 62 GB)
    held = held_memory(torch)
    gc.collect()
    torch.cuda.empty_cache()
    report["held_gb"] = [held[0], torch.cuda.memory_allocated() / 1e9]
    print(f"phase 30 starts with {held[0]:.2f} GB allocated ({report['held_gb'][1]:.2f} GB after "
          f"a garbage collection); largest live tensors {held[1]}")
    tokens = b * s

    def add(ran):
        nonlocal bf16_total
        for k_, v_ in ran.launches.items():
            total[k_] += v_
        bf16_total += ran.routes["rank1_update"]["bf16"]

    def step_clock(stamps):
        def cb(step, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return cb

    # (a) qwen2-1.5b at full width and depth: launch.train.train, AdamW
    cfg = get_config(TRAIN_ARCH)
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with grad_watch(torch, lm) as seen, counting(kernels) as ran:
        params, opt, hist = train_mod.train(
            arch=TRAIN_ARCH, steps=TRAIN_STEPS, smoke=False, seq_len=s, global_batch=b,
            log_every=1, device=dev, seed=args.seed, callback=step_clock(stamps))
    add(ran)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [v for _, v in hist]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"(a) train losses {losses}")
    bad = zero_grad_leaves(torch, seen, leaf_names(params))
    check(not bad, f"(a) {len(bad)} parameters got a zero gradient, e.g. {bad[:5]}")
    check(ran.launches["flash_attention"] == 0 and ran.launches["wkv6_chunk"] == 0,
          f"(a) a train step launched flash_attention/wkv6_chunk: {ran.launches}")
    step_ms = [1e3 * (t1 - t0_) for t0_, t1 in zip(stamps, stamps[1:])]
    ms = statistics.median(step_ms)
    n_params = lm.param_count(params)
    prefill = steps.make_prefill_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    with counting(kernels) as ranp, torch.no_grad():
        last, _ = prefill(params, {"tokens": toks})
    add(ranp)
    check(ranp.launches["flash_attention"] == cfg.num_layers and ranp.routes[
        "flash_attention"] == {"wgmma": cfg.num_layers, "generic": 0},
          f"(a) prefill on the trained weights: flash_attention {ranp.routes['flash_attention']}")
    check(bool(torch.isfinite(last.float()).all()), "(a) prefill logits not finite")
    report["a"] = dict(params=n_params, losses=losses, ms_per_step=ms, step_ms=step_ms,
                       tokens_per_s=tokens / (ms / 1e3), peak_gb=peak, wall_s=wall,
                       launches=ran.launches)
    print(f"(a) {cfg.name} ({cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters, "
          f"{cfg.dtype}) launch.train.train, AdamW, {TRAIN_STEPS} steps of {b} x {s} tokens: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.1f} ms a step (median of steps 2-"
          f"{TRAIN_STEPS}), {tokens / (ms / 1e3):.0f} tokens/s, peak {peak:.2f} GB; every "
          f"parameter a nonzero gradient every step, no flash_attention launch in a step; the "
          f"prefill after: {cfg.num_layers} flash_attention launches, all wgmma")
    del params, opt, last, toks, seen
    torch.cuda.empty_cache()

    # (a) resume: a depth cut, checkpoints at steps 5 and 10
    rcfg = dataclasses.replace(cfg, num_layers=TRAIN_RESUME_LAYERS)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build, prefix="train_"))
    try:
        kw = dict(arch=TRAIN_ARCH, cfg=rcfg, steps=TRAIN_STEPS, seq_len=s, global_batch=b,
                  log_every=TRAIN_STEPS, device=dev, seed=args.seed, ckpt_every=TRAIN_RESUME_AT)
        with counting(kernels) as ran:
            pa, oa, ha = train_mod.train(ckpt_dir=str(tmp / "a"), **kw)
        add(ran)
        steps_a = train_mod.CheckpointStore(tmp / "a").steps()
        check(steps_a == [TRAIN_RESUME_AT, TRAIN_STEPS], f"(a) checkpoint steps {steps_a}")
        shutil.copytree(tmp / "a" / f"step_{TRAIN_RESUME_AT:08d}",
                        tmp / "b" / f"step_{TRAIN_RESUME_AT:08d}")
        t0 = time.perf_counter()
        with counting(kernels) as ran:
            pb, ob, hb = train_mod.train(ckpt_dir=str(tmp / "b"), **kw)
        add(ran)
        resume_wall = time.perf_counter() - t0
        same = (all(torch.equal(x, y) for x, y in zip(tree_leaves(pa), tree_leaves(pb)))
                and all(torch.equal(x, y) for x, y in zip(tree_leaves(oa), tree_leaves(ob))))
        check(same and hb[-1] == ha[-1],
              f"(a) the run resumed at step {TRAIN_RESUME_AT} is not the uninterrupted run's "
              f"bits (loss {hb[-1]} against {ha[-1]})")
        nbytes = step_bytes(tmp / "a", TRAIN_RESUME_AT)
        report["a"].update(resume_layers=TRAIN_RESUME_LAYERS, resume_step_bytes=nbytes,
                           resume_wall_s=resume_wall)
        print(f"(a) resume at a depth cut of {TRAIN_RESUME_LAYERS} of {cfg.num_layers} layers "
              f"(full width): checkpoints {steps_a} ({nbytes} bytes a step), resumed at "
              f"{TRAIN_RESUME_AT} and run to {TRAIN_STEPS} in {resume_wall:.1f} s: params and "
              f"AdamW state the uninterrupted run's bits")
        del pa, oa, pb, ob
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) the hybrid head on codeqwen1.5-7b at full width, a depth cut
    hcfg = dataclasses.replace(get_config(HYBRID_ARCH), num_layers=HYBRID_LAYERS)
    params = lm.init_params(hcfg, gen)
    n_params = lm.param_count(params)
    stream = data.SyntheticLMStream(hcfg, ShapeSpec("hybrid", "train", s, b))
    step = hybrid.make_hybrid_train_step(hcfg, mu=HYBRID_MU, power_iters=HYBRID_ITERS)
    state = hybrid.init(params)
    rec = {}
    orig_pm, orig_r1 = hybrid.power_method_dense, hybrid.r1_ops

    def watched_pm(a, v0, k):
        rec["start"] = torch.cuda.Event(enable_timing=True)
        rec["start"].record()
        res = orig_pm(a, v0, k)
        rec.update(res=res, g=a if rec.get("keep") else None, v0=v0)
        return res

    def watched_r1(z, x, y, a_, b_, out=None):
        got = orig_r1.rank1_update(z, x, y, a_, b_, out=out)
        rec["end"] = torch.cuda.Event(enable_timing=True)
        rec["end"].record()
        rec["ab"] = (a_, b_)
        return got

    hybrid.power_method_dense = watched_pm
    hybrid.r1_ops = types.SimpleNamespace(rank1_update=watched_r1)
    hl, head_ms, hstep_ms, sigma = [], [], [], []
    try:
        d, v = params["unembed"].shape
        with grad_watch(torch, lm) as seen:
            for t in range(HYBRID_STEPS):
                rec["keep"] = t == HYBRID_CHECK_STEP
                before = params["unembed"].clone() if rec["keep"] else None
                if t == HYBRID_CHECK_STEP + 1:
                    torch.cuda.reset_peak_memory_stats()
                batch = data.device_put_batch(stream.batch_for_step(t), dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with counting(kernels) as ran:
                    params, state, m = step(params, state, batch, args.seed)
                hstep_ms.append(1e3 * (time.perf_counter() - t0))
                add(ran)
                head_ms.append(rec["start"].elapsed_time(rec["end"]))
                hl.append(float(m["loss"]))
                sigma.append(float(m["fw_sigma"]))
                check(math.isfinite(hl[-1]), f"(b) step {t}: loss {hl[-1]}")
                check(ran.launches["matvec"] == HYBRID_ITERS and ran.launches["rmatvec"]
                      == HYBRID_ITERS and ran.routes["rank1_update"] == {"f32": 0, "bf16": 1},
                      f"(b) step {t}: launches {ran.launches}, rank1 routes "
                      f"{ran.routes['rank1_update']}")
                check(ran.launches["flash_attention"] == 0, "(b) flash_attention in a step")
                w = params["unembed"]
                if t == 0:  # gamma = 1: the head is -mu u v^T rounded to bf16
                    res = rec["res"]
                    wf = torch.outer(res.u, res.v).mul_(-float(np.float32(HYBRID_MU)))
                    err_f = float(torch.linalg.vector_norm(w.float() - wf))
                    del wf
                    nu = float(torch.linalg.vector_norm(res.u) * torch.linalg.vector_norm(res.v))
                    tn = trace_norm_f64(torch, w)
                    bound = HYBRID_MU * nu + math.sqrt(min(d, v)) * err_f
                    prior = HYBRID_MU * (1 + math.sqrt(min(d, v)) * 2 ** -8)
                    check(tn <= bound, f"(b) trace norm {tn} after step 1 above mu |u| |v| + "
                          f"sqrt(min(d, V)) ||E||_F = {bound}")
                    report["b_trace"] = dict(trace_norm=tn, bound=bound, prior_bound=prior,
                                             rounding_fro=err_f)
                    print(f"(b) after step 1 (gamma = 1): ||W||_* = {tn:.4f}, mu = {HYBRID_MU}; "
                          f"bound mu |u| |v| + sqrt(min(d, V)) ||E||_F = {bound:.4f} (E the "
                          f"head's bf16 rounding, ||E||_F = {err_f:.4g}; a priori mu (1 + "
                          f"sqrt(min(d, V)) 2^-8) = {prior:.2f})")
                if t == HYBRID_CHECK_STEP:
                    g, v0, res = rec.pop("g"), rec["v0"], rec["res"]
                    gam = np.float32(2.0) / np.float32(t + 2)
                    a_, c_ = float(np.float32(1.0) - gam), float(gam * np.float32(HYBRID_MU))
                    check(rec["ab"] == (a_, -c_), f"(b) scalars {rec['ab']} != {(a_, -c_)}")
                    # the update alone: the step's own u, v through the plain chain
                    same = (a_ * before.float() - c_ * torch.outer(res.u, res.v)).bfloat16()
                    check(torch.equal(w, same), "(b) the head update is not the plain chain's "
                          "bits on the step's own u and v")
                    del same
                    # the whole chain: torch.mv power iterations on the same gradient and v0
                    pres, _ = power_method.power_iterations(
                        lambda x: pm.ref.matvec(g, x), lambda x: pm.ref.rmatvec(g, x), v0,
                        HYBRID_ITERS)
                    uv_err = max(float(torch.max(torch.abs(res.u - pres.u))),
                                 float(torch.max(torch.abs(res.v - pres.v))))
                    term = c_ * torch.outer(pres.u, pres.v)
                    want = (a_ * before.float() - term).bfloat16()
                    # one bf16 ulp at the scale of the update's terms: where they cancel,
                    # the two chains' u v^T (a few f32 ulps apart) round apart
                    scale = term.abs_().add_(before.float().abs_().mul_(a_))
                    excess = float(torch.max((w.float() - want.float()).abs_() - scale.mul_(
                        2.0 ** -7)))
                    del term, scale
                    ulps = bf16_ulps(torch, w, want)
                    frac = float((w != want).float().mean())
                    check(excess <= 0, f"(b) step {t + 1}'s head departs from the plain chain "
                          f"by more than one bf16 ulp of its terms ({excess:.3g} over)")
                    report["b_chain"] = dict(step=t + 1, ulps_elementwise=ulps, differing=frac,
                                             uv_max_abs_diff=uv_err)
                    print(f"(b) step {t + 1}'s head update: the plain chain's bits on the "
                          f"step's own u, v; against the whole plain chain (torch.mv power "
                          f"iterations on the same f32 gradient and v0, u and v within "
                          f"{uv_err:.2e}, then ((1 - gamma) W - gamma mu u v^T) in f32 "
                          f"rounded to bf16) within one bf16 ulp of the terms, {frac:.2e} of "
                          f"the entries differing (at most {ulps} ulps of the result where "
                          f"the terms cancel)")
                    del g, want, before, pres
                    torch.cuda.empty_cache()
        bad = zero_grad_leaves(torch, seen, leaf_names(params))
        check(not bad, f"(b) {len(bad)} parameters got a zero gradient, e.g. {bad[:5]}")
    finally:
        hybrid.power_method_dense, hybrid.r1_ops = orig_pm, orig_r1
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(hstep_ms[1:])
    hms = statistics.median(head_ms[1:])
    report["b"] = dict(layers=HYBRID_LAYERS, params=n_params, losses=hl, fw_sigma=sigma,
                       step_ms=hstep_ms, ms_per_step=ms, head_ms=head_ms, head_share=hms / ms,
                       tokens_per_s=tokens / (ms / 1e3), peak_gb=peak)
    print(f"(b) {hcfg.name} hybrid (AdamW + DFW-Trace head, mu {HYBRID_MU}, {HYBRID_ITERS} power "
          f"iterations), depth cut {HYBRID_LAYERS} of 32 layers at full width "
          f"({n_params / 1e9:.3f} B parameters, bf16), {HYBRID_STEPS} steps of {b} x {s} tokens: "
          f"loss {hl[0]:.4f} -> {hl[-1]:.4f}, sigma {sigma}; {ms:.1f} ms a step (median of steps "
          f"2-{HYBRID_STEPS}), the head (power method + update) {hms:.2f} ms of it "
          f"({100 * hms / ms:.2f}%), {tokens / (ms / 1e3):.0f} tokens/s, peak {peak:.2f} GB "
          f"(steps {HYBRID_CHECK_STEP + 2}-{HYBRID_STEPS}); each step matvec and rmatvec "
          f"{HYBRID_ITERS} launches, the bf16 rank1_update one")
    del params, state, m, seen, stream
    torch.cuda.empty_cache()

    # (c) rwkv6-7b at full width, a depth cut: AdamW steps
    scfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_TRAIN_LAYERS)
    params = lm.init_params(scfg, gen)
    n_params = lm.param_count(params)
    opt = adamw.init(params)
    sstep = steps.make_train_step(scfg)
    stream = data.SyntheticLMStream(scfg, ShapeSpec("ssm", "train", s, b))
    sl, sms = [], []
    torch.cuda.reset_peak_memory_stats()
    with grad_watch(torch, lm) as seen:
        for t in range(SSM_TRAIN_STEPS):
            batch = data.device_put_batch(stream.batch_for_step(t), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting(kernels) as ran:
                params, opt, m = sstep(params, opt, batch)
            sms.append(1e3 * (time.perf_counter() - t0))
            add(ran)
            sl.append(float(m["loss"]))
            check(math.isfinite(sl[-1]), f"(c) step {t}: loss {sl[-1]}")
            check(ran.launches["wkv6_chunk"] == 0, f"(c) wkv6_chunk launched: {ran.launches}")
    bad = zero_grad_leaves(torch, seen, leaf_names(params))
    check(not bad, f"(c) {len(bad)} parameters got a zero gradient, e.g. {bad[:5]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    report["c"] = dict(layers=SSM_TRAIN_LAYERS, params=n_params, losses=sl, step_ms=sms,
                       tokens_per_s=tokens / (sms[-1] / 1e3), peak_gb=peak)
    print(f"(c) {scfg.name} AdamW, depth cut {SSM_TRAIN_LAYERS} of 32 layers at full width "
          f"({n_params / 1e9:.3f} B parameters, bf16), {SSM_TRAIN_STEPS} steps of {b} x {s} "
          f"tokens: loss {sl[0]:.4f} -> {sl[-1]:.4f}; {sms[-1]:.1f} ms the second step, "
          f"{tokens / (sms[-1] / 1e3):.0f} tokens/s, peak {peak:.2f} GB; every parameter "
          f"(time mix, channel mix, norms, embed, head) a nonzero gradient, no wkv6_chunk "
          f"launch in a step (the plain chunk form under autograd)")
    del params, opt, m, seen, stream
    torch.cuda.empty_cache()

    # (d) the kernel rows at the hybrid head's shape
    d, v = get_config(HYBRID_ARCH).d_model, get_config(HYBRID_ARCH).vocab_size
    rows_out += head_kernel_rows(torch, pm, r1, dev, gen, d, v, "the hybrid head", "(d)", args.reps,
                                 peaks, main=True)
    report["wall_s"] = time.perf_counter() - t_phase
    report["launches"] = total
    report["bf16_launches"] = bf16_total
    print(f"phase 30 took {report['wall_s']:.1f} s")
    return report, total, bf16_total, rows_out


AUDIO_ARCH = "hubert_xlarge"  # 48 layers, d 1280, 16 heads of 80, gelu, non-causal, frontend 512
AUDIO_SHAPE = (8, 1500)  # utterances x frames: 30 s of audio at HuBERT's 50 frames/s
AUDIO_XCHECK = (2, 300)  # the f32 encoder check against the plain attention path
HYBRID_SERVE_ARCH = "zamba2_2_7b"  # 54 Mamba-2 layers, d 2560; a shared block (32 x 80) x 9
HYBRID_SERVE_SHAPE = (4, 4096)  # prompts x tokens of the prefill
VLM_ARCH = "qwen2_vl_72b"  # d 8192, Hq 64 / Hkv 8, Dh 128, d_ff 29,568, M-RoPE (16, 24, 24)
VLM_LAYERS = 32  # of 80: 61 GB of bf16 weights (the whole model is 145 GB)
VLM_SHAPE = (4, 1024, 1024)  # prompts x (vision embeddings: a 32 x 32 patch grid, text tokens)
VLM_XCHECK = (4, 64, 64)  # the f32 check: layers (24 GB of f32 weights), vision, text
# flash_attention at the three prefills' operands: (label, B, Hq, Hkv, S, Dh, causal), bf16
FAMILY_OPERANDS = (("hubert-xlarge", 8, 16, 16, 1500, 80, False),
                   ("zamba2-2.7b", 4, 32, 32, 4096, 80, True),
                   ("qwen2-vl-72b", 4, 64, 8, 2048, 128, True))
PHASE31_HELD_GB = 2.0  # what earlier phases may still hold on the card when it starts


def vlm_inputs(torch, gen, dev, cfg, b, sv, st):
    """Qwen2-VL's prefill inputs: sv vision embeddings (a square grid of
    patches; N(0, 1) times d^-0.5, the token embeddings' scale, in the model
    dtype) ahead of st random tokens; M-RoPE positions (0, row, column) for
    the patches and, for the text, from the grid's side on in all three
    streams."""
    side = math.isqrt(sv)
    idx = torch.arange(sv, device=dev)
    grid = torch.stack([torch.zeros_like(idx), idx // side, idx % side])
    text = (side + torch.arange(st, device=dev)).expand(3, st)
    vision = torch.randn(b, sv, cfg.d_model, generator=gen, device=dev) * cfg.d_model ** -0.5
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, st), generator=gen, device=dev),
            "vision_embeds": vision.to(cfg.torch_dtype),
            "positions": torch.cat([grid, text], 1).expand(b, 3, sv + st).contiguous()}


def family_prefill(torch, kernels, lm, steps, cfg, params, batch, label, tokens, attn_layers,
                   route):
    """One family's main path: ``make_prefill_step`` with the counters from 0
    (read on the device), then three more runs for the time. Returns (the
    report, its launches, the first run's (logits, cache))."""
    step = steps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting(kernels) as ran:
        out = step(params, batch)
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = ran.launches
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = attn_layers
    check(launches == want, f"{label} prefill: launches {launches} != {want}")
    check(kernels.launches() == launches,
          f"{label} prefill: wrapper calls {kernels.launches()} != the device's {launches}")
    routes = ran.routes["flash_attention"]
    check(routes[route] == attn_layers, f"{label} prefill: flash_attention routes {routes}, "
          f"expected all {attn_layers} on {route}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del again
    med = statistics.median(times)
    rep = dict(arch=cfg.name, layers=cfg.num_layers, params=lm.param_count(params),
               first_ms=first_ms, ms=[1e3 * t for t in times], ms_median=1e3 * med,
               tokens=tokens, tokens_per_s=tokens / med, peak_gb=peak_gb, routes=routes,
               launches=launches)
    print(f"prefill {label} ({cfg.num_layers} layers, {rep['params']} parameters, {cfg.dtype}) "
          f"on {tokens} positions: median {rep['ms_median']:.1f} ms ({rep['tokens_per_s']:.0f} "
          f"a second; first {first_ms:.1f} ms), peak {peak_gb:.2f} GB, {attn_layers} "
          f"flash_attention launches, all on {route}")
    return rep, launches, out


ROUTING_KERNELS = ("sort", "scatter", "gather", "index", "bincount")  # the moe dispatch's kinds


def kind_profile(torch, run, routing=False):
    """Device time by kind of one call of ``run`` (torch.profiler): flash
    (the two flash routes), GEMMs (cuBLAS and CUTLASS kernels by name), the
    rest (elementwise, reductions, copies); with ``routing`` the moe
    family's routing and dispatch apart from the rest (sorts, gathers,
    scatters, index kernels by name: the stable top-k sorts, the token
    gather, the combine; the embedding lookup's index kernel too); wall
    time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    del out
    kinds = dict(flash=0.0, gemm=0.0, other=0.0, **({"routing": 0.0} if routing else {}))
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        name = ev.key.lower()
        kind = ("flash" if any(f in ev.key for f in FLASH_KERNELS) else "gemm"
                if any(g in name for g in ("gemm", "nvjet", "xmma", "cutlass", "cublas"))
                else "routing" if routing and any(r in name for r in ROUTING_KERNELS)
                else "other")
        kinds[kind] += ev.self_device_time_total
    busy = sum(kinds.values())
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                idle_share=1.0 - busy / wall_us if busy else None,
                **{f"{k}_ms": v / 1e3 for k, v in kinds.items()}), busy


def print_kinds(label, row):
    if not row["busy_ms"]:
        print(f"profile {label}: the profiler recorded no device time (not measured)")
        return
    routing = (f", routing and dispatch {row['routing_ms']:.1f}" if "routing_ms" in row else "")
    print(f"profile {label}: wall {row['wall_ms']:.1f} ms, device busy {row['busy_ms']:.1f} ms "
          f"(flash_attention {row['flash_ms']:.1f}, GEMMs {row['gemm_ms']:.1f}{routing}, other "
          f"{row['other_ms']:.1f}), idle share {row['idle_share']:.3f}")


def families_phase(torch, np, kernels, lm, steps, lm_serve, fa, mamba2, get_config, dev, args,
                   peaks):
    """Phase 31 (see the module doc). Returns (report, summed launches of
    its main paths, its kernel rows)."""
    import gc

    report, rows_out = {}, []
    t_phase = time.perf_counter()
    before_gc = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    report["held_gb"] = [before_gc, held]
    print(f"phase 31 starts with {before_gc:.2f} GB allocated ({held:.2f} GB after a garbage "
          "collection)")
    check(held < PHASE31_HELD_GB, f"phase 31: earlier phases still hold {held:.2f} GB on the "
          f"card (limit {PHASE31_HELD_GB})")
    total = dict.fromkeys(kernels.launches(), 0)

    def add(launches):
        for k_, v_ in launches.items():
            total[k_] += v_

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    # (a) hubert-xlarge, the encoder step
    cfg = get_config(AUDIO_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    b, s = AUDIO_SHAPE
    frames = torch.randn(b, s, cfg.frontend_dim, generator=gen, device=dev)
    rep, launches, (logits, cache) = family_prefill(
        torch, kernels, lm, steps, cfg, params, {"frames": frames},
        "hubert-xlarge (encoder step)", b * s, cfg.num_layers, "generic")
    add(launches)
    rep["init_s"] = time.perf_counter() - t0
    check(cache is None, "hubert: the encoder step returned a cache")
    check(tuple(logits.shape) == (b, s, cfg.vocab_size),
          f"hubert logits {tuple(logits.shape)} != {(b, s, cfg.vocab_size)}")
    check(bool(torch.isfinite(logits).all()), "hubert: non-finite logits")
    rep["frames_per_s"] = rep.pop("tokens_per_s")
    del logits, frames
    # f32 at full width: the encoder through the kernel against the plain
    # attention (autograd records through the frames: layers.attention then
    # takes the reference's differentiable path)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_to(torch, params, torch.float32)
    x = torch.randn(*AUDIO_XCHECK, cfg.frontend_dim, generator=gen, device=dev)
    with counting(kernels) as ran:
        kern = lm.forward(p32, {"frames": x}, cfg32, mode="train")["logits"]
    check(ran.launches["flash_attention"] == cfg.num_layers,
          f"hubert f32: {ran.launches['flash_attention']} flash launches")
    with counting(kernels) as ran, torch.enable_grad():
        plain = lm.forward(p32, {"frames": x.clone().requires_grad_(True)}, cfg32,
                           mode="train")["logits"].detach()
    check(ran.launches["flash_attention"] == 0, "hubert f32: the plain path launched the kernel")
    rep["f32_rel_err"] = rel_err(torch, kern, plain)[1]
    check(rep["f32_rel_err"] <= TOL["lm_f32"],
          f"hubert f32: encoder with the kernel vs the plain attention rel err "
          f"{rep['f32_rel_err']:.3e} > {TOL['lm_f32']:.0e}")
    if args.profile:
        rep["profile"], _ = kind_profile(torch, lambda: steps.make_prefill_step(cfg)(
            params, {"frames": torch.randn(b, s, cfg.frontend_dim, generator=gen, device=dev)}))
        print_kinds("hubert-xlarge encoder step", rep["profile"])
    print(f"hubert-xlarge: {rep['frames_per_s']:.0f} frames/s; f32 encoder (kernel) against "
          f"the plain attention on {AUDIO_XCHECK[0]} x {AUDIO_XCHECK[1]} frames: rel err "
          f"{rep['f32_rel_err']:.2e} (tolerance {TOL['lm_f32']:.0e})")
    report["audio"] = rep
    del params, p32, kern, plain, x
    free()

    # (b) zamba2-2.7b: prefill, captured decode, prefill against decode
    cfg = get_config(HYBRID_SERVE_ARCH)
    nb = cfg.num_layers // cfg.hybrid_block
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    b, s = HYBRID_SERVE_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    rep, launches, (last, cache) = family_prefill(
        torch, kernels, lm, steps, cfg, params, {"tokens": toks}, "zamba2-2.7b", b * s, nb,
        "generic")
    add(launches)
    rep["init_s"] = time.perf_counter() - t0
    d_inner, nh, hd, n = mamba2.dims(cfg)
    kv = (nb, b, cfg.num_kv_heads, s, cfg.head_dim_)
    shapes = {"k": (kv, cfg.torch_dtype), "v": (kv, cfg.torch_dtype),
              "mamba_h": ((cfg.num_layers, b, nh, hd, n), torch.float32),
              "mamba_conv": ((cfg.num_layers, b, cfg.d_conv - 1, d_inner + 2 * n),
                             cfg.torch_dtype)}
    check(tuple(last.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(last).all()),
          f"zamba2: last logits {tuple(last.shape)} not finite or not {(b, cfg.vocab_size)}")
    for name, (shape, dt) in shapes.items():
        check(tuple(cache[name].shape) == shape and cache[name].dtype == dt,
              f"zamba2 cache {name} {tuple(cache[name].shape)} {cache[name].dtype} != {shape} "
              f"{dt}")
        check(bool(torch.isfinite(cache[name]).all()), f"zamba2: non-finite cache {name}")
    del last, cache
    if args.profile:
        rep["profile"], _ = kind_profile(torch, lambda: steps.make_prefill_step(cfg)(
            params, {"tokens": toks}))
        print_kinds("zamba2-2.7b prefill", rep["profile"])
    del toks
    rep["decode"], launches = captured_decode(
        torch, np, kernels, lm, steps, lm_serve, HYBRID_SERVE_ARCH, cfg, params, dev, args.seed,
        "zamba2 decode", "flash_attention")
    add(launches)
    if args.profile:
        dstats = {}
        row, busy = kind_profile(torch, lambda: lm_serve.generate(
            arch=HYBRID_SERVE_ARCH, smoke=False, batch=DECODE_BATCH, prompt_len=8,
            max_new_tokens=8, seed=args.seed, device=dev, params=params, stats=dstats))
        decode_idle(row, dstats, busy)
        rep["decode_profile"] = row
    # prefill against decode on 4 x 64 tokens (one chunk of 64), f32 (an f32
    # copy of the weights) and bf16: the last logits and every cache
    xtoks = torch.randint(0, cfg.vocab_size, (4, DECODE_PROMPT), generator=gen, device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_to(torch, params, torch.float32)
    kernels.reset_launches()
    (pre32, pc32), (dec32, dc32) = prefill_and_decode(torch, lm, steps, cfg32, p32, xtoks)
    check(kernels.launches()["flash_attention"] == nb,
          "zamba2 f32 prefill did not launch the flash kernel once a shared block")
    del p32
    free()
    (pre16, pc16), (dec16, dc16) = prefill_and_decode(torch, lm, steps, cfg, params, xtoks)

    def worst(a, b):  # each layer's (or shared block's) entry to its own max
        return max(rel_err(torch, a[i].float(), b[i].float())[1] for i in range(a.shape[0]))

    rep.update(f32_rel_err=rel_err(torch, pre32, dec32)[1],
               f32_cache_rel_err={k_: worst(pc32[k_], dc32[k_]) for k_ in pc32},
               bf16_rel_err=rel_err(torch, pre16, dec16)[1],
               bf16_first_rel_err={k_: rel_err(torch, pc16[k_][0].float(),
                                                dc16[k_][0].float())[1] for k_ in pc16},
               bf16_decode_vs_f32=rel_err(torch, dec16, dec32)[1],
               bf16_prefill_vs_f32=rel_err(torch, pre16, pre32)[1])
    f32_worst = max(rep["f32_rel_err"], *rep["f32_cache_rel_err"].values())
    first = max(rep["bf16_first_rel_err"].values())

    def fmt(d):
        return ", ".join(f"{k_} {v_:.2e}" for k_, v_ in d.items())

    print(f"zamba2-2.7b prefill vs decode at full width, 4 x {DECODE_PROMPT} tokens: f32 logits "
          f"rel err {rep['f32_rel_err']:.2e}, caches {fmt(rep['f32_cache_rel_err'])} (tolerance "
          f"{TOL['lm_f32']:.0e}); bf16 logits {rep['bf16_rel_err']:.2e} (the dense family's "
          f"{TOL['lm_bf16']:.0e} {'met' if rep['bf16_rel_err'] <= TOL['lm_bf16'] else 'not met'}"
          f"; bf16 prefill from f32 {rep['bf16_prefill_vs_f32']:.2e}, bf16 decode from f32 "
          f"{rep['bf16_decode_vs_f32']:.2e}: not held, bf16 rounding through 63 blocks of a "
          f"random-init model), layer 0 and the first shared block's caches "
          f"{fmt(rep['bf16_first_rel_err'])} (tolerance {TOL['lm_bf16']:.0e})")
    check(f32_worst <= TOL["lm_f32"],
          f"zamba2 f32: prefill vs decode rel err {f32_worst:.3e} > {TOL['lm_f32']:.0e}")
    check(first <= TOL["lm_bf16"],
          f"zamba2 bf16: layer 0's caches differ between prefill and decode by {first:.3e}")
    del pre32, pc32, dec32, dc32, pre16, pc16, dec16, dc16
    report["hybrid"] = rep
    del params, xtoks
    free()

    # (c) qwen2-vl-72b: first the f32 check at a depth of VLM_XCHECK[0], then
    # the main path at VLM_LAYERS of 80 layers
    nl, sv, st = VLM_XCHECK
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=nl, dtype="float32")
    params = lm.init_params(cfg, gen)
    full = vlm_inputs(torch, gen, dev, cfg, 2, sv, st)
    want = lm.forward(params, full, cfg, mode="train")["logits"][:, -1]
    prompt = dict(full, tokens=full["tokens"][:, :-1], positions=full["positions"][:, :, :-1])
    last, cache = steps.make_prefill_step(cfg)(params, prompt)
    cache = {k_: torch.nn.functional.pad(v_, (0, 0, 0, 1)).contiguous()
             for k_, v_ in cache.items()}
    logits, _ = lm.decode_step(params, cache, {
        "tokens": full["tokens"][:, -1:], "cache_pos": sv + st - 1,
        "positions": full["positions"][:, :, -1:]}, cfg)
    vlm_f32 = rel_err(torch, logits[:, 0], want)[1]
    print(f"qwen2-vl-72b f32 at {nl} layers, 2 x ({sv} vision + {st} text): the prefill's cache "
          f"and one decode step against the full forward's last logits: rel err {vlm_f32:.2e} "
          f"(tolerance {TOL['lm_f32']:.0e})")
    check(vlm_f32 <= TOL["lm_f32"], f"qwen2-vl f32: decode after prefill rel err {vlm_f32:.3e}")
    del params, full, want, prompt, last, cache, logits
    free()
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    b, sv, st = VLM_SHAPE
    batch = vlm_inputs(torch, gen, dev, cfg, b, sv, st)
    rep, launches, (last, cache) = family_prefill(
        torch, kernels, lm, steps, cfg, params, batch,
        f"qwen2-vl-72b ({VLM_LAYERS} of 80 layers)", b * (sv + st), VLM_LAYERS, "wgmma")
    add(launches)
    rep.update(init_s=time.perf_counter() - t0, f32_rel_err=vlm_f32, cut_layers=VLM_LAYERS)
    kv = (VLM_LAYERS, b, cfg.num_kv_heads, sv + st, cfg.head_dim_)
    check(tuple(last.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(last).all()),
          f"qwen2-vl: last logits {tuple(last.shape)} not finite or not {(b, cfg.vocab_size)}")
    check(tuple(cache["k"].shape) == kv and tuple(cache["v"].shape) == kv,
          f"qwen2-vl cache {tuple(cache['k'].shape)} != {kv}")
    del last, cache
    if args.profile:
        rep["profile"], _ = kind_profile(
            torch, lambda: steps.make_prefill_step(cfg)(params, batch))
        print_kinds("qwen2-vl-72b prefill", rep["profile"])
    del batch
    free()
    # generate takes the published config (80 layers): its cache holds 80
    # layers, of which decode writes the 32 the weights have
    rep["decode"], launches = captured_decode(
        torch, np, kernels, lm, steps, lm_serve, VLM_ARCH, get_config(VLM_ARCH), params, dev,
        args.seed, "qwen2-vl decode", "flash_attention")
    add(launches)
    if args.profile:
        dstats = {}
        row, busy = kind_profile(torch, lambda: lm_serve.generate(
            arch=VLM_ARCH, smoke=False, batch=DECODE_BATCH, prompt_len=8, max_new_tokens=8,
            seed=args.seed, device=dev, params=params, stats=dstats))
        decode_idle(row, dstats, busy)
        rep["decode_profile"] = row
    report["vlm"] = rep
    del params
    free()

    # (d) flash_attention at the three families' operands
    bf16 = torch.bfloat16
    for label, b, hq, hkv, s, dh, causal in FAMILY_OPERANDS:
        q, k, v = [torch.randn(b, h, s, dh, generator=gen, device=dev).to(bf16)
                   for h in (hq, hkv, hkv)]
        rows_out.append(flash_row(torch, fa, kernels, label, q, k, v, causal, args.reps, peaks))
        del q, k, v
        free()

    report["wall_s"] = time.perf_counter() - t_phase
    report["launches"] = total
    print(f"phase 31 took {report['wall_s']:.1f} s")
    return report, total, rows_out


MOE_ARCTIC = "arctic_480b"  # d 7168, Hq 56 / Hkv 8 of 128, 128 experts (top-2) of 4864, dense residual
MOE_ARCTIC_LAYERS = 2  # of 35: 27.2 GB a layer (26.8 of experts); 3 would be 82.6 GB with the embeddings
MOE_SCOUT = "llama4_scout_17b_a16e"  # d 5120, Hq 40 / Hkv 8 of 128, 16 experts (top-1) of 8192
MOE_SCOUT_LAYERS = 16  # of 48: 4.16 GB a layer + 4.14 GB of embeddings + 3.3 GB of prefill logits;
# the prefill peaks near 74.6 GB alone; at 17 (78.8 alone) it ran out of the card's memory
# after the earlier phases (1.16 GB still held, 3.9 GiB reserved but unallocated)
MOE_SHAPE = (4, 2048)  # prompts x tokens of both prefills: n = 8192 routed tokens
MOE_XCHECK = ((128, 2), (16, 1))  # (E, k) of the card-against-CPU check: arctic's, llama4-scout's
MOE_XCHECK_WIDTH = (1024, 512)  # (D, F) of that check; n = 8192 tokens
MOE_FLIP_GAP = 1e-6  # a routing may differ only where a k-th/(k+1)-th probability gap is below
# flash_attention at the moe prefills' operands: (label, B, Hq, Hkv, S, Dh, causal), bf16
MOE_OPERANDS = (("arctic-480b", 4, 56, 8, 2048, 128, True),
                ("llama4-scout-17b-a16e", 4, 40, 8, 2048, 128, True))
PHASE32_HELD_GB = 2.0  # what earlier phases may still hold on the card when it starts


@contextlib.contextmanager
def moe_drops(torch, moe):
    """Wrap ``moe.moe_block`` to record, a call a layer, the share of routed
    (token, expert) pairs the capacity drops and the busiest expert's load
    (device tensors, read after the block). Yields the list of records."""
    block, log = moe.moe_block, []

    def recorded(p, x, cfg):
        out = block(p, x, cfg)
        b, s, d = x.shape
        k, e = cfg.experts_per_token, cfg.num_experts
        _, _, eidx = moe.route(x.reshape(b * s, d), p["router"], k)
        cap = moe._capacity(b * s, k, e, cfg.moe_capacity_factor)
        load = torch.bincount(eidx.reshape(-1), minlength=e)
        log.append(((load - cap).clamp(min=0).sum() / (b * s * k), load.max(), cap))
        return out

    moe.moe_block = recorded
    try:
        yield log
    finally:
        moe.moe_block = block


def decode_floor_ms(params, batch: int, bw: float) -> float:
    """The least time of a decode step: every weight read once (the
    embedding's ``batch`` rows only) at the memory rate. A moe step reads
    every expert, since each runs its MLP on its B slots."""
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    emb = params["embed"]
    total = nbytes(params) - nbytes(emb) + batch * emb.shape[1] * emb.element_size()
    return 1e3 * total / bw


def moe_model(torch, np, kernels, lm, steps, lm_serve, moe, get_config, dev, gen, args, peaks,
              arch, layers):
    """One moe configuration at full width, cut to ``layers``: prefill
    MOE_SHAPE (its launches, ms, tokens/s, peak memory), each layer's
    dropped share, the captured decode against the step loop, its floor.
    Returns (report, launches of its main paths)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    label = f"{full.name} ({layers} of {full.num_layers} layers)"
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    b, s = MOE_SHAPE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)}
    rep, launches, (last, cache) = family_prefill(
        torch, kernels, lm, steps, cfg, params, batch, label, b * s, layers, "wgmma")
    total = dict(launches)
    rep.update(init_s=time.perf_counter() - t0, cut_layers=layers, published_layers=full.num_layers)
    kv = (layers, b, cfg.num_kv_heads, s, cfg.head_dim_)
    check(tuple(last.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(last).all()),
          f"{label}: last logits {tuple(last.shape)} not finite or not {(b, cfg.vocab_size)}")
    check(tuple(cache["k"].shape) == kv and tuple(cache["v"].shape) == kv,
          f"{label}: cache {tuple(cache['k'].shape)} != {kv}")
    del last, cache
    with moe_drops(torch, moe) as log:
        out = lm.forward(params, batch, cfg, mode="hidden")
        aux = float(out["aux_loss"])
    del out
    rep.update(dropped_share=[float(r[0]) for r in log], busiest_load=[int(r[1]) for r in log],
               capacity=log[0][2], aux_loss=aux)
    check(len(log) == layers and math.isfinite(aux) and aux > 0,
          f"{label}: {len(log)} moe layers recorded, aux loss {aux}")
    print(f"{label}: capacity {rep['capacity']} slots an expert for {b * s} tokens; dropped share "
          f"of routed (token, expert) pairs by layer {[f'{x:.4f}' for x in rep['dropped_share']]}, "
          f"busiest expert's load {rep['busiest_load']}; aux loss (the layers' sum) {aux:.4f}")
    if args.profile:
        rep["profile"], _ = kind_profile(
            torch, lambda: steps.make_prefill_step(cfg)(params, batch), routing=True)
        print_kinds(f"{label} prefill", rep["profile"])
    del batch
    torch.cuda.empty_cache()
    # generate takes the published config: its cache holds every layer, of
    # which decode writes the ones the weights have
    rep["decode"], launches = captured_decode(
        torch, np, kernels, lm, steps, lm_serve, arch, full, params, dev, args.seed,
        f"{full.name} decode", "flash_attention")
    for k_, v_ in launches.items():
        total[k_] += v_
    floor = decode_floor_ms(params, DECODE_BATCH, peaks[0])
    rep["decode"]["floor_ms"] = floor
    print(f"{label} decode: {rep['decode']['ms_per_token']:.3f} ms a step captured, "
          f"{rep['decode']['uncaptured_ms_per_step']:.3f} uncaptured, against a floor of "
          f"{floor:.3f} ms (every weight read once at the memory rate; each expert runs its MLP "
          f"on its {DECODE_BATCH} slots, none dropped)")
    if args.profile:
        dstats = {}
        row, busy = kind_profile(torch, lambda: lm_serve.generate(
            arch=arch, smoke=False, batch=DECODE_BATCH, prompt_len=8, max_new_tokens=8,
            seed=args.seed, device=dev, params=params, stats=dstats), routing=True)
        decode_idle(row, dstats, busy)
        rep["decode_profile"] = row
    del params
    return rep, total


def moe_crosscheck(torch, moe, dev, seed, e, k):
    """``moe_block`` in f32 on the card against the CPU at MOE_XCHECK_WIDTH,
    8192 tokens, router column 0 times 3 (so expert 0's tokens overflow its
    capacity). Each token's picks must be the CPU's, unless they differ at
    a k-th/(k+1)-th probability gap under MOE_FLIP_GAP (the token is named
    otherwise; a flipped token's experts are then left out). Each expert's
    capacity selection must be the CPU's slot for slot, unless a slot holds
    on the card a token whose gate on the CPU is within MOE_FLIP_GAP of the
    CPU's token's there: two tokens' near-equal gates, which the two
    softmaxes may order either way by rounding (the slot is named
    otherwise). The output within 1e-5 of max|CPU| on the tokens whose
    experts kept them on both sides, aux within rtol 1e-6; the card's bits
    on repeat. Returns its report."""
    d, f = MOE_XCHECK_WIDTH
    g = torch.Generator().manual_seed(seed + e)
    skew = torch.ones(e)
    skew[0] = 3.0
    p = {"router": torch.randn(d, e, generator=g) * d**-0.5 * skew,
         "wg": torch.randn(e, d, f, generator=g) * d**-0.5,
         "wu": torch.randn(e, d, f, generator=g) * d**-0.5,
         "wd": torch.randn(e, f, d, generator=g) * f**-0.5}
    x = torch.randn(*MOE_SHAPE, d, generator=g)
    cfg = argparse.Namespace(experts_per_token=k, num_experts=e, moe_capacity_factor=1.25)
    n = x.shape[0] * x.shape[1]
    cap = moe._capacity(n, k, e, 1.25)
    dp = {name: t.to(dev) for name, t in p.items()}
    xd = x.to(dev)
    out, aux = moe.moe_block(dp, xd, cfg)
    again, again_aux = moe.moe_block(dp, xd, cfg)
    same = bool(torch.equal(again, out)) and bool(torch.equal(again_aux, aux))
    want, want_aux = moe.moe_block(p, x, cfg)
    probs, gate, eidx = moe.route(x.reshape(n, d), p["router"], k)
    sel_gate, sel = moe.select(gate, eidx, e, 0, cap)
    _, dgate, deidx = moe.route(xd.reshape(n, d), dp["router"], k)
    dsel_gate, dsel = moe.select(dgate, deidx, e, 0, cap)
    deidx, dsel, dsel_gate = deidx.cpu(), dsel.cpu(), dsel_gate.cpu()
    top = torch.sort(probs, dim=-1, descending=True).values
    gaps = (top[:, k - 1] - top[:, k]).double()
    flipped = (deidx != eidx).any(dim=1).nonzero().flatten().tolist()
    for t in flipped:
        check(float(gaps[t]) < MOE_FLIP_GAP,
              f"moe (E {e}, top-{k}) card vs CPU: token {t} routed to {deidx[t].tolist()} on the "
              f"card, {eidx[t].tolist()} on the CPU, at a gap of {float(gaps[t]):.3e}")
    hit = torch.zeros(e, dtype=torch.bool)
    if flipped:
        hit[eidx[flipped].flatten()] = True
        hit[deidx[flipped].flatten()] = True
    # each token's gate on the CPU in each expert's row (-1 where not routed)
    score = torch.where(eidx[None] == torch.arange(e)[:, None, None], gate[None], -1.0).amax(-1)
    moved = (dsel != sel) & ~hit[:, None]
    apart = (score.gather(1, dsel) - sel_gate).abs()
    bad = (moved & (apart >= MOE_FLIP_GAP)).nonzero().tolist()
    if bad:
        ex, sl = bad[0]
        check(False, f"moe (E {e}, top-{k}) card vs CPU: expert {ex} slot {sl} holds token "
              f"{int(dsel[ex, sl])} on the card, {int(sel[ex, sl])} on the CPU, gates "
              f"{float(apart[ex, sl]):.3e} apart ({len(bad)} such slots)")
    kept = torch.zeros(e, n, dtype=torch.bool).scatter_(1, sel, sel_gate > -0.5)
    dkept = torch.zeros(e, n, dtype=torch.bool).scatter_(1, dsel, dsel_gate > -0.5)
    changed = (kept != dkept)[~hit].any(dim=0)  # kept on one side only: a tie at the boundary
    rows = (~hit[eidx].any(dim=1) & ~changed).view(*MOE_SHAPE)
    load = torch.bincount(eidx.flatten(), minlength=e)
    dropped = float((load - cap).clamp(min=0).sum()) / (n * k)
    err = float((out.cpu()[rows] - want[rows]).abs().max() / want.abs().max())
    aux_rel = abs(float(aux) - float(want_aux)) / abs(float(want_aux))
    rep = dict(experts=e, top_k=k, d=d, f=f, tokens=n, capacity=cap, dropped_share=dropped,
               min_gap=float(gaps.min()), min_gap_token=int(gaps.argmin()), flipped=flipped,
               swapped_slots=int(moved.sum()), boundary_tokens=int(changed.sum()),
               max_swap_gap=float(apart[moved].max()) if bool(moved.any()) else 0.0,
               out_rel_err=err, aux_rel_err=aux_rel, bits_repeat=same)
    print(f"moe_block f32 card vs CPU (E {e}, top-{k}, D {d}, F {f}, {n} tokens, capacity {cap}, "
          f"dropped share {dropped:.4f}): picks equal"
          f"{f' but for near-tie tokens {flipped}' if flipped else ''} (smallest k-th/(k+1)-th "
          f"gap {rep['min_gap']:.3e}, token {rep['min_gap_token']}); selections equal slot for "
          f"slot but {rep['swapped_slots']} slots of near-equal gates in another order (at most "
          f"{rep['max_swap_gap']:.3e} apart; {rep['boundary_tokens']} tokens kept on one side "
          f"only); out {err:.2e} of max|CPU| (limit 1e-5), aux rel {aux_rel:.2e} (limit 1e-6); "
          f"card bits repeat: {same}")
    check(dropped > 0, f"moe (E {e}, top-{k}): the check's routing dropped no token")
    check(err <= 1e-5, f"moe (E {e}, top-{k}): out rel err {err:.3e} > 1e-5")
    check(aux_rel <= 1e-6, f"moe (E {e}, top-{k}): aux rel err {aux_rel:.3e} > 1e-6")
    check(same, f"moe (E {e}, top-{k}): a repeated call on the card gave other bits")
    return rep


def moe_phase(torch, np, kernels, lm, steps, lm_serve, fa, moe, get_config, dev, args, peaks):
    """Phase 32 (see the module doc). Returns (report, summed launches of
    its main paths, its kernel rows)."""
    import gc

    report, rows_out = {}, []
    t_phase = time.perf_counter()
    before_gc = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"phase 32 starts with {before_gc:.2f} GB allocated ({held:.2f} GB after a garbage "
          "collection)")
    check(held < PHASE32_HELD_GB, f"phase 32: earlier phases still hold {held:.2f} GB on the "
          f"card (limit {PHASE32_HELD_GB})")
    total = dict.fromkeys(kernels.launches(), 0)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for key, arch, layers in (("arctic", MOE_ARCTIC, MOE_ARCTIC_LAYERS),
                              ("scout", MOE_SCOUT, MOE_SCOUT_LAYERS)):
        report[key], launches = moe_model(torch, np, kernels, lm, steps, lm_serve, moe,
                                          get_config, dev, gen, args, peaks, arch, layers)
        for k_, v_ in launches.items():
            total[k_] += v_
        free()
    report["xcheck"] = [moe_crosscheck(torch, moe, dev, args.seed, e, k)
                        for e, k in MOE_XCHECK]
    free()
    bf16 = torch.bfloat16
    for label, b, hq, hkv, s, dh, causal in MOE_OPERANDS:
        q, k, v = [torch.randn(b, h, s, dh, generator=gen, device=dev).to(bf16)
                   for h in (hq, hkv, hkv)]
        rows_out.append(flash_row(torch, fa, kernels, label, q, k, v, causal, args.reps, peaks))
        del q, k, v
        free()
    report["held_gb"] = [before_gc, held, torch.cuda.memory_allocated() / 1e9]
    report["wall_s"] = time.perf_counter() - t_phase
    report["launches"] = total
    print(f"phase 32 took {report['wall_s']:.1f} s; {report['held_gb'][2]:.2f} GB allocated at "
          "its end")
    return report, total, rows_out


# Phase 33: the sharded LM paths (launch.mesh/sharding/params, comm.spmd)
MESH_SHAPE = (2, 2)  # (data, model): four gloo workers sharing the card
# the depths and sizes below were cut when phase 34 came in, to keep the
# whole script within 15 minutes on the card: (a) (4, 2048), (b) 4 layers
# and 16 batch-1 steps, (c) 2 layers, (d) 2 layers before
MESH_ONE_SHAPE, MESH_STEPS = (2, 2048), 2  # (a) qwen2-1.5b full depth, bf16, one NCCL worker
MESH_DENSE_LAYERS = 2  # (b) qwen2-1.5b at full width, 2 of 28 layers, f32
MESH_TRAIN_SHAPE = (4, 1024)  # (b), (c) train steps
MESH_PREFILL_SHAPE = (4, 2048)  # (b) prefill and the batch-4 decode step after it
MESH_DECODE_ONE = 4  # (b) sequence-sharded decode steps at batch 1
MESH_SSM_LAYERS = 1  # (c) rwkv6-7b at full width, 1 of 32 layers, f32
MESH_MOE_LAYERS = 1  # (d) llama4-scout at full width, 1 of 48 layers, f32
MESH_MOE_SHAPE = (4, 1024)
MESH_NO_DROP = 32.0  # (d) a capacity factor under which no token drops
MESH_MOE_GRAD_LAYERS = 1  # (d) step 0's gradient: llama4-scout, 1 of 48 layers, f32 (16.5 GB)
# f32 sums in other orders: the row-parallel partial products' psum, the
# vocab-parallel head and cross entropy, cuBLAS's kernels for the split
# shapes; two AdamW steps carry them into the second loss
# each worker's blocks against the unsharded run's. The gradient at the
# initial weights on step 0's batch and AdamW's m after the two steps (whose
# gradients are both taken at the initial weights: the schedule's rate is 0
# at step 0), each leaf's max difference over its max, within the larger of
# "grad" and "sensitivity" x that leaf's own spread in this run: the
# unsharded gradient's change when every weight moves by one f32 rounding.
# qwen2's spread is ~6e-6; rwkv6's decay leaves (w_base, w_lora_b) reach
# 4e-2, since the chunk form's exp(+-cumsum) factors at q = 256 amplify any
# rounding of r, k, v, w (tools/torch_grad_spread.py on an H100 80GB HBM3 at
# 700 W). A gradient off by a factor on a
# leaf is off by order 1. The parameters: the one nonzero step moves each
# element by lr_1 |m^ / (sqrt(v^) + eps)| <= 1.0004 lr_1 (b1 0.9, b2 0.95,
# step 2), so the runs differ by at most 2.0004 lr_1 plus one f32 rounding
# of the stored value (under 0.04 lr_1 for |p| < 2): "params_lr"
MESH_TOL = {"loss": 2e-5, "logits": 1e-4, "param_share": 0.26, "grad": 1e-4,
            "sensitivity": 3.0, "params_lr": 2.1}
MESH_ROUNDING = 6e-8  # relative size of the weights' perturbation for the spread
# the kernels on a shard's operands, as the sharded layers build them: q, k,
# v as (B, H, S, Dh) views of the (B, S, H Dh) projections of a worker's
# heads; "slice": the q heads of one kv head of the two a worker computes,
# whose k and v are a head slice of the view (mesh (1, 4))
# (label, B, S, q heads, kv heads computed, kv heads read, dtype, causal)
MESH_FA_OPERANDS = (
    ("qwen2-1.5b (2, 2) shard", 2, 2048, 6, 1, 1, "float32"),
    ("qwen2-1.5b (2, 2) shard", 2, 2048, 6, 1, 1, "bfloat16"),
    ("qwen2-1.5b (1, 4) shard, kv head slice", 4, 2048, 3, 2, 1, "float32"),
    ("qwen2-1.5b (1, 4) shard, kv head slice", 4, 2048, 3, 2, 1, "bfloat16"),
    ("llama4-scout (2, 2) shard", 2, 1024, 20, 4, 4, "float32"),
    ("llama4-scout (2, 2) shard", 2, 1024, 20, 4, 4, "bfloat16"),
)
# rwkv6-7b at (2, 2): 32 of 64 heads, B 2, the second 256-token chunk of
# 1024 as (B, H, q, 64) views of the (B, S, H 64) projections; r/k/v dtype
MESH_WKV_OPERANDS = (("rwkv6-7b (2, 2) shard", 2, 1024, 32, "float32"),
                     ("rwkv6-7b (2, 2) shard", 2, 1024, 32, "bfloat16"))


@contextlib.contextmanager
def moe_per_data_shard(torch, moe, n_data):
    """Inside the block ``moe.moe_block`` runs each of ``n_data`` row blocks
    of its input on its own (its own capacity, its own drops) and returns
    their outputs and the mean of their Switch losses: one device's
    computation of what a mesh of ``n_data`` data shards computes, whose
    gradient the sharded one is held to."""
    block = moe.moe_block

    def per_shard(p, x, cfg):
        n = x.shape[0] // n_data
        parts = [block(p, x[i * n:(i + 1) * n], cfg) for i in range(n_data)]
        return torch.cat([o for o, _ in parts]), sum(a for _, a in parts) / n_data

    moe.moe_block = per_shard
    try:
        yield
    finally:
        moe.moe_block = block


def _leaf_paths(tree, prefix=""):
    """The key paths of a parameter tree's leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _leaf_paths(t, f"{prefix}/{i}")]
    return [prefix]


def _mesh_nbytes(tree):
    from repro_torch.optim.compression import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def mesh_rank(group, device, seed, inputs, parts):
    """One worker of phase 33 (module level: run_workers starts it by name):
    ``parts`` of (b)-(d) on this worker's blocks of a MESH_SHAPE mesh; host
    results."""
    import gc

    import torch

    from repro_torch import kernels
    from repro_torch.launch import mesh as M
    from repro_torch.launch import params as P
    from repro_torch.launch import sharding, steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm, moe
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim.compression import tree_leaves

    mesh = M.make_mesh(MESH_SHAPE, ("data", "model"), group)
    out = {"coords": mesh.coords, "launches": dict.fromkeys(kernels.launches(), 0)}
    cuda = device.type == "cuda"
    n_steps, train_shape = inputs["steps"], inputs["train_shape"]
    prompt, n_one = inputs["b_toks"].shape[1], inputs["b_dec"].shape[0]

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

    def peak_gb():
        return torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None

    def ran_add(ran):
        for k_, v_ in ran.launches.items():
            out["launches"][k_] += v_

    def train_run(cfg, shape, ref_state):
        """The sharded train run: (losses, seconds, collectives a step, the
        worst leaf's max |block - the unsharded run's block| over that
        block's max |.|, for the parameters and for AdamW's m)."""
        before = group.tally.snapshot()
        t0 = time.perf_counter()
        params, opt, hist = train_mod.train(
            arch=cfg.name, cfg=cfg, steps=n_steps, seq_len=shape[1], global_batch=shape[0],
            device=device, seed=seed, log_every=1, mesh_shape=MESH_SHAPE, group=group)
        if cuda:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        after = group.tally.snapshot()
        per_step = {k: {kind: (after[k][kind] - before[k][kind]) / n_steps
                        for kind in after[k]} for k in after}
        errs = [leaf_errs(cfg, params, ref_state[0], relative=False),
                leaf_errs(cfg, opt.m, ref_state[1])]
        return [v for _, v in hist], seconds, per_step, errs

    def leaf_errs(cfg, got, full, relative=True):
        """Per leaf (``tree_leaves``' order) of a tree of this worker's blocks
        ``got``: max |block - full's block|, over that block's max |.| where
        ``relative``."""
        with sharding.use_mesh(mesh):
            specs = lm.param_specs(cfg)
        out_ = []
        for g, w in zip(tree_leaves(got), tree_leaves(P.shard_params(full, mesh, specs)),
                        strict=True):
            w = w.to(g.device)  # a block of a tree held on the host comes over leaf by leaf
            d = (g - w).abs().max()
            out_.append(float(d / w.abs().max().clamp_min(1e-30) if relative else d))
        return out_

    def grad_err(cfg, params, key):
        """The gradient at these (initial) blocks on step 0's global batch
        against the unsharded gradient's blocks."""
        with sharding.use_mesh(mesh):
            _, grads = lm.value_and_grad(params, inputs[key + "_batch"], cfg)
        return leaf_errs(cfg, grads, inputs[key + "_grad"])

    def prefill(cfg, params, toks, label):
        with sharding.use_mesh(mesh), torch.no_grad(), kernels.Executed(device) as ran:
            last, cache = steps.make_prefill_step(cfg)(params, {"tokens": toks})
        ran_add(ran)
        return last.cpu(), cache, {label: dict(ran.launches), label + "_routes": {
            k: dict(v) for k, v in ran.routes.items()}}

    def dense_part(cfg):  # (b) qwen2-1.5b at full width, MESH_DENSE_LAYERS of 28, f32
        reset_peak()
        params = P.init_local_params(cfg, seed, mesh, device=device)
        b = {"param_bytes": _mesh_nbytes(params),
             "full_bytes": _mesh_nbytes(lm.init_params(cfg, device="meta")),
             "grad_err": grad_err(cfg, params, "b")}
        free()
        b["prefill"], _, ran = prefill(cfg, params, inputs["b_toks"], "prefill_launches")
        b.update(ran)
        serve = steps.make_serve_step(cfg)
        s4, s1 = inputs["b_cache4"]["k"].shape[3], inputs["b_cache1"]["k"].shape[3]
        with sharding.use_mesh(mesh), torch.no_grad():
            c4 = steps.local_cache(inputs["b_cache4"], cfg, ShapeSpec("d", "decode", s4, 4))
            b["cache4_shape"] = tuple(c4["k"].shape)
            b["decode4"] = serve(params, c4, {"tokens": inputs["b_next"], "cache_pos":
                                              torch.tensor(prompt, device=device)})[0].cpu()
            del c4
            c1 = steps.local_cache(inputs["b_cache1"], cfg, ShapeSpec("d", "decode", s1, 1))
            b["cache1_shape"] = tuple(c1["k"].shape)
            t0 = time.perf_counter()
            b["decode1"] = [serve(params, c1, {"tokens": inputs["b_dec"][t].view(1, 1),
                                               "cache_pos": torch.tensor(prompt + t,
                                                                         device=device)}
                                  )[0].cpu() for t in range(n_one)]
            if cuda:
                torch.cuda.synchronize(device)
            b["decode1_ms"] = 1e3 * (time.perf_counter() - t0) / n_one
        del params, c1
        free()
        b["losses"], b["train_s"], b["tally_per_step"], b["state_err"] = train_run(
            cfg, train_shape, inputs["b_state"])
        b["peak_gb"] = peak_gb()
        return b

    def ssm_part(cfg):  # (c) rwkv6-7b at full width, 2 of 32 layers, f32
        reset_peak()
        params = P.init_local_params(cfg, seed, mesh, device=device)
        c = {"param_bytes": _mesh_nbytes(params), "grad_err": grad_err(cfg, params, "c")}
        free()
        c["prefill"], cache, ran = prefill(cfg, params, inputs["c_toks"], "prefill_launches")
        c.update(ran)
        c["state_shape"] = tuple(cache["s"].shape)
        del params, cache
        free()
        c["losses"], c["train_s"], c["tally_per_step"], c["state_err"] = train_run(
            cfg, train_shape, inputs["c_state"])
        c["peak_gb"] = peak_gb()
        return c

    def moe_part(cfg):
        """(d) llama4-scout at full width, 2 of 48 layers, f32: no drops, then
        the configured capacity factor with each layer's drops on this data
        shard."""
        reset_peak()
        params = P.init_local_params(cfg, seed, mesh, device=device)
        d = {"param_bytes": _mesh_nbytes(params)}
        d["prefill"], _, ran = prefill(cfg, params, inputs["d_toks"], "prefill_launches")
        d.update(ran)
        with moe_drops(torch, moe) as log:
            d["prefill_configured"], _, ran = prefill(inputs["cfgs"]["d_configured"], params,
                                                      inputs["d_toks"], "configured_launches")
            d["drops"] = [(float(share), int(busiest), cap) for share, busiest, cap in log]
        d.update(ran)
        d["peak_gb"] = peak_gb()
        return d

    def moe_grad_part(cfg):
        """(d) llama4-scout at full width, 1 of 48 layers, f32: the gradient
        at the initial weights on step 0's batch, at the configured
        capacity factor, against ``moe_per_data_shard``'s unsharded one."""
        reset_peak()
        params = P.init_local_params(cfg, seed, mesh, device=device)
        g = {"param_bytes": _mesh_nbytes(params), "grad_err": grad_err(cfg, params, "g")}
        g["peak_gb"] = peak_gb()
        return g

    for key, part in (("b", dense_part), ("c", ssm_part), ("d", moe_part), ("g", moe_grad_part)):
        if key in parts:
            out[key] = part(inputs["cfgs"][key])
            free()
    return out


def wkv_shard_row(torch, wkv, label, b, s, h, dtype, gen, dev, reps, peaks):
    """wkv6_chunk on a shard's operands (MESH_WKV_OPERANDS): r, k, v and
    logw as (B, H, q, 64) views of the chunk's rows of (B, S, H 64)
    projections, y written into a strided view of a (B, S, H, 64) buffer as
    ``rwkv6.time_mix`` does; held to the plain chunk form in f64 (row 10's
    tolerance), the same bits on repeat; times beside the bound. Returns
    the kernels line's row."""
    bw, f32_peak, _, tf32_peak = peaks
    q, d = WKV_Q, WKV_D
    mean, sd = DECAYS["model"]

    def proj(scale, dt):
        t = torch.randn(b, s, h * d, generator=gen, device=dev) * scale
        return t.to(dt).reshape(b, s, h, d)[:, q:2 * q].transpose(1, 2)

    r, k, v = proj(0.5, dtype), proj(0.5, dtype), proj(1.0, dtype)
    logw = -torch.exp(proj(sd, torch.float32) + mean)
    u = (torch.randn(2 * h, d, generator=gen, device=dev) * 0.5)[h:]  # this shard's heads
    s0 = torch.randn(b, h, d, d, generator=gen, device=dev) * 0.3
    args = (r, k, v, logw, u, s0)
    check(not r.is_contiguous(), f"wkv6_chunk {label}: the operand is not a strided view")
    buf = torch.empty(b, s, h, d, device=dev)
    out = buf[:, q:2 * q].transpose(1, 2)
    _, state = wkv.wkv6_chunk(*args, out=out)
    torch.cuda.synchronize()
    got = (out.clone(), state)
    err_abs, err_rel, s_rel = wkv_errors(torch, wkv, got, args)
    tol = TOL["wkv6_chunk"]
    check(math.isfinite(err_rel) and err_rel <= tol and s_rel <= tol,
          f"wkv6_chunk {label}: row-relative err {err_rel:.3e}, state {s_rel:.3e} > {tol:.0e}")
    again = wkv.wkv6_chunk(*args)
    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
          f"wkv6_chunk {label} is not bit-stable")
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes, nflops = wkv_work(b, h, q, d, d, esize, 4)
    by_bytes, by_ops = nbytes / bw, 3 * nflops / tf32_peak  # 3xTF32
    row = dict(
        name="wkv6_chunk", operand=f"{label}: B={b} H={h} q={q} dk=dv={d} {str(dtype)[6:]} "
        "r/k/v as strided views, f32 logw", shape=[b, h, q, d, d], max_abs_err=err_abs,
        max_rel_err=err_rel, state_rel_err=s_rel, tol=tol, main=False,
        ms=time_ms(torch, lambda: wkv.wkv6_chunk(*args, out=out), reps),
        plain_ms=time_ms(torch, lambda: wkv.ref.wkv6_chunk_factored(*args), reps),
        library_ms=None, bound_ms=1e3 * max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations", bytes=nbytes, flops=nflops)
    print(f"kernel wkv6_chunk {row['operand']}: {row['ms']:.4f} ms (plain chunk form "
          f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} by {row['bound_by']}) row-relative "
          f"err {err_rel:.2e} (state {s_rel:.2e}; limit {tol:.0e}) against the f64 plain "
          "version; bit-stable")
    return row


def mesh_kernel_rows(torch, fa, wkv, kernels, dev, gen, reps, peaks):
    """flash_attention and wkv6_chunk on the operands the (2, 2) and (1, 4)
    shards give them (MESH_FA_OPERANDS, MESH_WKV_OPERANDS), each against
    its plain version at rows 9 and 10's tolerances (``flash_row``,
    ``wkv_shard_row``)."""
    rows_out, dh = [], 128
    for label, b, s, hq, hkv, hread, dtype in MESH_FA_OPERANDS:
        dt = getattr(torch, dtype)

        def proj(h):
            return torch.randn(b, s, h * dh, generator=gen, device=dev).to(dt).reshape(
                b, s, h, dh).transpose(1, 2)

        q, k, v = proj(hq), proj(hkv)[:, :hread], proj(hkv)[:, :hread]
        check(not q.is_contiguous(), f"flash_attention {label}: q is not a strided view")
        rows_out.append(flash_row(torch, fa, kernels, label, q, k, v, True, reps, peaks))
        del q, k, v
    for label, b, s, h, dtype in MESH_WKV_OPERANDS:
        rows_out.append(wkv_shard_row(torch, wkv, label, b, s, h, getattr(torch, dtype), gen,
                                      dev, reps, peaks))
    torch.cuda.empty_cache()
    return rows_out


def mesh_phase(torch, np, kernels, lm, steps, train_mod, comm, dfw, fa, wkv, get_config, dev,
               args, peaks):
    """Phase 33 (see the module doc). Returns (report, summed launches of its
    workers' sharded prefills, the kernel rows at the shards' operands)."""
    import gc
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import data
    from repro_torch.models import moe
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import schedule
    from repro_torch.optim.compression import tree_leaves

    t_phase = time.perf_counter()
    report = {}
    gc.collect()
    torch.cuda.empty_cache()
    report["held_gb"] = torch.cuda.memory_allocated() / 1e9
    print(f"phase 33 starts with {report['held_gb']:.2f} GB allocated")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) train(mesh_shape=(1, 1)) over one NCCL worker against the unsharded
    # steps: qwen2-1.5b at full width and depth, bf16, the same bits
    b, s = MESH_ONE_SHAPE
    kw = dict(arch=LM_ARCH, smoke=False, steps=MESH_STEPS, seq_len=s, global_batch=b,
              log_every=1, device=dev, seed=args.seed)
    t0 = time.perf_counter()
    p0, o0, h0 = train_mod.train(**kw)
    want = [t.cpu() for t in tree_leaves(p0)] + [t.cpu() for t in tree_leaves(o0.m)]
    del p0, o0
    free()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            p1, o1, h1 = train_mod.train(mesh_shape=(1, 1), group=comm.WorkerGroup(), **kw)
            got = tree_leaves(p1) + tree_leaves(o1.m)
            same = h0 == h1 and len(got) == len(want) and all(
                torch.equal(g.cpu(), w) for g, w in zip(got, want))
        finally:
            comm.destroy_groups()
    del p1, o1, got, want
    free()
    report["a"] = dict(losses=[v for _, v in h0], mesh_losses=[v for _, v in h1], same_bits=same,
                       wall_s=time.perf_counter() - t0)
    print(f"(a) {LM_ARCH} (28 layers, bf16) launch.train.train over one NCCL worker with "
          f"mesh_shape=(1, 1), {MESH_STEPS} steps of {b} x {s}: losses {report['a']['mesh_losses']}"
          f" against the unsharded {report['a']['losses']}; parameters and AdamW m the same "
          f"bits: {same}")

    # the unsharded references on the card, f32, from the same seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    inputs, refs = {}, {}
    cfg_b = dataclasses.replace(get_config(LM_ARCH), num_layers=MESH_DENSE_LAYERS,
                                dtype="float32")
    pb, sb = MESH_PREFILL_SHAPE
    params = lm.init_params(cfg_b, args.seed, device=dev)
    inputs["b_toks"] = torch.randint(0, cfg_b.vocab_size, (pb, sb), generator=gen, device=dev)
    inputs["b_next"] = torch.randint(0, cfg_b.vocab_size, (pb, 1), generator=gen, device=dev)
    inputs["b_dec"] = torch.randint(0, cfg_b.vocab_size, (MESH_DECODE_ONE,), generator=gen,
                                    device=dev)
    prefill, serve = steps.make_prefill_step(cfg_b), steps.make_serve_step(cfg_b)
    with torch.no_grad():
        last, cache = prefill(params, {"tokens": inputs["b_toks"]})
        refs["b_prefill"] = last.cpu()
        for key, rows, length in (("b_cache4", slice(None), sb + 1),
                                  ("b_cache1", slice(0, 1), sb + MESH_DECODE_ONE)):
            full = lm.init_cache(cfg_b, rows.stop or pb, length, device=dev)
            for name in full:
                full[name][:, :, :, :sb] = cache[name][:, rows]
            inputs[key] = full
        del cache
        c4 = {k: v.clone() for k, v in inputs["b_cache4"].items()}
        refs["b_decode4"] = serve(params, c4, {"tokens": inputs["b_next"], "cache_pos":
                                               torch.tensor(sb, device=dev)})[0].cpu()
        c1 = {k: v.clone() for k, v in inputs["b_cache1"].items()}
        refs["b_decode1"] = [serve(params, c1, {"tokens": inputs["b_dec"][t].view(1, 1),
                                                "cache_pos": torch.tensor(sb + t, device=dev)}
                                   )[0].cpu() for t in range(MESH_DECODE_ONE)]
    del params, c4, c1
    free()
    tb, ts = MESH_TRAIN_SHAPE

    spread = {}

    def unsharded_grad(cfg, key):
        """The gradient at the initial weights on step 0's batch, and each
        leaf's spread: its change when every weight moves by one rounding."""
        batch = data.device_put_batch(data.SyntheticLMStream(cfg, ShapeSpec(
            "t", "train", ts, tb)).batch_for_step(0), dev)
        params = lm.init_params(cfg, args.seed, device=dev)
        _, grads = lm.value_and_grad(params, batch, cfg)
        inputs[key + "_batch"], inputs[key + "_grad"] = batch, tree_to(torch, grads, "cpu")
        del grads
        pgen = torch.Generator(device=dev)
        pgen.manual_seed(args.seed + 1)
        for t in tree_leaves(params):
            t.copy_(t.double() * (1 + MESH_ROUNDING * torch.randn(
                t.shape, generator=pgen, device=dev, dtype=torch.float64)))
        _, moved = lm.value_and_grad(params, batch, cfg)
        spread[key] = [float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(tree_leaves(moved), tree_leaves(inputs[key + "_grad"]),
                                       strict=True)]
        spread[key + "_paths"] = _leaf_paths(inputs[key + "_grad"])
        del params, moved
        free()

    unsharded_grad(cfg_b, "b")
    p_ref, o_ref, h_ref = train_mod.train(
        arch=LM_ARCH, cfg=cfg_b, steps=MESH_STEPS, seq_len=ts, global_batch=tb, device=dev,
        seed=args.seed, log_every=1)
    refs["b_losses"] = [v for _, v in h_ref]
    # on the host until the workers start, so the card holds nothing else of
    # these runs (their blocks would pin the allocator's segments)
    inputs["b_state"] = tree_to(torch, (p_ref, o_ref.m), "cpu")
    del p_ref, o_ref
    free()
    cfg_c = dataclasses.replace(get_config(SSM_ARCH), num_layers=MESH_SSM_LAYERS, dtype="float32")
    params = lm.init_params(cfg_c, args.seed, device=dev)
    inputs["c_toks"] = torch.randint(0, cfg_c.vocab_size, MESH_TRAIN_SHAPE, generator=gen,
                                     device=dev)
    with torch.no_grad():
        refs["c_prefill"] = steps.make_prefill_step(cfg_c)(params, {"tokens": inputs["c_toks"]}
                                                           )[0].cpu()
    del params
    free()
    unsharded_grad(cfg_c, "c")
    p_ref, o_ref, h_ref = train_mod.train(
        arch=SSM_ARCH, cfg=cfg_c, steps=MESH_STEPS, seq_len=ts, global_batch=tb, device=dev,
        seed=args.seed, log_every=1)
    refs["c_losses"] = [v for _, v in h_ref]
    inputs["c_state"] = tree_to(torch, (p_ref, o_ref.m), "cpu")
    del p_ref, o_ref
    free()
    cfg_d = dataclasses.replace(get_config(MOE_SCOUT), num_layers=MESH_MOE_LAYERS, dtype="float32",
                                moe_capacity_factor=MESH_NO_DROP)
    params = lm.init_params(cfg_d, args.seed, device=dev)
    inputs["d_toks"] = torch.randint(0, cfg_d.vocab_size, MESH_MOE_SHAPE, generator=gen,
                                     device=dev)
    with torch.no_grad():
        refs["d_prefill"] = steps.make_prefill_step(cfg_d)(params, {"tokens": inputs["d_toks"]}
                                                           )[0].cpu()
    del params
    free()
    # (d) step 0's gradient at 1 layer and the configured capacity, each data
    # shard's rows routed on their own: kept on the host (16.5 GB), each
    # worker reads its blocks from there leaf by leaf
    cfg_g = dataclasses.replace(get_config(MOE_SCOUT), num_layers=MESH_MOE_GRAD_LAYERS,
                                dtype="float32")
    with moe_per_data_shard(torch, moe, MESH_SHAPE[0]):
        unsharded_grad(cfg_g, "g")
    report["refs_s"] = time.perf_counter() - t0
    inputs.update(steps=MESH_STEPS, train_shape=MESH_TRAIN_SHAPE)
    inputs["cfgs"] = dict(b=cfg_b, c=cfg_c, d=cfg_d, g=cfg_g, d_configured=dataclasses.replace(
        cfg_d, moe_capacity_factor=get_config(MOE_SCOUT).moe_capacity_factor))

    # (b)-(e) four gloo workers sharing the card, mesh MESH_SHAPE: (b) and
    # (c) with the unsharded runs' states held here, then (d) without them
    t0 = time.perf_counter()
    free()
    for key in ("b_state", "c_state", "b_grad", "c_grad"):  # read by the workers (CUDA IPC)
        inputs[key] = tree_to(torch, inputs[key], dev)
    outs = dfw.run_workers(MULTI_WORKERS, mesh_rank, args.seed, inputs, ("b", "c"),
                           backend="gloo", device="cuda")
    for key in ("b_state", "c_state", "b_grad", "c_grad"):
        del inputs[key]
    free()
    for o, o_d in zip(outs, dfw.run_workers(MULTI_WORKERS, mesh_rank, args.seed, inputs,
                                            ("d", "g"), backend="gloo", device="cuda"),
                      strict=True):
        o["d"], o["g"] = o_d["d"], o_d["g"]
        for k_, v_ in o_d["launches"].items():
            o["launches"][k_] += v_
    report["workers_s"] = time.perf_counter() - t0
    del inputs
    free()
    n_data, n_model = MESH_SHAPE

    def rows(key, name):  # the global batch from each data shard's rows
        return torch.cat([outs[i * n_model][key][name] for i in range(n_data)])

    def err(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    def loss_err(got, want):
        return max(abs(g - w) / abs(w) for g, w in zip(got, want))

    def against_spread(key, per_worker):
        """(the worst leaf's error over its bound, the error, the leaf's
        spread, its path): a leaf's bound is the larger of MESH_TOL["grad"]
        and MESH_TOL["sensitivity"] x its spread."""
        return max((e / max(MESH_TOL["grad"], MESH_TOL["sensitivity"] * sp), e, sp, name)
                   for errs_ in per_worker for e, sp, name in zip(
                       errs_, spread[key], spread[key + "_paths"], strict=True))

    lr_1 = float(schedule.cosine_with_warmup(torch.tensor(1), peak_lr=3e-4, warmup=100,
                                             total=10000))  # make_train_step's defaults

    errs = {
        "b_prefill": err(rows("b", "prefill"), refs["b_prefill"]),
        "b_decode4": err(rows("b", "decode4"), refs["b_decode4"]),
        "b_decode1": max(err(g, w) for o in outs for g, w in zip(o["b"]["decode1"],
                                                                refs["b_decode1"])),
        "b_losses": max(loss_err(o["b"]["losses"], refs["b_losses"]) for o in outs),
        "c_prefill": err(rows("c", "prefill"), refs["c_prefill"]),
        "c_losses": max(loss_err(o["c"]["losses"], refs["c_losses"]) for o in outs),
        **{f"{k}_grad": against_spread(k, [o[k]["grad_err"] for o in outs]) for k in "bcg"},
        **{f"{k}_adam_m": against_spread(k, [o[k]["state_err"][1] for o in outs])
           for k in "bc"},
        **{f"{k}_params_lr": max((e / lr_1, name) for o in outs for e, name in zip(
            o[k]["state_err"][0], spread[k + "_paths"])) for k in "bc"},
        "d_prefill": err(rows("d", "prefill"), refs["d_prefill"]),
    }
    fa_each = [o["b"]["prefill_launches"]["flash_attention"]
               + o["d"]["prefill_launches"]["flash_attention"]
               + o["d"]["configured_launches"]["flash_attention"] for o in outs]
    wkv_each = [o["c"]["prefill_launches"]["wkv6_chunk"] for o in outs]
    fa_want = cfg_b.num_layers + 2 * cfg_d.num_layers
    wkv_want = cfg_c.num_layers * (ts // min(cfg_c.ssm_chunk, ts))
    share = [o["b"]["param_bytes"] / o["b"]["full_bytes"] for o in outs]
    total = dict.fromkeys(kernels.launches(), 0)
    for o in outs:
        for k_, v_ in o["launches"].items():
            total[k_] += v_
    report.update(errs=errs, flash_launches=fa_each, wkv6_launches=wkv_each, param_share=share,
                  peak_gb={k: [o[k]["peak_gb"] for o in outs] for k in "bcdg"},
                  param_gb={k: [o[k]["param_bytes"] / 1e9 for o in outs] for k in "bcdg"},
                  train_s={k: [o[k]["train_s"] for o in outs] for k in "bc"},
                  tally_per_step={k: outs[0][k]["tally_per_step"] for k in "bc"},
                  losses={k: outs[0][k]["losses"] for k in "bc"},
                  ref_losses={k: refs[k + "_losses"] for k in "bc"},
                  decode1_ms=[o["b"]["decode1_ms"] for o in outs],
                  cache_shapes=dict(b4=outs[0]["b"]["cache4_shape"],
                                    b1=outs[0]["b"]["cache1_shape"],
                                    c_state=outs[0]["c"]["state_shape"]),
                  drops={str(outs[i * n_model]["coords"]): outs[i * n_model]["d"]["drops"]
                         for i in range(n_data)},
                  launches=total)
    print(f"(b) {LM_ARCH} at full width, {MESH_DENSE_LAYERS} of 28 layers, f32, mesh "
          f"{MESH_SHAPE} (data, model) on {MULTI_WORKERS} gloo workers: losses "
          f"{report['losses']['b']} against the unsharded {report['ref_losses']['b']} (rel "
          f"{errs['b_losses']:.2e}); each worker's blocks against the unsharded run's, the "
          f"worst leaf's (error over its bound, error over its max, its spread, path): step "
          f"0's gradient {errs['b_grad']}, AdamW m after the steps {errs['b_adam_m']}; the "
          f"parameters' worst difference in units of lr_1 {errs['b_params_lr']}; prefill "
          f"{pb} x {sb} last logits rel "
          f"{errs['b_prefill']:.2e}, "
          f"batch-4 decode step {errs['b_decode4']:.2e} (cache block "
          f"{report['cache_shapes']['b4']}), {MESH_DECODE_ONE} sequence-sharded batch-1 steps "
          f"{errs['b_decode1']:.2e} (cache block {report['cache_shapes']['b1']}, "
          f"{statistics.median(report['decode1_ms']):.1f} ms a step); parameter bytes a worker "
          f"{[round(x, 4) for x in share]} of the whole; peak GB {report['peak_gb']['b']}; "
          f"collectives a train step (worker 0) {report['tally_per_step']['b']}")
    print(f"(c) {SSM_ARCH} at full width, {MESH_SSM_LAYERS} of 32 layers, f32: losses "
          f"{report['losses']['c']} against {report['ref_losses']['c']} (rel "
          f"{errs['c_losses']:.2e}); blocks: step 0's gradient {errs['c_grad']}, AdamW m "
          f"{errs['c_adam_m']}, parameters {errs['c_params_lr']}; prefill "
          f"{MESH_TRAIN_SHAPE} last logits rel "
          f"{errs['c_prefill']:.2e}; state block {report['cache_shapes']['c_state']} (32 of 64 "
          f"heads); peak GB {report['peak_gb']['c']}")
    print(f"(d) {MOE_SCOUT} at full width, {MESH_MOE_LAYERS} of 48 layers, f32, 8 of 16 experts "
          f"a model shard: prefill {MESH_MOE_SHAPE} at capacity factor {MESH_NO_DROP} rel "
          f"{errs['d_prefill']:.2e}; at the configured factor each data shard's dropped share, "
          f"busiest expert and capacity a layer: {report['drops']}; peak GB "
          f"{report['peak_gb']['d']}; at {MESH_MOE_GRAD_LAYERS} layer and the configured factor, "
          f"step 0's gradient blocks against the unsharded gradient with each data shard's "
          f"rows routed on their own (worst leaf: error over its bound, error, spread, path) "
          f"{errs['g_grad']}, parameter GB a worker {report['param_gb']['g']}, peak GB "
          f"{report['peak_gb']['g']}")
    print(f"(e) flash_attention launches a worker {fa_each} (want {fa_want}), wkv6_chunk "
          f"{wkv_each} (want {wkv_want})")
    t0 = time.perf_counter()
    rows_out = mesh_kernel_rows(torch, fa, wkv, kernels, dev, gen, args.reps, peaks)
    report["kernel_rows_s"] = time.perf_counter() - t0
    report["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 33 took {report['wall_s']:.1f} s (the kernels at the shards' operands "
          f"{report['kernel_rows_s']:.1f} s, (a) and the references "
          f"{report['refs_s']:.1f} s, "
          f"workers {report['workers_s']:.1f} s)")
    check(same, "(a) the (1, 1)-mesh train run is not the unsharded run's bits")
    for key in ("b_prefill", "b_decode4", "b_decode1", "c_prefill", "d_prefill"):
        check(errs[key] <= MESH_TOL["logits"], f"({key[0]}) {key}: rel {errs[key]:.2e} > "
              f"{MESH_TOL['logits']}")
    for key in ("b_losses", "c_losses"):
        check(errs[key] <= MESH_TOL["loss"], f"({key[0]}) {key}: rel {errs[key]:.2e} > "
              f"{MESH_TOL['loss']}")
    for key in ("b_grad", "b_adam_m", "c_grad", "c_adam_m", "g_grad"):
        check(errs[key][0] <= 1, f"({key[0]}) {key}: a leaf past its bound (error over bound, "
              f"error, spread, path) {errs[key]}")
    for key in ("b_params_lr", "c_params_lr"):
        check(errs[key][0] <= MESH_TOL["params_lr"], f"({key[0]}) {key}: {errs[key]} > "
              f"{MESH_TOL['params_lr']} lr_1")
    check(all(x <= MESH_TOL["param_share"] for x in share),
          f"(b) a worker holds {max(share):.4f} of the parameters")
    check(all(n == fa_want for n in fa_each), f"(e) flash_attention launches {fa_each}")
    check(all(n == wkv_want for n in wkv_each), f"(e) wkv6_chunk launches {wkv_each}")
    check(all(math.isfinite(float(o["d"]["prefill_configured"].abs().max())) for o in outs),
          "(d) logits at the configured capacity not finite")
    return report, total, rows_out


# Phase 34: LM training of the moe, hybrid, vlm and audio families
FAMILY_TRAIN_STEPS = 2
# (key, arch, layers (None: all), (B, S) of a step): (a)-(c), AdamW through
# launch.train.train; vlm's S counts its vision_tokens (1,024) and text
FAMILY_TRAIN = (("a", AUDIO_ARCH, None, AUDIO_SHAPE), ("b", HYBRID_SERVE_ARCH, None, (4, 2048)),
                ("c", VLM_ARCH, 2, (4, 2048)))  # qwen2-vl-72b: 2 of 80 layers, ~51 GB of state
SCOUT_TRAIN_LAYERS = 1  # (d) of 48: 4.1 B parameters, ~55 GB with AdamW and the f32 head gradient
SCOUT_TRAIN_SHAPE = (4, 2048)
SCOUT_MU, SCOUT_ITERS = 100.0, 2
# (e) f32 configurations that fit on the CPU, each family's training path at
# a narrow width: (label, arch, overrides, (B, S))
TRAIN_XCHECK = (
    ("arctic-480b (E 16, top-2, dense residual)", "arctic_480b",
     dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=256, moe_dense_ff=256,
          vocab_size=1024, num_experts=16), (4, 128)),
    ("llama4-scout (E 16, top-1)", "llama4_scout_17b_a16e",
     dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1024),
     (4, 128)),
    ("zamba2-2.7b (2 Mamba-2 layers, q 256, the shared block twice)", "zamba2_2_7b",
     dict(num_layers=2, hybrid_block=1, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
          vocab_size=1024), (2, 512)),
    ("qwen2-vl-72b (64 vision + 128 text)", "qwen2_vl_72b",
     dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1024,
          vision_tokens=64, mrope_sections=(8, 12, 12)), (2, 192)),
    ("hubert-xlarge (1,500 frames, one loss chunk)", "hubert_xlarge",
     dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512), (2, 1500)),
)
# the CPU parity tests' bounds (tests/test_torch_train_families.py): the loss
# rtol 1e-5, each gradient leaf within 1e-4 of its largest |gradient|, and
# Mamba-2's a_log within 1e-3: its gradient takes each decay as a difference
# of two cumulative sums, which at q 256 reach past -1000 (the init's decay
# rates run to 16 a position), so f32 rounding there carries into it (the
# CPU test at decays past -80 holds it so; on an H100 80GB HBM3 at 700 W
# the card stood 1.76e-4 from the CPU)
TRAIN_XCHECK_TOL = {"loss": 1e-5, "grad": 1e-4, "a_log": 1e-3}


def bit_digest(torch, t, chunk=1 << 26):
    """Two 64-bit sums of a tensor's bit patterns (as 16- or 32-bit words),
    the second weighted by position: any changed bit changes them, bar a
    collision. For trees too large to keep two copies of on the card."""
    w = t.detach().reshape(-1).view({2: torch.int16, 4: torch.int32}[t.element_size()])
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, w.numel(), chunk):
        x = w[lo:lo + chunk].to(torch.int64)
        pos = torch.arange(lo, lo + x.numel(), device=t.device) % 65521 + 1
        s1 += x.sum()
        s2 += (x * pos).sum()
    return int(s1), int(s2)


def tree_digest(torch, tree):
    from repro_torch.optim.compression import tree_leaves

    return [bit_digest(torch, t) for t in tree_leaves(tree)]


@contextlib.contextmanager
def head_events(torch, hybrid):
    """Inside the block each hybrid step records a CUDA event before its
    power method and after its rank-1 update: yields the list of (start,
    end) pairs, one a step."""
    pairs, orig_pm, orig_r1 = [], hybrid.power_method_dense, hybrid.r1_ops

    def watched_pm(a, v0, k):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        pairs.append([start, None])
        return orig_pm(a, v0, k)

    def watched_r1(z, x, y, a_, b_, out=None):
        got = orig_r1.rank1_update(z, x, y, a_, b_, out=out)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        pairs[-1][1] = end
        return got

    import types

    hybrid.power_method_dense = watched_pm
    hybrid.r1_ops = types.SimpleNamespace(rank1_update=watched_r1)
    try:
        yield pairs
    finally:
        hybrid.power_method_dense, hybrid.r1_ops = orig_pm, orig_r1


def train_xcheck(torch, lm, data, ShapeSpec, cfg, shape, dev, seed, label):
    """``lm.value_and_grad`` of ``cfg`` in f32 on the card (twice) against
    the CPU on one batch of the stream, the same weights: the loss, the aux
    loss and every gradient leaf (TRAIN_XCHECK_TOL), the card's bits on
    repeat. Returns its report."""
    from repro_torch.optim.compression import tree_leaves

    b, s = shape
    params = lm.init_params(cfg, seed, device="cpu")
    batch = data.SyntheticLMStream(cfg, ShapeSpec("x", "train", s, b)).batch_for_step(0)
    t0 = time.perf_counter()
    (l_cpu, m_cpu), g_cpu = lm.value_and_grad(params, data.device_put_batch(batch, "cpu"), cfg)
    cpu_s = time.perf_counter() - t0
    dparams = tree_to(torch, params, dev)
    dbatch = data.device_put_batch(batch, dev)
    (l1, m1), g1 = lm.value_and_grad(dparams, dbatch, cfg)
    (l2, m2), g2 = lm.value_and_grad(dparams, dbatch, cfg)
    same = (bool(torch.equal(l1, l2)) and bool(torch.equal(m1["aux"], m2["aux"]))
            and all(torch.equal(a, c) for a, c in zip(tree_leaves(g1), tree_leaves(g2))))
    names = leaf_names(params)
    tol = TRAIN_XCHECK_TOL
    errs = []  # (error over its bound, error over the leaf's max, path)
    for name, g, w in zip(names, tree_leaves(g1), tree_leaves(g_cpu), strict=True):
        scale = float(w.abs().max())
        e = (float((g.cpu() - w).abs().max()) / max(scale, 1e-30) if scale else
             float(g.abs().max()))
        errs.append((e / tol["a_log" if name.endswith("/a_log") else "grad"], e, name))
    worst = max(errs)
    loss_rel = abs(float(l1) - float(l_cpu)) / abs(float(l_cpu))
    aux_rel = (abs(float(m1["aux"]) - float(m_cpu["aux"])) / abs(float(m_cpu["aux"]))
               if float(m_cpu["aux"]) else abs(float(m1["aux"])))
    rep = dict(label=label, shape=list(shape), loss=float(l1), loss_cpu=float(l_cpu),
               loss_rel=loss_rel, aux=float(m1["aux"]), aux_rel=aux_rel, worst_grad=worst,
               bits_repeat=same, cpu_s=cpu_s)
    top = max(errs, key=lambda r: r[1])
    print(f"(e) {label}, f32, {b} x {s}: loss {float(l1):.6f} on the card, {float(l_cpu):.6f} on "
          f"the CPU (rel {loss_rel:.2e}), aux rel {aux_rel:.2e}; the worst gradient leaf "
          f"{top[1]:.2e} of its max ({top[2]}), the nearest its bound {worst[0]:.3f} of it "
          f"({worst[2]}); the card's bits on repeat: {same} (the CPU's gradient {cpu_s:.1f} s)")
    check(loss_rel <= tol["loss"] and aux_rel <= tol["loss"],
          f"(e) {label}: loss rel {loss_rel:.2e}, aux rel {aux_rel:.2e} > {tol['loss']}")
    check(worst[0] <= 1, f"(e) {label}: gradient leaf {worst[2]} {worst[1]:.2e} of its max, "
          f"{worst[0]:.2f} of its bound")
    check(same, f"(e) {label}: a second gradient on the card gave other bits")
    del dparams, g1, g2
    return rep


def family_train_phase(torch, kernels, lm, train_mod, hybrid, data, ShapeSpec, moe, pm, r1,
                       get_config, dev, args, peaks):
    """Phase 34 (see the module doc). Returns (report, summed launches of its
    train runs and hybrid steps, the bf16 rank1_update launches, its kernel
    rows)."""
    import gc

    from repro_torch.optim import adamw
    from repro_torch.optim.compression import tree_map

    def host(t):
        return t.detach().to("cpu", copy=True)

    report, rows_out = {}, []
    t_phase = time.perf_counter()
    total = dict.fromkeys(kernels.launches(), 0)
    bf16_total = 0
    held = held_memory(torch)
    gc.collect()
    torch.cuda.empty_cache()
    report["held_gb"] = [held[0], torch.cuda.memory_allocated() / 1e9]
    print(f"phase 34 starts with {held[0]:.2f} GB allocated ({report['held_gb'][1]:.2f} GB after "
          f"a garbage collection); largest live tensors {held[1]}")

    def add(ran):
        nonlocal bf16_total
        for k_, v_ in ran.launches.items():
            total[k_] += v_
        bf16_total += ran.routes["rank1_update"]["bf16"]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a)-(c) AdamW through launch.train.train
    for key, arch, layers, (b, s) in FAMILY_TRAIN:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        label = f"{full.name} ({cfg.num_layers} of {full.num_layers} layers, {cfg.dtype})"
        stamps = []

        def clock(step, metrics, stamps=stamps):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with grad_watch(torch, lm) as seen, counting(kernels) as ran:
            params, opt, hist = train_mod.train(
                arch=arch, cfg=cfg, steps=FAMILY_TRAIN_STEPS, smoke=False, seq_len=s,
                global_batch=b, log_every=1, device=dev, seed=args.seed, callback=clock)
        add(ran)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [v for _, v in hist]
        check(len(losses) == FAMILY_TRAIN_STEPS and all(math.isfinite(v) for v in losses),
              f"({key}) {label}: losses {losses}")
        names = leaf_names(params)
        bad = [n for n in zero_grad_leaves(torch, seen, names)
               if not (cfg.family == "audio" and n == "embed")]  # hubert reads no token
        check(not bad, f"({key}) {label}: {len(bad)} parameters got a zero gradient, e.g. {bad[:5]}")
        check(ran.launches["flash_attention"] == 0 and ran.launches["wkv6_chunk"] == 0,
              f"({key}) a train step launched flash_attention/wkv6_chunk: {ran.launches}")
        ms = 1e3 * (stamps[1] - stamps[0])
        tokens = b * s
        n_params = lm.param_count(params)
        report[key] = dict(arch=full.name, layers=cfg.num_layers, params=n_params, losses=losses,
                           ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3), peak_gb=peak,
                           wall_s=wall, launches=dict(ran.launches))
        what = "frames" if cfg.family == "audio" else "positions"
        print(f"({key}) {label}, {n_params / 1e9:.3f} B parameters, launch.train.train, AdamW, "
              f"{FAMILY_TRAIN_STEPS} steps of {b} x {s} {what}"
              f"{f' ({cfg.vision_tokens} vision)' if cfg.family == 'vlm' else ''}: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.1f} ms the second step, "
              f"{tokens / (ms / 1e3):.0f} {what}/s, peak {peak:.2f} GB, {wall:.1f} s with the "
              f"weights' draw; every parameter a nonzero gradient"
              f"{' (but the unread token embedding)' if cfg.family == 'audio' else ''}; launches "
              f"{ {k_: v_ for k_, v_ in ran.launches.items() if v_} }")
        del params, opt, seen
        free()

    # (d) llama4-scout, 1 of 48 layers, the hybrid DFW head: 2 steps, then a
    # resume from step 1
    full = get_config(MOE_SCOUT)
    cfg = dataclasses.replace(full, num_layers=SCOUT_TRAIN_LAYERS)
    b, s = SCOUT_TRAIN_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm.init_params(cfg, gen)
    n_params = lm.param_count(params)
    stream = data.SyntheticLMStream(cfg, ShapeSpec("scout", "train", s, b))
    batches = [data.device_put_batch(stream.batch_for_step(t), dev) for t in range(2)]
    with moe_drops(torch, moe) as log, torch.no_grad():
        lm.forward(params, batches[0], cfg, mode="hidden")
    drops = [(float(r[0]), int(r[1]), r[2]) for r in log]
    step = hybrid.make_hybrid_train_step(cfg, mu=SCOUT_MU, power_iters=SCOUT_ITERS)
    state = hybrid.init(params)
    losses, sigma, step_ms, snap = [], [], [], None
    torch.cuda.reset_peak_memory_stats()
    with head_events(torch, hybrid) as ev, grad_watch(torch, lm) as seen:
        for t in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting(kernels) as ran:
                params, state, m = step(params, state, batches[t], args.seed)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            add(ran)
            losses.append(float(m["loss"]))
            sigma.append(float(m["fw_sigma"]))
            check(math.isfinite(losses[-1]), f"(d) step {t}: loss {losses[-1]}")
            check(ran.launches["matvec"] == SCOUT_ITERS and ran.launches["rmatvec"] == SCOUT_ITERS
                  and ran.routes["rank1_update"] == {"f32": 0, "bf16": 1},
                  f"(d) step {t}: launches {ran.launches}, rank1 routes "
                  f"{ran.routes['rank1_update']}")
            check(ran.launches["flash_attention"] == 0, "(d) flash_attention in a step")
            if t == 0:  # the state after step 1, copied to the host for the resume
                snap = (tree_map(host, params), tree_map(host, state.adam.m),
                        tree_map(host, state.adam.v), host(state.adam.step), state.fw_step)
        head_ms = [a.elapsed_time(e) for a, e in ev]
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad = zero_grad_leaves(torch, seen, leaf_names(params))
    check(not bad, f"(d) {len(bad)} parameters got a zero gradient, e.g. {bad[:5]}")
    want = tree_digest(torch, {"p": params, "m": state.adam.m, "v": state.adam.v})
    del params, state, m, seen
    free()
    t0 = time.perf_counter()
    p1, m1, v1, st1, fw1 = snap
    del snap
    params = tree_to(torch, p1, dev)
    del p1
    adam = adamw.AdamWState(step=st1.to(dev), m=tree_to(torch, m1, dev), v=tree_to(torch, v1, dev))
    del m1, v1
    state = hybrid.HybridState(adam=adam, fw_step=fw1)
    restore_s = time.perf_counter() - t0
    with counting(kernels) as ran:
        params, state, m = step(params, state, batches[1], args.seed)
    add(ran)
    resumed_loss = float(m["loss"])
    got = tree_digest(torch, {"p": params, "m": state.adam.m, "v": state.adam.v})
    same = got == want and resumed_loss == losses[1]
    ms = step_ms[1]
    tokens = b * s
    report["d"] = dict(arch=full.name, layers=SCOUT_TRAIN_LAYERS, params=n_params, losses=losses,
                       fw_sigma=sigma, step_ms=step_ms, ms_per_step=ms, head_ms=head_ms,
                       head_share=head_ms[1] / ms, tokens_per_s=tokens / (ms / 1e3), peak_gb=peak,
                       dropped_share=drops, resumed_same_bits=same, restore_s=restore_s)
    print(f"(d) {full.name} ({SCOUT_TRAIN_LAYERS} of {full.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}), the hybrid optimizer (AdamW + "
          f"DFW-Trace on the {cfg.d_model} x {cfg.vocab_size} head, mu {SCOUT_MU}, {SCOUT_ITERS} "
          f"power iterations), 2 steps of {b} x {s} tokens: loss {losses[0]:.4f} -> "
          f"{losses[1]:.4f}, sigma {sigma}; {ms:.1f} ms the second step ({step_ms[0]:.1f} the "
          f"first), the head (power method + update) {head_ms[1]:.2f} ms of it "
          f"({100 * head_ms[1] / ms:.2f}%), {tokens / (ms / 1e3):.0f} tokens/s, peak {peak:.2f} GB;"
          f" each step matvec and rmatvec {SCOUT_ITERS} launches, the bf16 rank1_update one; "
          f"dropped share of the routed picks by layer at step 1 (share, busiest expert, "
          f"capacity) {drops}; resumed from step 1's state (host copy, {restore_s:.1f} s back to "
          f"the card): loss {resumed_loss:.6f}, parameters and AdamW state the uninterrupted "
          f"run's bits (digests): {same}")
    check(same, f"(d) the run resumed at step 1 is not the uninterrupted run's bits (loss "
          f"{resumed_loss} against {losses[1]})")
    check(all(share < 1.0 for share, _, _ in drops), f"(d) drops {drops}")
    del params, state, m, batches, adam
    free()

    # (e) card against CPU, f32
    report["e"] = []
    for label, arch, over, shape in TRAIN_XCHECK:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
        report["e"].append(train_xcheck(torch, lm, data, ShapeSpec, cfg, shape, dev, args.seed,
                                        label))
        free()

    # (f) the hybrid step's kernels at llama4-scout's head
    rows_out += head_kernel_rows(torch, pm, r1, dev, gen, full.d_model, full.vocab_size,
                                 "llama4-scout's head", "(f)", args.reps, peaks)
    report["wall_s"] = time.perf_counter() - t_phase
    report["launches"] = total
    report["bf16_launches"] = bf16_total
    print(f"phase 34 took {report['wall_s']:.1f} s")
    return report, total, bf16_total, rows_out


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

    from repro_torch import (NoiseStream, V0Stream, checkpoint, comm, convert, data, kernels,
                             resolve_device)
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, dfw_head, engine, frank_wolfe, low_rank, tasks
    from repro_torch.kernels import _build
    from repro_torch.kernels import factor_matvec as fm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mc_matvec as mc
    from repro_torch.kernels import power_matvec as pm
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rank1_update as r1
    from repro_torch.kernels import wkv6_chunk as wkv
    from repro_torch.core import power_method
    from repro_torch.launch import dfw, steps
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm, mamba2, moe, rwkv6
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, compression, hybrid

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)

    def held_gb():
        return f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after it"

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
        driver = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        report["driver"] = driver
        print(f"torch {torch.__version__} cuda {torch.version.cuda} driver {driver} device {name}")
        print(smi)
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
            torch, np, dfw, tasks, checkpoint, serve, low_rank, kernels, fm, dev, gen, args)
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
            report["lm_profile"] = profile_lm(torch, lm, lm_serve, steps, lm_cfg, lm_params,
                                              lm_toks, dev, args.seed)
        del lm_toks
        torch.cuda.empty_cache()

        # 15. full-width decode through generate
        report["lm_decode"], decode_launch = lm_decode_phase(
            torch, np, kernels, lm, steps, lm_serve, get_config(LM_ARCH), dev, args.seed)
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
            report["ssm_profile"] = profile_ssm(torch, lm, lm_serve, steps, ssm_cfg, ssm_params,
                                                ssm_toks, dev, args.seed)
        del ssm_toks
        torch.cuda.empty_cache()

        # 19. full-width decode through generate, with the prefill's weights
        report["ssm_decode"], ssm_decode_launch = ssm_decode_phase(
            torch, np, kernels, lm, steps, lm_serve, get_config(SSM_ARCH), ssm_params, dev,
            args.seed)
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
              f"{report['graphs']['wall_s']:.1f} s ({smi}); {held_gb()}")
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
        print(f"phase 25 took {report['block']['wall_s']:.1f} s ({smi}); {held_gb()}")
        torch.cuda.empty_cache()

        # 26. resume from checkpoints: MC dense and block:8:adapt at the Netflix
        # shapes, MTLS topk:16 and logistic int8, four gloo workers resumed on
        # four and on two; the dense MTLS operator
        t0 = time.perf_counter()
        report["resume"], resume_launch, resume_route = resume_phase(
            torch, np, kernels, dfw, tasks, low_rank, checkpoint, convert, dev, args)
        block_route += resume_route
        report["resume"]["wall_s"] = time.perf_counter() - t0
        print(f"phase 26 took {report['resume']['wall_s']:.1f} s ({smi}); {held_gb()}")
        torch.cuda.empty_cache()

        # 27. the engine on the card: scan (one graph a segment) against
        # legacy at the full shapes, the dispatch contract, IF nodes
        report["engine"], engine_launch, engine_route = engine_phase(
            torch, np, kernels, dfw, comm, tasks, frank_wolfe, engine, dev, args)
        block_route += engine_route
        print(f"phase 27 took {report['engine']['wall_s']:.1f} s ({smi}); {held_gb()}")
        torch.cuda.empty_cache()

        # 28. telemetry through the fits, the checkpoint store and serving: the
        # same bits, stats and launches with the handle on and off, its cost,
        # the op recorder's contracts on the captured programs
        report["telemetry"], telemetry_launch, telemetry_route = telemetry_phase(
            torch, np, kernels, dfw, comm, tasks, frank_wolfe, engine, serve, low_rank, dev, args)
        block_route += telemetry_route
        print(f"phase 28 ({smi}); {held_gb()}")
        torch.cuda.empty_cache()

        # 29. the paper's head: train_head and sharded_fit at the ImageNet
        # shapes, checkpoints and resume, top_k_error, features from the LM
        # zoo, PowerSGD
        report["head"], head_launch, head_rows = head_phase(
            torch, np, kernels, dfw, comm, tasks, low_rank, checkpoint, dfw_head, compression,
            lm, get_config, fm, dev, args, peaks)
        krows += head_rows
        print(f"phase 29 ({smi}); {held_gb()}")
        torch.cuda.empty_cache()

        # 30. LM training: qwen2-1.5b with AdamW through launch.train and a
        # resume, the hybrid DFW-Trace head on codeqwen1.5-7b, rwkv6-7b;
        # the bf16 rank-1 update and the matvecs at the head's shape
        report["train"], train_launch, train_bf16, train_rows = train_phase(
            torch, np, kernels, lm, steps, train_mod, hybrid, adamw, data, ShapeSpec,
            power_method, pm, r1, get_config, dev, args, peaks)
        krows += train_rows
        print(f"phase 30 ({smi})")
        torch.cuda.empty_cache()

        # 31. serving of the LM zoo's audio, vlm and hybrid families at full
        # width: hubert-xlarge's encoder step, zamba2-2.7b and qwen2-vl-72b
        # (32 of 80 layers) prefill and captured decode; flash_attention at
        # their operands
        report["families"], families_launch, families_rows = families_phase(
            torch, np, kernels, lm, steps, lm_serve, fa, mamba2, get_config, dev, args, peaks)
        krows += families_rows
        print(f"phase 31 ({smi})")
        torch.cuda.empty_cache()

        # 32. serving of the moe family at full width: arctic-480b (2 of 35
        # layers) and llama4-scout (16 of 48) prefill and captured decode;
        # moe_block on the card against the CPU; flash_attention at their
        # GQA groups of 7 and 5
        report["moe"], moe_launch, moe_rows = moe_phase(
            torch, np, kernels, lm, steps, lm_serve, fa, moe, get_config, dev, args, peaks)
        krows += moe_rows
        print(f"phase 32 ({smi})")
        torch.cuda.empty_cache()

        # 33. the sharded LM paths: a (1, 1) mesh over one NCCL worker, then
        # a (2, 2) mesh on four gloo workers sharing the card
        report["mesh"], mesh_launch, mesh_rows = mesh_phase(
            torch, np, kernels, lm, steps, train_mod, comm, dfw, fa, wkv, get_config, dev, args,
            peaks)
        krows += mesh_rows
        print(f"phase 33 ({smi})")
        torch.cuda.empty_cache()

        # 34. LM training of the moe, hybrid, vlm and audio families:
        # hubert-xlarge and zamba2-2.7b whole, qwen2-vl-72b (2 of 80 layers)
        # with AdamW through launch.train; llama4-scout (1 of 48) with the
        # hybrid DFW head and a resume; each family card against CPU; the
        # head's kernels at llama4-scout's head
        report["family_train"], ftrain_launch, ftrain_bf16, ftrain_rows = family_train_phase(
            torch, kernels, lm, train_mod, hybrid, data, ShapeSpec, moe, pm, r1, get_config, dev,
            args, peaks)
        krows += ftrain_rows
        train_bf16 += ftrain_bf16
        print(f"phase 34 ({smi})")
    except Check as e:
        return fail(str(e))

    out = []
    paths = (mtls_launch, log_launch, mc_launch, mc8_launch, fit12_launch, serve_launch,
             prefill_launch, decode_launch, ssm_prefill_launch, ssm_decode_launch,
             world_one_launch, multi_launch, baselines_launch, graphs_launch, block_launch,
             resume_launch, engine_launch, telemetry_launch, head_launch, train_launch,
             families_launch, moe_launch, mesh_launch, ftrain_launch)
    for kname in (*TPU_KERNEL, *HELPER_KERNELS, *BLOCK_KERNELS, "update_resid_block",
                  "rank1_update_bf16"):
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
        elif kname == "rank1_update_bf16":  # a route of the rank1_update wrapper
            launches = train_bf16
        else:
            launches = sum(path[kname] for path in paths) - (
                block_route if kname == "update_resid" else 0) - (
                train_bf16 if kname == "rank1_update" else 0)
        out.append(dict(
            name=kname, route="cuda", source=SOURCE[kname], replaces=replaces, **helper,
            launches=launches,
            max_abs_err=main_row["max_abs_err"], max_rel_err=main_row["max_rel_err"],
            ms=main_row["ms"], plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
            shape=main_row["shape"],
            by_operand={r["operand"]: {k: r[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "library_rel_err", "library_chain_ms",
                "library_ratio", "library_chain_ratio", "ms_rounds", "library_ms_rounds",
                "library_chain_ms_rounds", "exact_ms", "bound_ms", "bound_f32_cores_ms", "bound_by",
                "max_rel_err", "device_ms", "random_floor_ms", "random_floor_with_passes_ms",
                "gather_floor_ms")
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
