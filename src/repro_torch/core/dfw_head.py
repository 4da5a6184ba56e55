"""DFW-Trace as a feature of the framework: a trace-norm-constrained
classification head on a frozen backbone's features, the port's
counterpart of ``repro.core.dfw_head``.

This is the paper's ImageNet experiment (features from a frozen deep network
-> a multinomial-logistic head under ||W||_* <= mu) with the LM zoo as the
backbone: ``extract_features`` takes d_model features per token from
``models.lm.forward(..., mode="hidden")``, and DFW-Trace learns the (d, m)
head. The head after T epochs has rank <= T, stored in factored form, and
``top_k_error`` (the paper's top-5 error) scores it through the
``factor_matvec`` kernel without forming W.

``train_head`` is the one-process fit, ``sharded_fit`` this process's part
of a fit over a ``comm.WorkerGroup`` (its rows of the samples; every
aggregate summed over the workers), with checkpoints and resume. Both run
the task through ``launch.dfw.kernelize``, so on the card the power
method's matvecs and the update run on the ``power_matvec`` and
``rank1_update`` kernels; on the CPU the same code takes their plain
versions. Every entry point runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch

from .. import DeviceLike, as_v0_stream, resolve_device
from ..comm.base import WorkerGroup, psum
from ..models import lm
from . import engine, frank_wolfe, low_rank, tasks


def extract_features(params, batches: Iterable[Dict[str, torch.Tensor]], cfg, *,
                     max_tokens: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen-backbone features: ``(X (n, d_model) float32, y (n,))`` from
    each batch's ``tokens`` (its hidden states after the final norm, one row
    a token) and ``labels``, on the parameters' device; the first
    ``max_tokens`` rows when given. ``lm.check_family`` refuses the
    families the port does not run."""
    feats, labels = [], []
    for batch in batches:
        h = lm.forward(params, batch, cfg, mode="hidden")["hidden"]  # (B, S, D)
        b, s, d = h.shape
        feats.append(h.reshape(b * s, d))
        labels.append(torch.as_tensor(batch["labels"]).reshape(-1).to(h.device))
    x, y = torch.cat(feats), torch.cat(labels)
    if max_tokens is not None:
        x, y = x[:max_tokens], y[:max_tokens]
    return x.float(), y


@dataclasses.dataclass
class HeadFitResult:
    iterate: low_rank.FactoredIterate  # factored head, rank <= epochs
    history: Dict[str, list]  # pre-update per-epoch trajectory
    final_loss: float = float("nan")  # loss of the returned head

    def head_matrix(self) -> torch.Tensor:
        """Dense W (d, m): O(d m) memory, for tests and small heads."""
        return low_rank.materialize(self.iterate)


def train_head(x, y, num_classes: int, *, mu: float = 30.0, num_epochs: int = 50,
               schedule: str = "const:2", key=None, device: DeviceLike = None
               ) -> HeadFitResult:
    """One-process DFW-Trace head fit (the paper's Fig. 3 setting) on
    ``device`` (CUDA unless "cpu" is given): ``tasks.MultinomialLogistic``
    on features ``x`` (n, d) and int labels ``y`` (n,), tensors or numpy
    arrays, step size 2/(t+2). ``key`` is an int seed or a ``V0Stream``
    (default seed 0). It gives ``launch.dfw.fit_serial``'s bits on the same
    config: the same engine, kernels and draws."""
    from ..launch import dfw  # launch.dfw builds on core

    dev = resolve_device(device)
    ktask = dfw.kernelize(tasks.MultinomialLogistic(d=x.shape[1], m=num_classes))
    state = ktask.init_state(dfw._as_tensor(x, dev), dfw._as_tensor(y, dev))
    res = frank_wolfe.fit(ktask, state, mu=mu, num_epochs=num_epochs,
                          key=0 if key is None else key, schedule=schedule,
                          step_size="default", device=dev)
    return HeadFitResult(iterate=res.iterate, history=res.history, final_loss=res.final_loss)


def sharded_fit(group: Optional[WorkerGroup], x, y, num_classes: int, *, mu: float = 30.0,
                num_epochs: int = 20, schedule: str = "const:2", key=None,
                gap_tol: Optional[float] = None, block_epochs: Optional[int] = None,
                checkpointer=None, resume=None, device: DeviceLike = None) -> HeadFitResult:
    """DFW-Trace with the samples sharded over the workers of ``group`` (a
    ``comm.WorkerGroup``; None: one process): this process's part of the
    run, on ``device`` (CUDA unless "cpu" is given). Every worker passes the
    whole data set and the same arguments and keeps its contiguous rows
    ``[j n/N, (j+1) n/N)`` (n must be divisible by N: ``ValueError``); an
    epoch's traffic is 2K all-reduces of d and m floats. ``gap_tol`` stops
    on the duality-gap certificate; ``block_epochs`` cuts the run into
    segments of at most that many epochs.

    ``checkpointer`` (a ``checkpoint.RunCheckpointer`` over the run's
    directory, passed on every worker) saves segment boundaries: worker 0
    writes the whole state, gathered from the workers, and first removes
    the steps after the run's start (the directory is this run's timeline);
    every worker returns once the writes have landed. ``resume`` (a
    ``checkpoint.RunSnapshot``, e.g. ``checkpoint.restore_run(dir,
    task=tasks.MultinomialLogistic(d, m))``) continues a fit from its epoch:
    each worker takes its rows of the saved state, so another worker count
    is the elastic path; the run continues with the checkpoint's seed unless
    ``key`` is a table-fed ``V0Stream``. A snapshot at or past the budget
    returns it without running an epoch (its loss summed over the group).
    """
    from ..launch import dfw  # launch.dfw builds on core

    dev = resolve_device(device)
    workers, rank = (1, 0) if group is None else (group.size, group.rank)
    n = x.shape[0]
    if n % workers:
        raise ValueError(f"leading dim {n} not divisible by {workers} workers; pad or trim the "
                         "sample axis before sharding")
    task = tasks.MultinomialLogistic(d=x.shape[1], m=num_classes)
    ktask = dfw.kernelize(task)
    key = as_v0_stream(0 if key is None else key)
    iterate, start_t, initial_history = None, 0, None
    if resume is None:
        lo, hi = rank * (n // workers), (rank + 1) * (n // workers)
        state = ktask.init_state(dfw._as_tensor(x[lo:hi], dev), dfw._as_tensor(y[lo:hi], dev))
    else:
        dfw._check_problem(resume, task)
        # the capacity holds the checkpoint's live factors even past the budget
        start = dfw._place(resume, task, dfw.DFWConfig(
            mu=mu, num_epochs=num_epochs, schedule=schedule,
            max_rank=engine.resolve_max_rank(None, max(num_epochs, resume.t))),
            key, dev, rank=rank, workers=workers, serial=False)
        state, iterate, key = start.state, start.iterate, start.key
        start_t, initial_history = start.t, start.history
        if start_t >= num_epochs:
            return HeadFitResult(iterate=iterate, history=start.history,
                                 final_loss=float(psum(task.local_loss(state), group)))
    ckp = None
    if checkpointer is not None:
        if rank == 0:
            checkpointer.store.discard_after(start_t)
        ckp = dfw._WorkerCheckpointer(checkpointer if rank == 0 else None, group,
                                      checkpointer.save_every, num_epochs, workers)
    res = frank_wolfe.fit(ktask, state, mu=mu, num_epochs=num_epochs, key=key,
                          schedule=schedule, step_size="default", gap_tol=gap_tol,
                          block_epochs=block_epochs, iterate=iterate, start_t=start_t,
                          initial_history=initial_history, checkpointer=ckp, device=dev,
                          group=group)
    if ckp is not None:
        ckp.wait()
        if group is not None:  # worker 0's writes have landed on every worker's return
            group.all_reduce(torch.zeros(1, device=dev))
    return HeadFitResult(iterate=res.iterate, history=res.history, final_loss=res.final_loss)


def top_k_hits(logits: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """(b,) bool: is label ``y[i]`` among the k largest of ``logits[i]``,
    with ``jax.lax.top_k``'s rule among equal logits (the lower index
    first)? Under that rule the label's place in the row's order is the
    count of logits above its own plus the count of equal ones at lower
    indices, so it is a hit when that count is below k: two comparisons
    with the label's logit, no sort and no ``torch.topk`` (which promises no
    order among ties)."""
    if not 1 <= k <= logits.shape[1]:
        raise ValueError(f"k = {k} is outside 1..{logits.shape[1]}")
    y = y.to(device=logits.device, dtype=torch.int64)[:, None]
    gold = torch.gather(logits, 1, y)
    cols = torch.arange(logits.shape[1], device=logits.device)
    ahead = (logits > gold) | ((logits == gold) & (cols < y))
    return ahead.sum(dim=1) < k


def top_k_error(it: low_rank.FactoredIterate, x: torch.Tensor, y: torch.Tensor,
                k: int = 5) -> float:
    """The paper's top-k misclassification rate of the factored head on
    features ``x`` (n, d) and labels ``y`` (n,): a row is a hit when its
    label is among its k largest logits, ties broken as the reference's
    ``jax.lax.top_k`` breaks them (``top_k_hits``). The logits come from
    ``low_rank.right_multiply`` (the ``factor_matvec`` kernel on the card)
    one chunk of ``low_rank.RIGHT_MULTIPLY_ROWS`` rows at a time, so the (n,
    m) logits are never all on the device at once. The rate is 1 - hits / n
    in f32, as the reference takes it."""
    rows = low_rank.RIGHT_MULTIPLY_ROWS
    n = x.shape[0]
    hits = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, n, rows):
        hits += top_k_hits(low_rank.right_multiply(it, x[lo:lo + rows]), y[lo:lo + rows],
                           k).sum()
    return float(1.0 - hits.to(torch.float32) / n)
