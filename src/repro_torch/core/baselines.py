"""Baseline distributed FW strategies from the paper's §3.1, the port's copy
of the JAX package's ``core/baselines.py``.

NAIVE-DFW : sum the full dense d x m local gradients over the workers
            (O(N d m) communication), then solve the LMO exactly on the sum.
SVA       : each worker solves the LMO on its *local* gradient and the
            workers average the singular vectors (n_j-weighted, sign-fixed):
            O(N (d + m)) communication, but biased (no convergence
            guarantee).

Both share the FW update and bookkeeping with the main driver, so their
curves compare with DFW-Trace's epoch for epoch. An epoch is ``epoch(state,
iterate, t, key, worker_weight=None) -> (state, iterate, EpochAux)``, the
reference's signature (``key`` and ``worker_weight`` are unused, as there);
``group`` (a ``comm.WorkerGroup``, None: one process) takes the place of
the reference's ``axis_name``, and every sum goes through ``comm.psum``, so
the worker group's byte counters count NAIVE's d x m sum.

The exact LMO is ``torch.linalg.svd`` (the reference calls
``jnp.linalg.svd``, not a kernel). LAPACK and cuSOLVER may return a
singular pair with either sign; NAIVE's ``u * sign(u^T g v)`` and SVA's
``_sign_fix`` make the update independent of that sign. The task's
``update`` consumes its state, as in ``core.frank_wolfe``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..comm.base import WorkerGroup, psum
from . import low_rank
from .frank_wolfe import EpochAux
from .trace_norm import default_step_size, duality_gap


def _exact_top_pair(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact LMO via SVD (the 'master' computation of NAIVE-DFW)."""
    u, s, vt = torch.linalg.svd(g, full_matrices=False)
    return u[:, 0].contiguous(), vt[0, :].contiguous(), s[0]


def _sign_fix(vec: torch.Tensor) -> torch.Tensor:
    """Resolve the SVD's sign ambiguity: make the largest-|entry| positive
    (Bro et al., 2008); the first such entry among ties, as ``jnp.argmax``."""
    i = torch.argmax(torch.abs(vec))
    return vec * torch.sign(vec[i])


def _sums(group: Optional[WorkerGroup], *local: torch.Tensor):
    """The workers' sums of the local scalars, in one all-reduce."""
    if group is None:
        return local
    return tuple(psum(torch.stack(local), group).unbind())


def _step(task, state, u, v, t, mu: float, step_size: str, group) -> torch.Tensor:
    if step_size == "linesearch":
        numer, denom = _sums(group, *task.linesearch_terms(state, u, v, mu))
        return torch.clamp(numer / torch.clamp(denom, min=1e-30), 0.0, 1.0)
    return default_step_size(t)


def _check(task, step_size: str) -> None:
    if step_size not in ("default", "linesearch"):
        raise ValueError(step_size)
    if step_size == "linesearch" and not hasattr(task, "linesearch_terms"):
        raise ValueError(f"{type(task).__name__} has no closed-form line search")


def make_naive_epoch_step(task, mu: float, *, step_size: str = "default",
                          group: Optional[WorkerGroup] = None) -> Callable:
    """NAIVE-DFW epoch. The sum of ``local_grad`` over the workers IS the
    O(dm) cost."""
    _check(task, step_size)

    def epoch(state, it, t, key=None, worker_weight=None):
        device = it.alpha.device
        t = torch.full((), float(t), dtype=torch.float32, device=device)
        g = psum(task.local_grad(state), group)  # (d, m): the expensive hop
        u, v, sigma = _exact_top_pair(g)
        # Two-sided convention u^T g v >= 0 so that S* = -mu u v^T:
        u = u * torch.sign(u @ g @ v)
        del g

        loss, inner = _sums(group, task.local_loss(state), task.inner_w_grad(state))
        gap = duality_gap(inner, sigma, mu)
        gamma = _step(task, state, u, v, t, mu, step_size, group)

        state = task.update(state, u, v, gamma, mu)
        it = low_rank.fw_update(it, u, v, gamma, mu)
        return state, it, EpochAux(loss=loss, gap=gap, sigma=sigma, gamma=gamma,
                                   piters=torch.zeros((), dtype=torch.float32, device=device))

    return epoch


def make_sva_epoch_step(task, mu: float, *, step_size: str = "default",
                        group: Optional[WorkerGroup] = None,
                        local_weight: Optional[float] = None) -> Callable:
    """SVA epoch. ``local_weight`` is n_j; its default is the local
    gradient's first dimension, which is d (the reference's default, kept
    as it is); the vectors are weight-averaged after sign fixing."""
    _check(task, step_size)

    def epoch(state, it, t, key=None, worker_weight=None):
        device = it.alpha.device
        t = torch.full((), float(t), dtype=torch.float32, device=device)
        g_local = task.local_grad(state)
        n_j = float(np.float32(local_weight if local_weight is not None else g_local.shape[0]))
        u_j, v_j, _ = _exact_top_pair(g_local)
        del g_local
        u_j, v_j = _sign_fix(u_j), _sign_fix(v_j)

        u = psum(n_j * u_j, group)
        v = psum(n_j * v_j, group)
        u = u / (torch.linalg.vector_norm(u) + 1e-30)
        v = v / (torch.linalg.vector_norm(v) + 1e-30)
        # sigma estimate for the gap: u^T (sum_j g_j) v via the matvec chain;
        # the reference writes the same summed matvec twice (one value)
        gv = psum(task.matvec(state, v), group)
        sigma = torch.abs(torch.dot(u, gv))
        # orient the averaged pair so u^T A v >= 0
        u = u * torch.sign(torch.dot(u, gv))

        loss, inner = _sums(group, task.local_loss(state), task.inner_w_grad(state))
        gap = duality_gap(inner, sigma, mu)
        gamma = _step(task, state, u, v, t, mu, step_size, group)

        state = task.update(state, u, v, gamma, mu)
        it = low_rank.fw_update(it, u, v, gamma, mu)
        return state, it, EpochAux(loss=loss, gap=gap, sigma=sigma, gamma=gamma,
                                   piters=torch.zeros((), dtype=torch.float32, device=device))

    return epoch
