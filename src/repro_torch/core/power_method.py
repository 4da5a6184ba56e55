"""Power method on the implicit gradient (paper Alg. 2, lines 5-10).

The paper's workers send ``grad_j @ v`` to a master that sums and broadcasts;
here every aggregate goes through the comm chokepoint (``comm.base``): an
all-reduce over the workers' process group, the identity for one process.
Only O(d+m) vectors cross the wire.
The ``reducer`` slot takes a reducer or a topology (``comm.topology``):
under a gossip graph every worker ends with its own estimate of u, v and
sigma. A reducer with a stochastic encoding (int8) draws each exchange's noise from
a ``repro_torch.NoiseStream`` at (epoch t, iteration i, slot).

``block_power_iterations`` is the block solver's rank-k form: (d, k) and
(m, k) blocks, flattened through the same reducer (so the encodings compose
unchanged), Cholesky-QR orthonormalized against their (k, k) Gram on the
already-summed block, still exactly 2K exchanges for K iterations.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..comm.base import DenseReducer, WorkerGroup, pmax

_EPS = 1e-30


class PowerResult(NamedTuple):
    """Top singular triple estimate after K two-sided power iterations."""

    u: torch.Tensor  # (d,) left singular vector estimate, unit norm
    v: torch.Tensor  # (m,) right singular vector estimate, unit norm
    sigma: torch.Tensor  # () top singular value estimate (= ||A^T u|| >= 0)


class BlockPowerResult(NamedTuple):
    """Top-k singular block estimate after K block power iterations.

    ``u``/``v`` columns pair up as rank-1 atoms (``u_j^T A v_j = sigma_j``);
    ``probe`` is the orthonormalized right block, the next epoch's warm
    start. ``iters`` counts the iterations that ran (< K when the adaptive
    stop fired), a host int (the loop runs on the host)."""

    u: torch.Tensor  # (d, k) left block, orthonormal columns
    v: torch.Tensor  # (m, k) right block, unit columns (atom directions)
    sigma: torch.Tensor  # (k,) singular value estimates (unordered, >= 0)
    probe: torch.Tensor  # (m, k) orthonormal right block (warm-start carry)
    iters: int  # iterations executed


def sphere_vector(gen: torch.Generator, m: int, device, dtype=torch.float32) -> torch.Tensor:
    """Uniform random vector on the unit (m-1)-sphere, drawn from ``gen``."""
    v = torch.randn(m, generator=gen, device=device, dtype=dtype)
    return v / (torch.linalg.vector_norm(v) + _EPS)


def power_iterations(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    num_iters: int,
    *,
    reducer: Optional[DenseReducer] = None,
    comm_state=(),
    noise=None,
    t: int = 0,
    worker_weight: Optional[float] = None,
):
    """Run ``num_iters`` two-sided power iterations on the implicit operator.

    ``matvec(v)``/``rmatvec(u)`` compute this worker's ``A_j v`` / ``A_j^T
    u``; each is summed over workers by ``reducer.exchange`` and normalized.
    ``sigma = ||A^T u||`` is the norm of the *last* aggregated ``rmatvec``,
    carried out of the loop and never recomputed, so K iterations make
    exactly 2K exchanges. The two-sided iteration gives ``u^T A v = sigma >=
    0``, so the trace-norm LMO is ``-mu u v^T`` with no sign fix.

    ``noise`` (a ``NoiseStream``, or None for encodings without randomness)
    and the epoch ``t`` give exchange (i, slot) its noise ``noise(t, i,
    slot, dim, device)``.

    ``worker_weight`` is this worker's straggler weight for the epoch: its
    contributions are ``w * matvec(v)`` and ``w * rmatvec(u)`` (0 for a
    worker left out, N / alive for the others under reweighting), as in the
    reference. ``None`` means full participation and multiplies by nothing.
    The weight also goes to ``exchange``: a stateful reducer (top-k) must
    know a worker that was left out, whose contribution is zero but whose
    residual is not.

    Returns ``(PowerResult, comm_state)``.
    """
    if num_iters < 1:
        raise ValueError(
            f"num_iters={num_iters}: power_iterations needs >= 1 iteration "
            "(0 returns u=0, sigma=0 and silently corrupts the caller)"
        )
    if reducer is None:
        reducer = DenseReducer()

    def draw(i, slot):
        return None if noise is None else partial(noise, t, i, slot)

    def weighted(x):
        return x if worker_weight is None else worker_weight * x

    v = v0
    for i in range(num_iters):
        uu, comm_state = reducer.exchange(
            weighted(matvec(v)), comm_state, slot="u", noise=draw(i, "u"), weight=worker_weight)
        u = uu / (torch.linalg.vector_norm(uu) + _EPS)
        vv, comm_state = reducer.exchange(
            weighted(rmatvec(u)), comm_state, slot="v", noise=draw(i, "v"), weight=worker_weight)
        sigma = torch.linalg.vector_norm(vv)
        v = vv / (sigma + _EPS)
    return PowerResult(u=u, v=v, sigma=sigma), comm_state


def block_collective_rounds_contract(num_iters: int, k: int, topology=None) -> dict:
    """The block iteration's communication budget: K iterations make exactly
    2K exchanges whatever k is (the Gram orthogonalization runs on the
    already-summed block), each k times as wide. ``collective_counts`` holds
    the collectives of those 2K exchanges: one all-reduce each on a flat
    graph, the graph's own counts (``collective_counts``) with a topology."""
    if topology is not None:
        return dict(name=f"power_method.block_collective_rounds[K={num_iters},k={k},"
                         f"topology={topology.spec}]",
                    exchanges=2 * num_iters,
                    collective_counts=topology.collective_counts(2 * num_iters))
    return dict(name=f"power_method.block_collective_rounds[K={num_iters},k={k}]",
                exchanges=2 * num_iters, collective_counts={"all-reduce": 2.0 * num_iters})


def orthonormalize_block(b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The columns of ``b`` (n, k) orthonormalized by Cholesky-QR on the
    (k, k) Gram, with the reference's jitter ``eps * trace(G) / k + 1e-30``
    (rank-deficient blocks stay factorizable; a zero block maps to a zero
    block), then one triangular solve. The factorization does not check
    its result on the device (no host sync)."""
    k = b.shape[-1]
    g = b.T @ b
    jitter = eps * (torch.trace(g) / k) + 1e-30
    chol = torch.linalg.cholesky_ex(
        g + jitter * torch.eye(k, dtype=b.dtype, device=b.device)).L
    # B inv(L)^T through one triangular solve of the (k, n) system; row-major
    # (n, k) out, as the kernels take it
    return torch.linalg.solve_triangular(chol, b.T, upper=False).T.contiguous()


def block_power_step(
    matmat: Callable[[torch.Tensor], torch.Tensor],
    rmatmat: Callable[[torch.Tensor], torch.Tensor],
    q: torch.Tensor,
    *,
    reduce: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
) -> tuple:
    """One warm-started step of block power iteration: ``p = orth(reduce(A
    q)); q' = reduce(A^T p)``; returns ``(p, q')``. The primitive the block
    LMO shares with PowerSGD compression (``reduce``: the aggregate, the
    identity in one process)."""
    p = orthonormalize_block(reduce(matmat(q)))
    return p, reduce(rmatmat(p))


def block_power_iterations(
    matmat: Callable[[torch.Tensor], torch.Tensor],
    rmatmat: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    num_iters: int,
    *,
    reducer: Optional[DenseReducer] = None,
    comm_state=(),
    noise=None,
    t: int = 0,
    worker_weight: Optional[float] = None,
    adapt_rtol: Optional[float] = None,
    adapt_ref: Optional[torch.Tensor] = None,
    agree: Optional[WorkerGroup] = None,
):
    """Block power iteration on the implicit operator: (d, k)/(m, k) blocks
    in place of vectors, the rank-k LMO of the block:k solver (BlockFW,
    arXiv:1708.02105).

    Per iteration: the local block matmat is exchanged flattened (d*k,)
    through ``reducer`` (slot u), Cholesky-QR orthonormalized, the block
    rmatmat exchanged (slot v), per-column sigmas read off it, and the
    result orthonormalized for the next round: exactly 2 exchanges an
    iteration, each k times a vector's width. Exchange (i, slot) draws
    ``noise(t, i, slot, d*k or m*k, device)``. ``v0`` (m, k) is the start
    block (re-orthonormalized here).

    ``adapt_rtol`` turns on the adaptive stop: once the largest per-column
    sigma change of an iteration is at most ``adapt_rtol * (max(adapt_ref,
    max sigma) + 1e-30)``, the remaining iterations are skipped. The
    reference makes them ``lax.cond`` no-ops; here the host reads the
    verdict after every iteration and leaves the loop (one host sync an
    iteration). Every worker must take the
    same branch: where the workers' blocks may part (``agree``, a group
    whose exchange leaves each worker its own sums), the verdict is the
    workers' (one all-reduce MAX of "not done": all stop together, when the
    last one is done).

    Returns ``(BlockPowerResult, comm_state)``.
    """
    if num_iters < 1:
        raise ValueError(
            f"num_iters={num_iters}: block_power_iterations needs >= 1 iteration "
            "(0 returns a zero block and corrupts the caller)"
        )
    if v0.dim() != 2:
        raise ValueError(f"v0 must be (m, k), got shape {tuple(v0.shape)}")
    if reducer is None:
        reducer = DenseReducer()
    m, k = v0.shape

    def draw(i, slot):
        return None if noise is None else partial(noise, t, i, slot)

    def weighted(x):
        return x if worker_weight is None else worker_weight * x

    v = orthonormalize_block(v0)
    sigma = torch.zeros(k, dtype=torch.float32, device=v0.device)
    iters = 0
    for i in range(num_iters):
        local = weighted(matmat(v))
        d = local.shape[0]
        uu, comm_state = reducer.exchange(
            local.reshape(-1), comm_state, slot="u", noise=draw(i, "u"), weight=worker_weight)
        u = orthonormalize_block(uu.reshape(d, k))
        vv, comm_state = reducer.exchange(
            weighted(rmatmat(u)).reshape(-1), comm_state, slot="v", noise=draw(i, "v"),
            weight=worker_weight)
        vv = vv.reshape(m, k)
        sig = torch.linalg.vector_norm(vv, dim=0)
        v_atoms = vv / (sig[None, :] + _EPS)
        v = orthonormalize_block(vv)
        iters += 1
        done = None
        if adapt_rtol is not None:
            ref = torch.max(sig)
            if adapt_ref is not None:
                ref = torch.maximum(ref, adapt_ref)
            done = torch.max(torch.abs(sig - sigma)) <= adapt_rtol * (ref + _EPS)
            if agree is not None:
                done = pmax((~done).to(torch.float32), agree) == 0
        sigma = sig
        if done is not None and bool(done):
            break
    return BlockPowerResult(u=u, v=v_atoms, sigma=sigma, probe=v, iters=iters), comm_state
