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

``power_method_dense`` and ``top_singular_pair`` run the same iteration on
an explicit row-major matrix (NAIVE-DFW's oracle, the tests' SVD check):
A v and A^T u go through ``power_matvec``'s kernels on the card.

Nothing here reads the device from the host. The adaptive stop's branch is
a ``when(pred, body)`` seam: a host branch by default, an IF node of the
engine's CUDA graph when the engine captures the epoch.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import torch

from ..analysis import recorder
from ..comm.base import DenseReducer, WorkerGroup, pmax
from ..kernels.power_matvec import ops as pm_ops

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
    stop fired), a 0-d float32 device tensor."""

    u: torch.Tensor  # (d, k) left block, orthonormal columns
    v: torch.Tensor  # (m, k) right block, unit columns (atom directions)
    sigma: torch.Tensor  # (k,) singular value estimates (unordered, >= 0)
    probe: torch.Tensor  # (m, k) orthonormal right block (warm-start carry)
    iters: torch.Tensor  # () float32, iterations executed


def sphere_vector(gen: torch.Generator, m: int, device, dtype=torch.float32) -> torch.Tensor:
    """Uniform random vector on the unit (m-1)-sphere, drawn from ``gen``."""
    v = torch.randn(m, generator=gen, device=device, dtype=dtype)
    return v / (torch.linalg.vector_norm(v) + _EPS)


def host_when(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """``body()`` if the 0-d bool ``pred`` holds: the ``when`` seam as a
    host branch (a device read on a CUDA tensor; none on the CPU). An open
    ``analysis.recorder.OpRecorder`` takes the read as a branch read and
    marks the body's ops conditional."""
    with recorder.branch():
        take = bool(pred)
    if take:
        with recorder.conditional():
            body()


def collective_rounds_contract(num_iters: int, topology=None):
    """The paper's communication budget as a checkable contract: K
    two-sided power iterations run exactly 2K all-reduces (one a matvec
    side), never 2K + 1: the carried sigma. ``analysis.contracts.
    verify_declared`` and the tests check it against the op log of
    ``power_iterations`` over a gloo group. With a ``topology``
    (``comm.Topology``) the 2K exchanges go over that graph, and the
    contract pins its own profile (``Topology.collective_contract``)."""
    from ..analysis.contracts import Contract

    if topology is not None:
        return topology.collective_contract(
            2 * num_iters,
            name=f"power_method.collective_rounds[K={num_iters},topology={topology.spec}]")
    return Contract(name=f"power_method.collective_rounds[K={num_iters}]",
                    collective_counts={"all-reduce": 2.0 * num_iters})


def block_collective_rounds_contract(num_iters: int, k: int, topology=None):
    """``collective_rounds_contract`` of the block form: K block iterations
    still run exactly 2K all-reduces, the (k, k) Gram orthogonalization
    working on the already-summed block; ``k`` widens each payload, never
    the round count."""
    from ..analysis.contracts import Contract

    if topology is not None:
        return topology.collective_contract(
            2 * num_iters,
            name=(f"power_method.block_collective_rounds[K={num_iters},k={k},"
                  f"topology={topology.spec}]"))
    return Contract(name=f"power_method.block_collective_rounds[K={num_iters},k={k}]",
                    collective_counts={"all-reduce": 2.0 * num_iters})


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


def power_method_dense(a: torch.Tensor, v0: torch.Tensor, num_iters: int, *,
                       group: Optional[WorkerGroup] = None) -> PowerResult:
    """``num_iters`` two-sided power iterations on an explicit (n, m) f32
    matrix ``a`` from the start vector ``v0`` (m,): A v and A^T u by the
    ``power_matvec`` kernels on a CUDA tensor (their plain versions on the
    CPU). With a ``group`` each worker holds its own part A_j, of the same
    shape, and the iteration runs on their sum (the gradient summed over
    the workers' samples): every aggregate is summed over the workers
    (``DenseReducer``), the counterpart of the reference's ``axis_name``."""
    res, _ = power_iterations(lambda v: pm_ops.matvec(a, v), lambda u: pm_ops.rmatvec(a, u),
                              v0, num_iters, reducer=DenseReducer(group))
    return res


def top_singular_pair(a: torch.Tensor, gen_or_seed: Union[torch.Generator, int, None] = 0,
                      num_iters: int = 50, *, v0: Optional[torch.Tensor] = None
                      ) -> PowerResult:
    """Serial oracle: the top singular triple of ``a`` after ``num_iters``
    power iterations from a uniform unit start vector drawn from
    ``gen_or_seed`` (a ``torch.Generator`` on ``a``'s device, or a seed), or
    from ``v0`` when given (the tests inject the reference's
    ``sphere_vector``)."""
    if v0 is None:
        gen = gen_or_seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=a.device)
            gen.manual_seed(int(gen_or_seed or 0))
        v0 = sphere_vector(gen, a.shape[1], a.device, a.dtype)
    elif not isinstance(v0, torch.Tensor):  # a host array: copied
        v0 = torch.tensor(v0, dtype=a.dtype)
    return power_method_dense(a, v0.to(device=a.device, dtype=a.dtype), num_iters)


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
    LMO shares with ``optim.compression`` (``reduce``: the aggregate, the
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
    when: Callable[[torch.Tensor, Callable[[], None]], None] = host_when,
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
    max sigma) + 1e-30)``, the remaining iterations are skipped. As the
    reference's ``lax.cond`` does, each iteration after the first runs
    under ``when(~stopped, body)`` (default :func:`host_when`), with
    ``stopped`` and the count ``iters`` on the device; the body writes the
    blocks, the sigmas, the flag, the count and the reducer state in place.
    Every worker must take the
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

    def iteration(i, v, sigma, comm_state):
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
        done = None
        if adapt_rtol is not None:
            ref = torch.max(sig)
            if adapt_ref is not None:
                ref = torch.maximum(ref, adapt_ref)
            done = torch.max(torch.abs(sig - sigma)) <= adapt_rtol * (ref + _EPS)
            if agree is not None:
                done = pmax((~done).to(torch.float32), agree) == 0
        return [u, v_atoms, orthonormalize_block(vv), sig, comm_state, done]

    sigma = torch.zeros(k, dtype=torch.float32, device=v0.device)
    cur = iteration(0, orthonormalize_block(v0), sigma, comm_state)
    if adapt_rtol is None:
        for i in range(1, num_iters):
            cur = iteration(i, cur[2], cur[3], cur[4])
        iters = torch.full((), float(num_iters), dtype=torch.float32, device=v0.device)
    else:
        # From here the carried values are written in place (iteration 0
        # exchanged both slots, so the reducer state is fresh tensors too):
        # a body that does not run leaves them as they are.
        iters = torch.ones((), dtype=torch.float32, device=v0.device)
        stopped = cur[5]
        for i in range(1, num_iters):
            def body(i=i):
                new = iteration(i, cur[2], cur[3], cur[4])
                for old, fresh in zip(cur[:4], new[:4]):
                    old.copy_(fresh)
                if isinstance(new[4], dict):
                    for key, fresh in new[4].items():
                        cur[4][key].copy_(fresh)
                stopped.copy_(new[5])
                iters.add_(1.0)

            when(~stopped, body)
    u, v_atoms, v, sigma, comm_state, _ = cur
    return BlockPowerResult(u=u, v=v_atoms, sigma=sigma, probe=v, iters=iters), comm_state
