"""Paper tasks (§2.3) with Appendix-B *sufficient information* updates.

Each task exposes the implicit-gradient operator interface the FW driver and
the power method consume (the same duck-typed interface as the JAX package):

    init_state(X, Y)       -> state (this worker's rows)
    matvec(state, v)       -> local grad_j @ v        (d,)
    rmatvec(state, u)      -> local grad_j^T @ u      (m,)
    update(state,u,v,g,mu) -> state after W <- (1-g)W - g*mu u v^T
    local_loss(state)      -> local loss contribution ()
    inner_w_grad(state)    -> local <W, grad_j>       ()  (duality gap)
    local_grad(state)      -> dense local gradient    (d, m)  (baselines only)
    linesearch_terms(...)  -> closed-form step terms

``matvec``/``rmatvec`` here are the plain PyTorch operator chains, the oracle
``launch.dfw.verify_kernelized`` holds the kernels to; the run itself routes
them through the ``power_matvec`` kernels (``launch.dfw.KernelizedTask``).
``update`` goes through the ``rank1_update`` kernels (matrix completion:
``mc_matvec.update_resid``) and **consumes its state**: the (n, m)
residual or logits, or the residual's three p-length copies, are updated
in place, which saves those buffers per epoch and lets the engine's CUDA
graphs write the run's own tensors. Reductions over (n, m) run over row chunks, so the
temporaries stay bounded at any n.

Matrix completion keeps its observed entries in COO layout (``MCState``);
its matvecs go through the ``mc_matvec`` kernel along row- and column-sorted
entry orders built once per run, reading copies of the residual kept in
each order, and its per-entry update, loss, <W, grad> and line search stay
plain PyTorch, as they stay plain XLA in the JAX package. ``local_grad``
forms the d x m gradient that only the NAIVE-DFW and SVA baselines
(``core.baselines``) read: plain f32 products (the reference computes them
outside any kernel), and every sum in a fixed order, so a run repeats its
bits on the card.

**Block atoms** (the block:k solver): ``u`` (d, k) with the blend weights
folded into its columns and ``v`` (m, k) stand for the atom ``u v^T``, as
the JAX package's ``_uvt``/block ``_entrywise_uv`` read them; a 1-D atom
keeps the rank-1 path and its bits. The dense tasks' block update goes
through the ``power_matvec.matmat`` and ``rankk_update(_axpy)`` kernels,
matrix completion's through ``update_resid`` with block factors, which also
gives MC's line search the block atom on the entries, never forming a (p,
k) array (``linesearch_terms``).

``MultiTaskLeastSquaresDense`` keeps the dense sufficient information (X^T
X, X^T Y and the gradient) in plain f32 products, as the reference does
outside any kernel. It is an operator only: it has no ``local_loss`` or
``inner_w_grad``, so ``fit_serial`` and ``fit`` refuse it, as the
reference's cannot run it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from ..kernels.mc_matvec import ops as mc_ops
from ..kernels.mc_matvec import ref as mc_ref
from ..kernels.power_matvec import ops as pm_ops
from ..kernels.rank1_update import ops as r1_ops

_CHUNK_ELEMS = 1 << 26  # elements per row chunk in the (n, m) reductions


def _row_chunked_sum(fn: Callable[..., torch.Tensor], *mats: torch.Tensor) -> torch.Tensor:
    """sum over row chunks c of fn(*[mat[c] for mat in mats]), on the device."""
    n = mats[0].shape[0]
    step = max(1, _CHUNK_ELEMS // max(1, mats[0][0].numel() if n else 1))
    total = fn(*(mat[:step] for mat in mats))
    for lo in range(step, n, step):
        total = total + fn(*(mat[lo:lo + step] for mat in mats))
    return total


def _uvt(xu: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The atom's action on the sample axis: ``outer(xu, v)`` for a rank-1
    atom, ``xu @ v.T`` for a block atom (the reference's ``_uvt``)."""
    if xu.dim() == 1:
        return torch.outer(xu, v)
    return xu @ v.T


def _xu(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """X u through the kernel: ``matvec`` for a vector, ``matmat`` for a block."""
    return pm_ops.matvec(x, u) if u.dim() == 1 else pm_ops.matmat(x, u)


def _f32(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t


# ---------------------------------------------------------------------------
# Multi-task least squares:  F(W) = 1/2 ||XW - Y||_F^2
# ---------------------------------------------------------------------------


class MTLSState(NamedTuple):
    """Stores the residual R = X W - Y instead of the d x m gradient."""

    x: torch.Tensor  # (n_j, d)
    y: torch.Tensor  # (n_j, m)
    r: torch.Tensor  # (n_j, m) residual X W - Y


@dataclasses.dataclass(frozen=True)
class MultiTaskLeastSquares:
    d: int
    m: int

    def init_state(self, x: torch.Tensor, y: torch.Tensor) -> MTLSState:
        # W^0 = 0  =>  R = -Y
        return MTLSState(x=_f32(x, "x"), y=_f32(y, "y"), r=-y)

    # grad = X^T R ; never materialized.
    def matvec(self, s: MTLSState, v: torch.Tensor) -> torch.Tensor:
        return s.x.T @ (s.r @ v)

    def rmatvec(self, s: MTLSState, u: torch.Tensor) -> torch.Tensor:
        return s.r.T @ (s.x @ u)

    def update(self, s: MTLSState, u, v, gamma, mu) -> MTLSState:
        # R' = X[(1-g)W + g S] - Y = (1-g)R - g Y - g mu (X u) v^T, in place
        # (block atoms: u (d, k) with the blend folded in, v (m, k)).
        xu = _xu(s.x, u)
        update = r1_ops.rank1_update_axpy if u.dim() == 1 else r1_ops.rankk_update_axpy
        r = update(s.r, s.y, xu, v, 1.0 - gamma, -(gamma * mu), -gamma, out=s.r)
        return MTLSState(x=s.x, y=s.y, r=r)

    def local_loss(self, s: MTLSState) -> torch.Tensor:
        return 0.5 * _row_chunked_sum(lambda r: torch.sum(r * r), s.r)

    def inner_w_grad(self, s: MTLSState) -> torch.Tensor:
        # <W, X^T R> = <X W, R> = <R + Y, R>
        return _row_chunked_sum(lambda r, y: torch.sum((r + y) * r), s.r, s.y)

    def local_grad(self, s: MTLSState) -> torch.Tensor:
        """X^T R, (d, m): one f32 product."""
        return s.x.T @ s.r

    def linesearch_terms(self, s: MTLSState, u, v, mu):
        """Local (numerator, denominator) of the closed-form step (App. B):
        gamma* = <-grad, D> / <X^T X D, D> with D = S - W, via
        X D = -mu (X u) v^T - (R + Y). The caller sums them, then divides."""
        xu = _xu(s.x, u)

        def terms(r, y, xu_c):
            xd = -mu * _uvt(xu_c, v) - (r + y)
            return torch.stack([-torch.sum(r * xd), torch.sum(xd * xd)])

        numer, denom = _row_chunked_sum(terms, s.r, s.y, xu)
        return numer, denom


class MTLSDenseState(NamedTuple):
    """Dense sufficient information (paper App. B, "dense" column): X^T X,
    X^T Y and the gradient. Memory O(d^2 + d m); an update's cost does not
    depend on n_j."""

    xtx: torch.Tensor  # (d, d) fixed
    xty: torch.Tensor  # (d, m) fixed
    g: torch.Tensor  # (d, m) local gradient X^T X W - X^T Y


@dataclasses.dataclass(frozen=True)
class MultiTaskLeastSquaresDense:
    d: int
    m: int

    def init_state(self, x: torch.Tensor, y: torch.Tensor) -> MTLSDenseState:
        # W^0 = 0  =>  grad = -X^T Y
        x = _f32(x, "x")
        xty = x.T @ _f32(y, "y")
        return MTLSDenseState(xtx=x.T @ x, xty=xty, g=-xty)

    def matvec(self, s: MTLSDenseState, v: torch.Tensor) -> torch.Tensor:
        return s.g @ v

    def rmatvec(self, s: MTLSDenseState, u: torch.Tensor) -> torch.Tensor:
        return s.g.T @ u

    def update(self, s: MTLSDenseState, u, v, gamma, mu) -> MTLSDenseState:
        # grad' = (1-g) grad + g (X^T X S - X^T Y),  X^T X S = -mu (X^T X u) v^T
        atom = -mu * _uvt(s.xtx @ u, v)
        g = (1.0 - gamma) * s.g + gamma * (atom - s.xty)
        return MTLSDenseState(xtx=s.xtx, xty=s.xty, g=g)

    def local_grad(self, s: MTLSDenseState) -> torch.Tensor:
        return s.g


# ---------------------------------------------------------------------------
# Multinomial logistic regression:
#   F(W) = sum_i [ logsumexp(x_i W) - (x_i W)_{y_i} ]
# ---------------------------------------------------------------------------


class LogisticState(NamedTuple):
    """The logits Z = X W instead of the gradient. ``label_perm`` (the rows
    sorted by label, stably) and ``label_counts`` (rows per label) are
    derived from ``y`` when the state is built (``DERIVED``: not written to
    a checkpoint); they make the label sum H^T t a segment sum in a fixed
    order, so a run gives the same bits every time."""

    x: torch.Tensor  # (n_j, d)
    y: torch.Tensor  # (n_j,) int64 labels
    z: torch.Tensor  # (n_j, m) logits X W
    label_perm: torch.Tensor  # (n_j,) int64
    label_counts: torch.Tensor  # (m,) int64

    DERIVED = ("label_perm", "label_counts")


def logistic_state(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, m: int) -> LogisticState:
    """A ``LogisticState`` from its samples, labels (int64) and logits, with
    the label order built."""
    return LogisticState(x=_f32(x, "x"), y=y, z=z, label_perm=torch.sort(y, stable=True).indices,
                         label_counts=torch.bincount(y, minlength=m))


@dataclasses.dataclass(frozen=True)
class MultinomialLogistic:
    d: int
    m: int

    def init_state(self, x: torch.Tensor, y: torch.Tensor) -> LogisticState:
        if y.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"labels must be int32 or int64, got {y.dtype}")
        if bool(((y < 0) | (y >= self.m)).any()):
            raise ValueError(f"labels must lie in [0, {self.m})")
        z = torch.zeros((x.shape[0], self.m), dtype=torch.float32, device=x.device)
        return logistic_state(x, y.long(), z, self.m)

    def _probs(self, s: LogisticState) -> torch.Tensor:
        return torch.softmax(s.z, dim=-1)

    def _label_sum(self, s: LogisticState, t: torch.Tensor) -> torch.Tensor:
        """H^T t: t summed per label, each label's rows in row order (a
        segment sum; ``index_add_`` would add with atomics on CUDA, in an
        order that changes from run to run). t may be (n, k): per column."""
        return torch.segment_reduce(t[s.label_perm], "sum", lengths=s.label_counts, unsafe=True)

    # grad = X^T (P - H); H is one-hot(y). Never materialized.
    def matvec(self, s: LogisticState, v: torch.Tensor) -> torch.Tensor:
        pv = self._probs(s) @ v - v[s.y]
        return s.x.T @ pv

    def rmatvec(self, s: LogisticState, u: torch.Tensor) -> torch.Tensor:
        t = s.x @ u
        return self._probs(s).T @ t - self._label_sum(s, t)

    def update(self, s: LogisticState, u, v, gamma, mu) -> LogisticState:
        # Z' = (1-g) Z - g mu (X u) v^T, in place (or (X U) V^T for a block).
        xu = _xu(s.x, u)
        update = r1_ops.rank1_update if u.dim() == 1 else r1_ops.rankk_update
        z = update(s.z, xu, v, 1.0 - gamma, -(gamma * mu), out=s.z)
        return s._replace(z=z)

    def local_loss(self, s: LogisticState) -> torch.Tensor:
        def loss(z, y):
            return torch.sum(torch.logsumexp(z, dim=-1) - z.gather(1, y[:, None])[:, 0])

        return _row_chunked_sum(loss, s.z, s.y)

    def inner_w_grad(self, s: LogisticState) -> torch.Tensor:
        # <W, X^T(P-H)> = <Z, P - H>
        def inner(z, y):
            p = torch.softmax(z, dim=-1)
            return torch.stack([torch.sum(z * p), torch.sum(z.gather(1, y[:, None]))])

        zp, zy = _row_chunked_sum(inner, s.z, s.y)
        return zp - zy

    def local_grad(self, s: LogisticState) -> torch.Tensor:
        """X^T (P - H), (d, m), over row chunks. H is subtracted in place
        from each chunk's P at (i, y_i), one address a row: the
        reference's P - one_hot(y) elementwise, without an (n, m) one-hot."""
        def grad(x, z, y):
            p = torch.softmax(z, dim=-1)
            p[torch.arange(p.shape[0], device=p.device), y] -= 1.0
            return x.T @ p

        return _row_chunked_sum(grad, s.x, s.z, s.y)


# ---------------------------------------------------------------------------
# Matrix completion:  F(W) = 1/2 sum_{(i,j) in Omega} (W_ij - M_ij)^2
# ---------------------------------------------------------------------------


class MCState(NamedTuple):
    """Sparse sufficient information (paper App. B, completion column).

    The observed entries in COO layout, in the caller's entry order (so a
    state converts one to one with the JAX package's), plus the residual on
    those entries, never the d x m matrix. ``weight`` is a {0, 1} padding
    mask and ``resid`` is stored pre-masked (``weight * (W_ij - M_ij)``), so
    zero-weight padding contributes exactly zero everywhere.

    ``by_row``/``by_col`` are the once-per-run entry orders of the
    ``mc_matvec`` kernel (G v reduces along rows, G^T u along columns); the
    indices never change during a run, so neither do they. The residual,
    the values and the weights are also kept in each order's sorted order
    (``resid_by_row = resid[by_row.perm]`` and so on): the kernel reads the
    residual's copies, and ``MatrixCompletion.update`` writes the new
    residual in all three orders at once from the values and weights in
    each (``mc_matvec.update_resid``), so nothing is gathered after
    :func:`mc_state` has built them. The eight are derived from the other
    fields (``DERIVED``) and are not written to a checkpoint.
    """

    rows: torch.Tensor  # (p,) int32 global row index of each observed entry
    cols: torch.Tensor  # (p,) int32 global column index
    vals: torch.Tensor  # (p,) observed values M_ij (arbitrary on padding)
    resid: torch.Tensor  # (p,) weight * (W_ij - M_ij)
    weight: torch.Tensor  # (p,) {0,1} mask; 0 marks padding entries
    by_row: mc_ops.SegmentOrder
    by_col: mc_ops.SegmentOrder
    resid_by_row: torch.Tensor  # (p,) resid[by_row.perm]
    resid_by_col: torch.Tensor  # (p,) resid[by_col.perm]
    vals_by_row: torch.Tensor  # (p,) vals[by_row.perm]
    vals_by_col: torch.Tensor
    weight_by_row: torch.Tensor  # (p,) weight[by_row.perm]
    weight_by_col: torch.Tensor

    DERIVED = ("by_row", "by_col", "resid_by_row", "resid_by_col", "vals_by_row",
               "vals_by_col", "weight_by_row", "weight_by_col")

    def copies(self, order: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(resid, vals, weight) in the ``"row"`` or ``"col"`` order."""
        return tuple(getattr(self, f"{name}_by_{order}") for name in ("resid", "vals", "weight"))


def mc_state(rows, cols, vals, resid, weight, d: int, m: int) -> MCState:
    """An ``MCState`` with its row and column orders (for a d x m matrix)
    and the residual's, values' and weights' copies in each, built from the
    caller-order fields: per order one sort and one record gather, which
    gives the three copies and the order's ``gat_sorted`` together."""
    fields = (resid, vals, weight)
    by_row, row_copies = mc_ops.build_order_with_copies(rows, cols, d, m, fields)
    by_col, col_copies = mc_ops.build_order_with_copies(cols, rows, m, d, fields)
    sorted_copies = {f"{name}_by_{tag}": t
                     for tag, copies in (("row", row_copies), ("col", col_copies))
                     for name, t in zip(("resid", "vals", "weight"), copies)}
    return MCState(rows=rows, cols=cols, vals=vals, resid=resid, weight=weight, by_row=by_row,
                   by_col=by_col, **sorted_copies)


def pack_observations(rows, cols, vals, weight=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack COO observations into the generic ``(x, y)`` driver arrays:
    ``idx`` (p, 2) int32 = [row, col] and ``yw`` (p, 2) f32 = [value,
    weight], the shapes ``MatrixCompletion.init_state`` consumes."""
    rows = torch.as_tensor(rows).to(torch.int32)
    cols = torch.as_tensor(cols).to(torch.int32)
    vals = torch.as_tensor(vals).to(torch.float32)
    w = torch.ones_like(vals) if weight is None else torch.as_tensor(weight).to(torch.float32)
    return torch.stack([rows, cols], dim=1), torch.stack([vals, w], dim=1)


def _entrywise_uv(u, v, rows, cols) -> torch.Tensor:
    """u[rows] * v[cols]: the rank-1 atom on the observed entries."""
    return u[rows] * v[cols]


@dataclasses.dataclass(frozen=True)
class MatrixCompletion:
    """Paper §2.3 task 3. The gradient ``P_Omega(W - M)`` is supported on the
    observed entries, with the residuals as values."""

    d: int
    m: int

    def init_state(self, idx: torch.Tensor, yw: torch.Tensor) -> MCState:
        # W^0 = 0  =>  resid = weight * (0 - M)
        if idx.dim() != 2 or idx.shape[1] != 2 or yw.shape != idx.shape:
            raise ValueError(f"idx and yw must both be (p, 2), got {tuple(idx.shape)} "
                             f"and {tuple(yw.shape)}")
        rows = idx[:, 0].to(torch.int32).contiguous()
        cols = idx[:, 1].to(torch.int32).contiguous()
        vals = _f32(yw, "yw")[:, 0].contiguous()
        weight = yw[:, 1].contiguous()
        return mc_state(rows, cols, vals, -weight * vals, weight, self.d, self.m)

    # grad @ v: scatter resid_e * v[col_e] into rows. Never materialized.
    def matvec(self, s: MCState, v: torch.Tensor) -> torch.Tensor:
        return mc_ref.matvec(s.rows, s.cols, s.resid, v, self.d)

    def rmatvec(self, s: MCState, u: torch.Tensor) -> torch.Tensor:
        return mc_ref.rmatvec(s.rows, s.cols, s.resid, u, self.m)

    def update(self, s: MCState, u, v, gamma, mu) -> MCState:
        # W' = (1-g)W - g mu u v^T on the observed entries:
        # resid' = (1-g) resid - g w M - g mu w u[rows] v[cols], written in
        # caller order and in each sorted order by one update_resid launch
        # (block factors: the k-term dot u[rows] . v[cols]), in place, as
        # the dense tasks' updates run
        mc_ops.update_resid(
            gamma, mu, u, v, s.rows, s.cols, s.resid, s.vals, s.weight,
            s.by_row, s.copies("row"), s.by_col, s.copies("col"),
            out=(s.resid, s.resid_by_row, s.resid_by_col))
        return s

    def local_loss(self, s: MCState) -> torch.Tensor:
        # weight^2 == weight for a {0,1} mask, so resid^2 is already masked
        return 0.5 * torch.sum(s.resid * s.resid)

    def inner_w_grad(self, s: MCState) -> torch.Tensor:
        # <W, grad> over observed entries; W_ij = resid + M_ij there, and
        # padding terms vanish with resid == 0.
        return torch.sum((s.resid + s.weight * s.vals) * s.resid)

    def local_grad(self, s: MCState) -> torch.Tensor:
        """Dense d x m gradient P_Omega(W - M), the reference's
        ``zeros.at[rows, cols].add(resid)`` in its order: the entries sorted
        (stably) by their linear index row * m + col, then pass j adds each
        position's j-th entry (in entry order) to it, every pass writing
        each of its positions once; as many passes as the most entries at
        one position (one host read). An accumulating scatter would add
        duplicates with CUDA atomics, in an order that changes from run to
        run, and a segmented sum in its own association."""
        lin, perm = torch.sort(s.rows.long() * self.m + s.cols.long(), stable=True)
        pos, counts = torch.unique_consecutive(lin, return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        resid = s.resid[perm]
        g = torch.zeros(self.d * self.m, dtype=s.resid.dtype, device=s.resid.device)
        for j in range(int(counts.max()) if counts.numel() else 0):
            at = counts > j
            p = pos[at]
            g.index_put_((p,), g[p] + resid[starts[at] + j])
        return g.view(self.d, self.m)

    def linesearch_terms(self, s: MCState, u, v, mu):
        """Local (numerator, denominator) of the exact step for the quadratic
        objective: gamma* = <-grad, D> / ||P_Omega(D)||^2 with D = S - W, on
        the observed entries. For a block atom, w (S - M) on the entries,
        -mu w (u_i . v_j) - w M_ij, is ``update_resid``'s caller-order
        result at gamma = 1 (``update_resid_caller``: that order alone), so
        dw = that - resid: one pass of the kernel's gathers of the factors'
        rows, where gathering them in plain PyTorch (two (p, k) gathers)
        took ten times as long on the card."""
        if u.dim() == 2:
            step = mc_ops.update_resid_caller(
                torch.ones((), dtype=torch.float32, device=u.device), mu, u, v, s.rows, s.cols,
                s.resid, s.vals, s.weight)
            dw = step - s.resid  # w (S - W)
            return -torch.sum(s.resid * dw), torch.sum(dw * dw)
        # w * D_ij = -mu w u_i v_j - w W_ij, with w W_ij = resid + w M_ij
        dw = -(mu) * s.weight * _entrywise_uv(u, v, s.rows, s.cols) - (
            s.resid + s.weight * s.vals
        )
        numer = -torch.sum(s.resid * dw)
        denom = torch.sum(dw * dw)
        return numer, denom

    def rmse(self, s: MCState) -> torch.Tensor:
        """RMSE over the (non-padding) observed entries."""
        return torch.sqrt(
            torch.sum(s.resid * s.resid) / torch.clamp(torch.sum(s.weight), min=1.0)
        )
