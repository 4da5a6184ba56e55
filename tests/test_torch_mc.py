"""Matrix completion in the port (``MatrixCompletion``, the ``mc_matvec``
kernel module, ``shard_observations``, ``gather_entries``, the MC fit)
against the JAX package, on the CPU.

The same numpy observations go through ``repro`` and ``repro_torch``. The
JAX kernel runs in interpret mode with small entry blocks, as
tests/test_kernels.py runs it. Tolerances: matvecs and the per-entry task
arithmetic rtol 1e-5 with an atol of 1e-6 times max|reference| (f32 sums in
another order); whole fits rtol 1e-4 on the histories and 1e-4 of max|W| on
the iterate, as in tests/test_torch_fit.py (the power method amplifies
rounding over the epochs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import low_rank as jlr
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.kernels import mc_matvec as jmc
from repro.launch import dfw as jdfw
from repro_torch import NoiseStream, V0Stream, convert
from repro_torch.core import frank_wolfe, low_rank, tasks
from repro_torch.kernels import mc_matvec as mc
from repro_torch.launch import dfw

torch.set_num_threads(2)

D, M, P = 40, 30, 600
KEY = jax.random.PRNGKey(5)
EMPTY_ROW, EMPTY_COL = 7, 4


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30))


@pytest.fixture(scope="module")
def obs():
    """Observations of a planted rank-3, trace-norm-1 matrix plus noise:
    drawn with replacement (duplicates kept, as the reference sums them),
    with one row and one column left empty."""
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((D, 3)))[0]
    v = np.linalg.qr(rng.standard_normal((M, 3)))[0]
    s = np.array([0.5, 0.3, 0.2])
    w = (u * s) @ v.T * np.sqrt(D * M) / 4
    rows = rng.integers(0, D, P)
    cols = rng.integers(0, M, P)
    rows[rows == EMPTY_ROW] = EMPTY_ROW + 1
    cols[cols == EMPTY_COL] = EMPTY_COL + 1
    rows[:20], cols[:20] = 3, 11  # a heavily duplicated entry
    vals = (w[rows, cols] + 0.05 * rng.standard_normal(P)).astype(np.float32)
    mu = float(np.sum(np.linalg.svd(w, compute_uv=False)))
    return dict(rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals, mu=mu,
                u=rng.standard_normal(D).astype(np.float32),
                v=rng.standard_normal(M).astype(np.float32))


def _padded(o, pad=17):
    """The same observations plus zero-weight padding at (0, 0)."""
    z = np.zeros(pad, np.int32)
    return (np.concatenate([o["rows"], z]), np.concatenate([o["cols"], z]),
            np.concatenate([o["vals"], np.full(pad, 123.0, np.float32)]),
            np.concatenate([np.ones(P, np.float32), np.zeros(pad, np.float32)]))


def _pack_both(rows, cols, vals, weight=None):
    jidx, jyw = jtasks.pack_observations(rows, cols, vals, weight)
    tidx, tyw = tasks.pack_observations(rows, cols, vals, weight)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tyw.numpy(), np.asarray(jyw))
    return (jidx, jyw), (tidx, tyw)


# ---------------------------------------------------------------------------
# The coo_matvec kernel module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "padding", "one-entry-rows"])
def test_coo_matvec_matches_jax(obs, case):
    rows, cols, vals = obs["rows"], obs["cols"], obs["vals"]
    if case == "padding":
        rows, cols, vals, w = _padded(obs)
        vals = vals * w  # the residual is pre-masked
    elif case == "one-entry-rows":
        rows, cols, vals = rows[:D - 5], cols[:D - 5], vals[:D - 5]
        rows = np.arange(D - 5, dtype=np.int32)
    t = [torch.from_numpy(a) for a in (rows, cols, vals)]
    by_row, by_col = mc.build_order(t[0], t[1], D, M), mc.build_order(t[1], t[0], M, D)
    v, u = obs["v"], obs["u"]
    got_mv = mc.coo_matvec(by_row, mc.gather_sorted(by_row, t[2]), torch.from_numpy(v))
    got_rmv = mc.coo_matvec(by_col, mc.gather_sorted(by_col, t[2]), torch.from_numpy(u))
    j = [jnp.asarray(a) for a in (rows, cols, vals)]
    _close(got_mv, jmc.ref.matvec(*j, jnp.asarray(v), D))
    _close(got_mv, jmc.ops.matvec(*j, jnp.asarray(v), D, block_e=64, interpret=True))
    _close(got_rmv, jmc.ref.rmatvec(*j, jnp.asarray(u), M))
    _close(got_rmv, jmc.ops.rmatvec(*j, jnp.asarray(u), M, block_e=64, interpret=True))
    if case != "one-entry-rows":
        assert float(got_mv[EMPTY_ROW]) == 0.0 and float(got_rmv[EMPTY_COL]) == 0.0


def test_zero_weight_padding_gives_the_same_matvec_bits(obs):
    task = tasks.MatrixCompletion(D, M)
    s0 = task.init_state(*tasks.pack_observations(obs["rows"], obs["cols"], obs["vals"]))
    s1 = task.init_state(*tasks.pack_observations(*_padded(obs)))
    k = dfw.kernelize(task)
    v, u = torch.from_numpy(obs["v"]), torch.from_numpy(obs["u"])
    for a, b in ((k.matvec(s0, v), k.matvec(s1, v)), (k.rmatvec(s0, u), k.rmatvec(s1, u)),
                 (mc.ref.coo_matvec_pieces(s0.by_row, s0.resid_by_row, v),
                  mc.ref.coo_matvec_pieces(s1.by_row, s1.resid_by_row, v))):
        assert torch.equal(a, b)
    # Loss and <W, grad> sum over 17 more (zero) terms: same value up to the
    # order of an f32 sum of 600 terms, not necessarily the same bits.
    gam = torch.tensor(0.4)
    s0u = task.update(s0, u / u.norm(), v / v.norm(), gam, 1.5)
    s1u = task.update(s1, u / u.norm(), v / v.norm(), gam, 1.5)
    assert float(torch.max(torch.abs(s1u.resid[P:]))) == 0.0
    for f in (task.local_loss, task.inner_w_grad, task.rmse):
        _close(f(s1u), f(s0u), rtol=1e-6, atol_rel=0)


@pytest.mark.parametrize("piece", [1, 3, 64, 1024])
def test_kernel_stages_on_the_order_match_plain(obs, piece, monkeypatch):
    """The kernel's two stages, written in plain PyTorch on the same order
    (``ref.coo_matvec_pieces``), give the plain version: every entry lies in
    exactly one piece of its own segment, pieces are contiguous per segment
    and at most ``piece`` long, and empty segments have none."""
    monkeypatch.setattr(mc.ops, "PIECE", piece)
    rows, cols, vals = (torch.from_numpy(obs[k]) for k in ("rows", "cols", "vals"))
    for seg, gat, out_dim, in_dim, x in ((rows, cols, D, M, obs["v"]),
                                         (cols, rows, M, D, obs["u"])):
        order = mc.build_order(seg, gat, out_dim, in_dim)
        x = torch.from_numpy(x)
        _close(mc.ref.coo_matvec_pieces(order, mc.gather_sorted(order, vals), x),
               mc.ref.coo_matvec(seg, gat, vals, x, out_dim))
        perm = order.perm.long()
        assert torch.equal(torch.sort(perm).values, torch.arange(P))
        assert torch.equal(seg[perm], torch.sort(seg, stable=True).values)
        assert torch.equal(order.gat_sorted, gat[perm])
        counts = torch.bincount(seg.long(), minlength=out_dim)
        assert torch.equal(torch.diff(order.seg_ptr), counts)
        assert torch.equal(torch.diff(order.piece_ptr), (counts + piece - 1) // piece)
        lengths = order.piece_end - order.piece_start
        assert int(lengths.min()) >= 1 and int(lengths.max()) <= piece


@pytest.mark.parametrize("bad", ["seg-high", "seg-negative", "gat-high", "int64", "shape"])
def test_build_order_refuses_bad_indices(bad):
    seg = torch.tensor([0, 2, 1], dtype=torch.int32)
    gat = torch.tensor([1, 0, 3], dtype=torch.int32)
    if bad == "seg-high":
        seg[1] = 3
    elif bad == "seg-negative":
        seg[1] = -1
    elif bad == "gat-high":
        gat[2] = 4
    elif bad == "int64":
        seg = seg.long()
    else:
        gat = gat[:2]
    with pytest.raises(TypeError if bad == "int64" else ValueError):
        mc.build_order(seg, gat, 3, 4)


def test_coo_matvec_refuses_bad_operands(obs):
    rows, cols = torch.from_numpy(obs["rows"]), torch.from_numpy(obs["cols"])
    order = mc.build_order(rows, cols, D, M)
    with pytest.raises(ValueError):
        mc.coo_matvec(order, torch.zeros(P - 1), torch.zeros(M))
    with pytest.raises(ValueError):
        mc.coo_matvec(order, torch.zeros(P), torch.zeros(D))
    with pytest.raises(TypeError):
        mc.coo_matvec(order, torch.zeros(P, dtype=torch.float64), torch.zeros(M))
    with pytest.raises(ValueError):
        mc.gather_sorted(order, torch.zeros(P + 1))
    with pytest.raises(TypeError):
        mc.gather_sorted(order, torch.zeros(P, dtype=torch.float64))


@pytest.mark.parametrize("case", ["plain", "padding", "one-entry-rows"])
def test_coo_matvec_reads_the_sorted_copy(obs, case):
    """On the CPU ``coo_matvec`` sums the values it is given in the order's
    sorted order, so a copy in the wrong order (a missed refresh) shows:
    ``gather_sorted`` is ``vals[perm]`` bit for bit, the matvec from it
    matches the plain version on caller-order values to 1e-6 of max, and the
    caller-order values read as if sorted do not."""
    rows, cols, vals = obs["rows"], obs["cols"], obs["vals"]
    if case == "padding":
        rows, cols, vals, w = _padded(obs)
        vals = vals * w
    elif case == "one-entry-rows":
        rows, vals = np.arange(D - 5, dtype=np.int32), vals[:D - 5]
        cols = cols[:D - 5]
    t = [torch.from_numpy(a) for a in (rows, cols, vals)]
    for seg, gat, out_dim, in_dim, x in ((t[0], t[1], D, M, obs["v"]),
                                         (t[1], t[0], M, D, obs["u"])):
        order = mc.build_order(seg, gat, out_dim, in_dim)
        x = torch.from_numpy(x)
        copy = mc.gather_sorted(order, t[2])
        assert torch.equal(copy, t[2][order.perm.long()])
        want = mc.ref.coo_matvec(seg, gat, t[2], x, out_dim)
        _close(mc.coo_matvec(order, copy, x), want, rtol=0)
        if not torch.equal(copy, t[2]):
            stale = mc.coo_matvec(order, t[2], x)
            assert float(torch.max(torch.abs(stale - want))) > 1e-3 * float(
                torch.max(torch.abs(want)))


def _fields(p, seed, padding):
    """Caller-order fields of p entries: f32 residual, values and weights
    (a fifth of them zero-weight padding with zero residual if
    ``padding``), and an int32 field."""
    rng = np.random.default_rng(seed)
    w = (rng.random(p) >= 0.2 if padding else np.ones(p, bool)).astype(np.float32)
    vals = rng.standard_normal(p).astype(np.float32)
    resid = (w * rng.standard_normal(p)).astype(np.float32)
    ints = rng.integers(-2**31, 2**31 - 1, p, dtype=np.int64).astype(np.int32)
    return [torch.from_numpy(a) for a in (resid, vals, w, ints)]


@pytest.mark.parametrize("p", [0, 1, 7, 3000])
@pytest.mark.parametrize("padding", [False, True])
def test_record_gather_plain_route_is_field_perm(p, padding):
    """The record gather (``build_order_with_copies``, ``gather_sorted_fields``)
    on the CPU: every copy, f32 and int32, is field[perm] bit for bit, the
    order is ``build_order``'s, and its gat_sorted is gat[perm]."""
    rng = np.random.default_rng(p)
    rows = torch.from_numpy(rng.integers(0, 13, p).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 9, p).astype(np.int32))
    resid, vals, w, ints = _fields(p, p + 1, padding)
    for seg, gat, od, idim in ((rows, cols, 13, 9), (cols, rows, 9, 13)):
        order, copies = mc.build_order_with_copies(seg, gat, od, idim, (resid, vals, ints))
        perm = order.perm.long()
        want = mc.build_order(seg, gat, od, idim)
        for f in dataclasses.fields(want):
            a, b = getattr(order, f.name), getattr(want, f.name)
            assert (a == b) if f.name == "in_dim" else torch.equal(a, b), f.name
        assert torch.equal(order.gat_sorted, gat[perm])
        for t, c in zip((resid, vals, ints), copies):
            assert c.dtype == t.dtype and torch.equal(c, t[perm])
        again = mc.gather_sorted_fields(order, (w, ints, resid, gat))
        for t, c in zip((w, ints, resid, gat), again):
            assert c.dtype == t.dtype and torch.equal(c, t[perm])
        if padding and p:
            assert not torch.any(copies[0][w[perm] == 0])


@pytest.mark.parametrize("bad", ["length", "float64", "int64", "device", "count", "not-tensor",
                                 "strided"])
@pytest.mark.parametrize("wrapper", ["build_order_with_copies", "gather_sorted_fields"])
def test_record_gather_refuses_bad_fields(obs, bad, wrapper):
    rows, cols = torch.from_numpy(obs["rows"]), torch.from_numpy(obs["cols"])
    good = torch.zeros(P)
    fields = {
        "length": [good, torch.zeros(P + 1)],
        "float64": [good, torch.zeros(P, dtype=torch.float64)],
        "int64": [torch.zeros(P, dtype=torch.int64)],
        "device": [good, torch.zeros(P, device="meta")],
        "count": [good] * (4 if wrapper == "build_order_with_copies" else 5),
        "not-tensor": [good, np.zeros(P, np.float32)],
        "strided": [torch.zeros(2 * P)[::2]],
    }[bad]
    err = TypeError if bad in ("float64", "int64", "not-tensor") else ValueError
    with pytest.raises(err):
        if wrapper == "build_order_with_copies":
            mc.build_order_with_copies(rows, cols, D, M, fields)
        else:
            mc.gather_sorted_fields(mc.build_order(rows, cols, D, M), fields)


# ---------------------------------------------------------------------------
# The task, the layout helpers and gather_entries
# ---------------------------------------------------------------------------


def test_mc_task_matches_jax(obs):
    (jidx, jyw), (tidx, tyw) = _pack_both(*_padded(obs))
    jt, tt = jtasks.MatrixCompletion(D, M), tasks.MatrixCompletion(D, M)
    js, ts = jt.init_state(jidx, jyw), tt.init_state(tidx, tyw)
    for name in ("rows", "cols", "vals", "resid", "weight"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    u = obs["u"] / np.linalg.norm(obs["u"])
    v = obs["v"] / np.linalg.norm(obs["v"])
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), torch.from_numpy(v)
    mu = obs["mu"]
    for g in (0.3, 1.0):
        js = jt.update(js, ju, jv, jnp.float32(g), mu)
        ts = tt.update(ts, tu, tv, torch.tensor(g), mu)
        _close(ts.resid, js.resid)
        _close(tt.local_loss(ts), jt.local_loss(js))
        _close(tt.inner_w_grad(ts), jt.inner_w_grad(js))
        _close(tt.rmse(ts), jt.rmse(js))
        for a, b in zip(tt.linesearch_terms(ts, tu, tv, mu), jt.linesearch_terms(js, ju, jv, mu)):
            _close(a, b)
        _close(tt.matvec(ts, tv), jt.matvec(js, jv))
        _close(tt.rmatvec(ts, tu), jt.rmatvec(js, ju))
        _close(dfw.kernelize(tt).matvec(ts, tv), jt.matvec(js, jv))
        _close(dfw.kernelize(tt).rmatvec(ts, tu), jt.rmatvec(js, ju))
        _close(tt.local_grad(ts), jt.local_grad(js))
    assert dfw.verify_kernelized(tt, dfw.kernelize(tt), ts) <= 1e-6


@pytest.mark.parametrize("nw", [1, 3, 4])
def test_shard_observations_matches_jax(obs, nw):
    args = (obs["rows"], obs["cols"], obs["vals"], nw, D)
    jidx, jyw = jdfw.shard_observations(*args, m=M)
    tidx, tyw = dfw.shard_observations(*args, m=M)
    assert tidx.dtype == torch.int32 and tyw.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tyw.numpy(), np.asarray(jyw))
    w = np.random.default_rng(nw).integers(0, 2, P).astype(np.float32)
    jidx, jyw = jdfw.shard_observations(*args, weight=w)
    tidx, tyw = dfw.shard_observations(*(torch.from_numpy(np.asarray(a)) if isinstance(
        a, np.ndarray) else a for a in args), weight=torch.from_numpy(w))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tyw.numpy(), np.asarray(jyw))


@pytest.mark.parametrize("bad", [
    ([0, 40], [0, 1], dict()), ([0, 1], [0, 24], dict(m=24)), ([0, 1], [0, -1], dict()),
    ([-1, 1], [0, 1], dict()),
])
def test_shard_observations_rejects_like_jax(bad):
    rows, cols, kw = bad
    with pytest.raises(ValueError) as want:
        jdfw.shard_observations(jnp.array(rows), jnp.array(cols), jnp.array([1.0, 2.0]),
                                4, 30, **kw)
    with pytest.raises(ValueError) as got:
        dfw.shard_observations(np.array(rows), np.array(cols), np.array([1.0, 2.0]),
                               4, 30, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="identical shapes"):
        dfw.shard_observations([0, 1], [0], [1.0, 2.0], 4, 30)


def test_gather_entries_matches_materialize_and_jax():
    rng = np.random.default_rng(3)
    it = low_rank.init(6, D, M, device="cpu")
    for _ in range(5):
        u, v = rng.standard_normal(D), rng.standard_normal(M)
        it = low_rank.fw_update(it, torch.tensor(u / np.linalg.norm(u), dtype=torch.float32),
                                torch.tensor(v / np.linalg.norm(v), dtype=torch.float32),
                                torch.tensor(0.3), 2.0)
    rows = rng.integers(0, D, 200).astype(np.int32)
    cols = rng.integers(0, M, 200).astype(np.int32)
    got = low_rank.gather_entries(it, torch.from_numpy(rows), torch.from_numpy(cols))
    _close(got, low_rank.materialize(it)[rows, cols])
    jit = jlr.FactoredIterate(*(jnp.asarray(t.numpy()) for t in it))
    _close(got, jlr.gather_entries(jit, jnp.asarray(rows), jnp.asarray(cols)))


def test_convert_mc_state_builds_the_orders(obs):
    (jidx, jyw), _ = _pack_both(*_padded(obs))
    js = jtasks.MatrixCompletion(D, M).init_state(jidx, jyw)
    ts = convert.task_state(js, device="cpu", d=D, m=M)
    assert isinstance(ts, tasks.MCState)
    for name in ("rows", "cols", "vals", "resid", "weight"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert ts.rows.dtype == torch.int32 and ts.by_row.out_dim == D and ts.by_col.out_dim == M
    assert torch.equal(ts.by_row.seg, ts.rows) and torch.equal(ts.by_col.gat, ts.rows)
    with pytest.raises(TypeError, match="d and m"):
        convert.task_state(js, device="cpu")


def _per_field_state(s):
    """The derived arrays of ``s`` rebuilt field by field, as ``mc_state``
    built them before the record gather: ``build_order`` per order, then one
    ``gather_sorted`` per field and order."""
    d, m = s.by_row.out_dim, s.by_col.out_dim
    by_row, by_col = mc.build_order(s.rows, s.cols, d, m), mc.build_order(s.cols, s.rows, m, d)
    out = dict(by_row=by_row, by_col=by_col)
    for tag, order in (("row", by_row), ("col", by_col)):
        for name in ("resid", "vals", "weight"):
            out[f"{name}_by_{tag}"] = mc.gather_sorted(order, getattr(s, name))
    return out


@pytest.mark.parametrize("where", ["init_state", "convert"])
def test_mc_state_equals_the_per_field_construction(obs, where):
    """``mc_state`` (one record gather per order) gives the eight derived
    arrays and the two ``SegmentOrder``s that the per-field construction
    gives, bit for bit, whether it is reached from ``init_state`` or from
    ``convert.task_state`` (a JAX state carried across), with zero-weight
    padding."""
    if where == "init_state":
        s = tasks.MatrixCompletion(D, M).init_state(*tasks.pack_observations(*_padded(obs)))
    else:
        (jidx, jyw), _ = _pack_both(*_padded(obs))
        s = convert.task_state(jtasks.MatrixCompletion(D, M).init_state(jidx, jyw),
                               device="cpu", d=D, m=M)
    want = _per_field_state(s)
    assert set(want) == set(tasks.MCState.DERIVED)
    for name in ("resid", "vals", "weight"):
        for tag in ("row", "col"):
            got = getattr(s, f"{name}_by_{tag}")
            assert got.dtype == torch.float32 and torch.equal(got, want[f"{name}_by_{tag}"])
    for tag in ("row", "col"):
        got, ref_order = getattr(s, f"by_{tag}"), want[f"by_{tag}"]
        for f in dataclasses.fields(ref_order):
            a, b = getattr(got, f.name), getattr(ref_order, f.name)
            assert (a == b) if f.name == "in_dim" else (
                a.dtype == b.dtype and torch.equal(a, b)), f"by_{tag}.{f.name}"


def _assert_copies_in_step(s):
    """Each sorted copy of the residual, the values and the weights is
    field[order.perm], bit for bit."""
    for name in ("resid", "vals", "weight"):
        for tag, order in (("row", s.by_row), ("col", s.by_col)):
            assert torch.equal(getattr(s, f"{name}_by_{tag}"),
                               getattr(s, name)[order.perm.long()]), f"{name}_by_{tag}"


def _step_size(source):
    """gamma as the fit makes it: the line search's clamp of numer / denom,
    or the 2/(t+2) schedule (both 0-d float32 tensors)."""
    if source == "linesearch":
        return torch.clamp(torch.tensor(0.7) / torch.clamp(torch.tensor(3.1), min=1e-30), 0.0,
                           1.0)
    return frank_wolfe.default_step_size(torch.full((), 5.0))


@pytest.mark.parametrize("gamma_from", ["linesearch", "schedule"])
@pytest.mark.parametrize("mu_case", ["mu", "zero"])
def test_update_resid_is_the_chain_then_gather_bit_for_bit(obs, gamma_from, mu_case):
    """ref.update_resid (what MatrixCompletion.update runs on the CPU) gives
    the caller-order chain of the update (as written before the residual was
    kept in each order) and, in each order, that chain followed by
    gather_sorted, bit for bit; with zero-weight padding exactly 0."""
    task = tasks.MatrixCompletion(D, M)
    s = task.init_state(*tasks.pack_observations(*_padded(obs)))
    rng = np.random.default_rng(7)
    u, v = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in (D, M))
    u, v = u / u.norm(), v / v.norm()
    gamma, mu = _step_size(gamma_from), (obs["mu"] if mu_case == "mu" else 0.0)
    uv = s.weight * (u[s.rows] * v[s.cols])
    want = (1.0 - gamma) * s.resid - gamma * s.weight * s.vals - (gamma * mu) * uv
    got = mc.ref.update_resid(gamma, mu, u, v, s.rows, s.cols, s.resid, s.vals, s.weight,
                              s.by_row, s.copies("row"), s.by_col, s.copies("col"))
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], mc.gather_sorted(s.by_row, want))
    assert torch.equal(got[2], mc.gather_sorted(s.by_col, want))
    new = task.update(s, u, v, gamma, mu)
    assert all(torch.equal(a, b) for a, b in zip(
        (new.resid, new.resid_by_row, new.resid_by_col), got))
    assert float(torch.max(torch.abs(new.resid[P:]))) == 0.0
    assert new.vals_by_row is s.vals_by_row and new.weight_by_col is s.weight_by_col


@pytest.mark.parametrize("bad", ["gamma-float", "gamma-f64", "order-size", "copies", "rows-i64"])
def test_update_resid_refuses_bad_operands(obs, bad):
    s = tasks.MatrixCompletion(D, M).init_state(
        *tasks.pack_observations(obs["rows"], obs["cols"], obs["vals"]))
    u, v = torch.zeros(D), torch.zeros(M)
    kw = dict(by_row=s.by_row, row_copies=s.copies("row"), by_col=s.by_col,
              col_copies=s.copies("col"))
    gamma, rows = torch.tensor(0.5), s.rows
    if bad == "gamma-float":
        gamma = 0.5
    elif bad == "gamma-f64":
        gamma = gamma.double()
    elif bad == "order-size":
        kw["by_row"] = s.by_col  # a (M x D) order where (D x M) is due
    elif bad == "copies":
        kw["row_copies"] = s.copies("row")[:2]
    else:
        rows = rows.long()
    with pytest.raises((TypeError, ValueError)):
        mc.update_resid(gamma, 1.0, u, v, rows, s.cols, s.resid, s.vals, s.weight, **kw)


@pytest.mark.parametrize("where", ["init_state-and-update", "convert", "checkpoint"])
def test_sorted_residual_copies_stay_in_step(obs, where, tmp_path):
    """The residual's, values' and weights' copies in the row and column
    orders equal field[perm] after init_state and after every update, after
    convert.task_state carries a JAX state across, and in a state rebuilt
    from a checkpoint's leaves; the checkpoint holds exactly the five
    caller-order MC leaves."""
    from repro_torch.checkpoint.store import read_leaves

    task = tasks.MatrixCompletion(D, M)
    idx, yw = tasks.pack_observations(*_padded(obs))
    if where == "init_state-and-update":
        s = task.init_state(idx, yw)
        _assert_copies_in_step(s)
        rng = np.random.default_rng(3)
        for gamma in (0.5, 0.25, 0.1):
            u, v = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in (D, M))
            s = task.update(s, u / u.norm(), v / v.norm(), torch.tensor(gamma), obs["mu"])
            _assert_copies_in_step(s)
        return
    if where == "convert":
        (jidx, jyw), _ = _pack_both(*_padded(obs))
        jt = jtasks.MatrixCompletion(D, M)
        head = jdfw.fit_serial(jt, jidx, jyw, key=KEY, cfg=jdfw.DFWConfig(
            num_epochs=3, use_pallas=False, mu=obs["mu"], schedule="log"))
        _assert_copies_in_step(convert.task_state(head.state, device="cpu", d=D, m=M))
        return
    res = dfw.fit_serial(task, idx, yw, cfg=dfw.DFWConfig(
        mu=obs["mu"], num_epochs=3, schedule="log", checkpoint_dir=str(tmp_path)),
        key=2, device="cpu")
    _, leaves, _ = read_leaves(tmp_path, prefix="carry/state/")
    names = ("rows", "cols", "vals", "resid", "weight")
    assert list(leaves) == [f"carry/state/{n}" for n in names]
    back = convert.task_state({n: leaves[f"carry/state/{n}"] for n in names}, device="cpu",
                              d=D, m=M)
    _assert_copies_in_step(back)
    assert torch.equal(back.resid, res.state.resid)
    assert torch.equal(back.resid_by_row, res.state.resid_by_row)
    assert torch.equal(back.resid_by_col, res.state.resid_by_col)


# ---------------------------------------------------------------------------
# The whole MC fit
# ---------------------------------------------------------------------------


def _v0_table(epochs):
    return np.stack([np.asarray(sphere_vector(jax.random.fold_in(KEY, t), M))
                     for t in range(epochs)])


def _noise_tables(epochs, iters):
    """The JAX run's int8 noise: exchange (t, i, slot) draws uniform(fold_in(
    fold_in(fold_in(fold_in(KEY, t), 0xC033), i), slot))."""
    nu, nv = [], []
    for t in range(epochs):
        ckey = jax.random.fold_in(jax.random.fold_in(KEY, t), 0xC033)
        ki = [jax.random.fold_in(ckey, i) for i in range(iters)]
        nu.append([np.asarray(jax.random.uniform(jax.random.fold_in(k, 0), (D,))) for k in ki])
        nv.append([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (M,))) for k in ki])
    return NoiseStream.from_tables(np.array(nu), np.array(nv))


def _assert_same_run(jr, tr, start=0):
    assert tr.epochs_run == jr.epochs_run and tr.history["k"] == jr.history["k"]
    for name in ("loss", "gap", "sigma", "gamma"):
        _close(tr.history[name][start:], jr.history[name][start:], rtol=1e-4)
    _close(tr.final_loss, jr.final_loss, rtol=1e-4)
    _close(low_rank.materialize(tr.iterate), jlr.materialize(jr.iterate), rtol=1e-4,
           atol_rel=1e-4)


FITS = {
    "default": dict(num_epochs=14, schedule="log"),
    "linesearch": dict(num_epochs=14, schedule="const:2", step_size="linesearch"),
    "int8-linesearch": dict(num_epochs=12, schedule="log", step_size="linesearch",
                            comm="int8"),
}


@pytest.mark.parametrize("case", list(FITS))
def test_mc_fit_serial_matches_jax(obs, case):
    kw = dict(FITS[case], mu=obs["mu"])
    (jidx, jyw), (tidx, tyw) = _pack_both(*_padded(obs))
    jr = jdfw.fit_serial(jtasks.MatrixCompletion(D, M), jidx, jyw, key=KEY,
                         cfg=jdfw.DFWConfig(use_pallas=False, **kw))
    noise = None
    if kw.get("comm") == "int8":
        noise = _noise_tables(kw["num_epochs"], max(jr.history["k"]))
    key = V0Stream.from_table(_v0_table(kw["num_epochs"]))
    tr = dfw.fit_serial(tasks.MatrixCompletion(D, M), tidx, tyw, cfg=dfw.DFWConfig(**kw),
                        key=key, noise=noise, device="cpu")
    _assert_same_run(jr, tr)
    if kw.get("step_size") == "linesearch":
        assert tr.history["loss"][-1] < 0.5 * tr.history["loss"][0]


def test_mc_resume_from_converted_jax_state(obs):
    """JAX runs 4 epochs; the port continues from its converted state,
    iterate and counter and matches the uninterrupted JAX run."""
    kw = dict(mu=obs["mu"], schedule="log", step_size="linesearch")
    (jidx, jyw), _ = _pack_both(obs["rows"], obs["cols"], obs["vals"])
    jt = jtasks.MatrixCompletion(D, M)
    full = jdfw.fit_serial(jt, jidx, jyw, key=KEY,
                           cfg=jdfw.DFWConfig(num_epochs=10, use_pallas=False, **kw))
    head = jdfw.fit_serial(jt, jidx, jyw, key=KEY,
                           cfg=jdfw.DFWConfig(num_epochs=4, use_pallas=False, **kw))
    tr = frank_wolfe.fit(
        dfw.kernelize(tasks.MatrixCompletion(D, M)),
        convert.task_state(head.state, device="cpu", d=D, m=M),
        iterate=convert.iterate(jlr.pack_live(head.iterate), 10, device="cpu"),
        start_t=convert.epoch_counter(head.iterate.count), initial_history=head.history,
        num_epochs=10, key=V0Stream.from_table(_v0_table(10)), device="cpu", **kw,
    )
    _assert_same_run(full, tr, start=4)


@pytest.mark.parametrize("comm", ["dense", "int8"])
def test_mc_fit_routes_through_coo_matvec(obs, comm, monkeypatch):
    """Every power iteration of the MC fit calls coo_matvec once per
    direction, and verify_kernelized once more each; every epoch's update is
    one update_resid, and the copies are gathered only when a state is built
    (one record gather per order, ``build_order_with_copies``: two for the
    fit's state and two for verify_kernelized's): the launch counts the card
    run expects."""
    calls = dict.fromkeys(("coo_matvec", "update_resid", "build_order_with_copies"), 0)
    for name in calls:
        fn = getattr(mc.ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mc.ops, name, counted)
    cfg = dfw.DFWConfig(mu=obs["mu"], num_epochs=8, schedule="log", comm=comm)
    res = dfw.fit_serial(tasks.MatrixCompletion(D, M),
                         *tasks.pack_observations(obs["rows"], obs["cols"], obs["vals"]),
                         cfg=cfg, key=2, device="cpu")
    assert calls == {"coo_matvec": 2 * sum(res.history["k"]) + 2, "update_resid": 8,
                     "build_order_with_copies": 4}
    assert all(np.isfinite(res.history["loss"]))
