"""The block:k solver tier of the port (``solver="block:k[:adapt][:cold]"``)
against the JAX package on the CPU, with the same numpy inputs.

The JAX runs draw their randomness from keys; the port gets the same arrays
through its seams: each epoch's k fresh columns as a (T, m, k)
``V0Stream.from_table`` (the reference's ``sphere_vector(fold_in(fold_in(
key, t), 101 + j), m)``), the cold-start probe through ``probe=`` (the
reference's ``init_probe``, drawn from ``PRNGKey(0x5EED)``), the int8 noise
as ``NoiseStream.from_tables`` of (T, K, d k) and (T, K, m k).

Tolerances, with their reasons:
- ``orthonormalize_block``: 1e-5 of max on a well-conditioned block (the
  two Cholesky factorizations and triangular solves round differently, in
  f32); a rank-deficient block's null directions are set by the jitter and
  by rounding, so there the test holds what is defined: the result is
  finite and its columns span the block's column space, and the full-rank
  part agrees to 1e-4.
- ``block_power_iterations`` on explicit matrices, ``fw_update_block``, the
  tasks' block update and line-search terms and the plain versions of the
  kernels' block forms: rtol 1e-5 with an atol of 1e-6 of max|reference|
  (f32 sums in another order); the power iteration's results 1e-4 (its
  CholQR steps amplify those differences over the iterations).
- Whole fits (``fit_serial``): histories rtol 1e-4, W 1e-4 of max|W|, as
  ``tests/test_torch_fit.py``; the runs below show <= 4e-5. Epoch counts
  and the executed power iterations (``piters``) are compared exactly;
  the adaptive runs print how far every iteration's stop criterion stayed
  from its threshold (the verdicts of two packages could differ within an
  ulp of sigma).
- ``block:1:cold`` against ``rank1`` (different start vectors, the same
  fixed point): the reference's own rtol 2e-2 on the loss, 5e-2 on the gap.
- The warm and cold runs of caveat (a)'s problem: 1e-2 (its docstring).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import specs as jspecs
from repro.checkpoint import dfw as jckpt
from repro.comm import make_reducer as jmake_reducer
from repro.core import engine as jengine
from repro.core import frank_wolfe as jfw
from repro.core import low_rank as jlr
from repro.core import power_method as jpmeth
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.kernels import mc_matvec as jmc
from repro.kernels import power_matvec as jpm
from repro.launch import dfw as jdfw
from repro_torch import NoiseStream, V0Stream, specs
from repro_torch.comm import Int8Reducer, TopKReducer
from repro_torch.comm.topology import make_topology
from repro_torch.core import engine, frank_wolfe, low_rank, power_method, tasks
from repro_torch.kernels import mc_matvec as mc
from repro_torch.kernels import power_matvec as pm
from repro_torch.kernels import rank1_update as r1
from repro_torch.launch import dfw

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(1)
N, D, M = 512, 48, 40
MD, MM = 60, 45  # matrix completion


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((D, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((M, 5)))[0]
    s = np.linspace(1.0, 0.2, 5)
    w = (u * (s / s.sum())) @ v.T
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    wl = rng.standard_normal((D, 5)) @ rng.standard_normal((5, M))
    labels = np.argmax(x @ wl, axis=1).astype(np.int32)
    um = np.linalg.qr(rng.standard_normal((MD, 4)))[0]
    vm = np.linalg.qr(rng.standard_normal((MM, 4)))[0]
    wm = (um * np.array([0.4, 0.3, 0.2, 0.1])) @ vm.T * 10
    rows, cols = np.nonzero(rng.random((MD, MM)) < 0.4)
    vals = (wm[rows, cols] + 0.01 * rng.standard_normal(rows.size)).astype(np.float32)
    return dict(x=x, y=y, labels=labels, rows=rows.astype(np.int32),
                cols=cols.astype(np.int32), vals=vals)


def _block_table(epochs, m, k, key=KEY):
    """The reference's fresh columns of every epoch, (T, m, k)."""
    return np.stack([np.stack([
        np.asarray(sphere_vector(jax.random.fold_in(jax.random.fold_in(key, t), 101 + j), m))
        for j in range(k)], axis=1) for t in range(epochs)])


def _noise_tables(epochs, iters, dims, key=KEY):
    """The reference's serial int8 noise: uniform(fold_in(fold_in(fold_in(
    fold_in(key, t), 0xC033), i), slot)) at the flattened block widths."""
    return [np.array([[np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(key, t), 0xC033), i), slot), (dim,), jnp.float32))
        for i in range(iters)] for t in range(epochs)]) for slot, dim in enumerate(dims)]


# ---------------------------------------------------------------------------
# Specs, capacity, probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["block:4", "block:2:adapt", "block:3:cold",
                                  "block:2:adapt:cold"])
def test_block_specs_parse_like_jax_and_run(spec):
    assert tuple(specs.parse_solver(spec)) == tuple(jspecs.parse_solver(spec))
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=3, solver=spec)
    assert cfg.solver == spec
    assert frank_wolfe.solver_probe_shape(spec, 7) == jfw.solver_probe_shape(spec, 7)


def test_gossip_with_block_is_rejected():
    """As in the reference: a SpecError at validation, and the epoch builder
    refuses a per-node graph."""
    for topo in ("ring", "gossip:2"):
        with pytest.raises(jspecs.SpecError):
            jspecs.validate(solver="block:2", topology=topo)
        with pytest.raises(specs.SpecError):
            specs.validate(solver="block:2", topology=topo)
        with pytest.raises(specs.SpecError):
            dfw.DFWConfig(mu=1.0, num_epochs=2, solver="block:2", topology=topo)
    gossip = make_topology("ring", num_workers=1)
    with pytest.raises(ValueError, match="rank1"):
        frank_wolfe.make_epoch_step(tasks.MultiTaskLeastSquares(4, 3), 1.0, 2,
                                    reducer=gossip, solver="block:2")


@pytest.mark.parametrize("max_rank,epochs,k", [(None, 7, 3), (30, 10, 3), (None, 5, 1)])
def test_resolve_max_rank_with_block_width(max_rank, epochs, k):
    assert engine.resolve_max_rank(max_rank, epochs, k) == jengine.resolve_max_rank(
        max_rank, epochs, k)
    with pytest.raises(ValueError):
        engine.resolve_max_rank(epochs * k - 1, epochs, k)
    with pytest.raises(ValueError):
        jengine.resolve_max_rank(epochs * k - 1, epochs, k)


def test_block_width_above_the_dims_is_rejected(data):
    with pytest.raises(ValueError, match="block width"):
        dfw.fit_serial(tasks.MultiTaskLeastSquares(D, M), data["x"][:50], data["y"][:50],
                       cfg=dfw.DFWConfig(mu=1.0, num_epochs=2, solver=f"block:{M + 1}"),
                       device="cpu")


def test_init_probe_is_orthonormal_and_seeded():
    p = frank_wolfe.init_probe("block:3", 10, "cpu")
    assert p.shape == (10, 3)
    _close(p.T @ p, np.eye(3), atol_rel=1e-5)
    torch.testing.assert_close(p, frank_wolfe.init_probe("block:3", 10, "cpu"), rtol=0, atol=0)
    assert frank_wolfe.init_probe("rank1", 10, "cpu") == ()
    stream = V0Stream(5)
    cols = stream.block(3, 11, 4, "cpu")
    _close(torch.linalg.vector_norm(cols, dim=0), np.ones(4))
    torch.testing.assert_close(cols, V0Stream(5).block(3, 11, 4, "cpu"), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Power method primitives
# ---------------------------------------------------------------------------


def test_orthonormalize_block_matches_jax():
    rng = np.random.default_rng(3)
    b = rng.standard_normal((40, 6)).astype(np.float32)
    got = power_method.orthonormalize_block(torch.from_numpy(b))
    _close(got, jpmeth.orthonormalize_block(jnp.asarray(b)), rtol=1e-5, atol_rel=1e-5)
    _close(got.T @ got, np.eye(6), atol_rel=1e-5)
    # the zero block maps to the zero block
    z = power_method.orthonormalize_block(torch.zeros(9, 3))
    assert torch.equal(z, torch.zeros(9, 3))
    np.testing.assert_array_equal(np.asarray(jpmeth.orthonormalize_block(jnp.zeros((9, 3)))),
                                  np.zeros((9, 3)))


def test_orthonormalize_rank_deficient_block():
    """Columns 3 and 4 repeat columns 0 and 1: the result is finite, spans
    the block's 3-dimensional column space, and its first three columns
    (the full-rank part) agree with the reference."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((30, 3)).astype(np.float32)
    b = np.concatenate([base, base[:, :2]], axis=1)
    got = power_method.orthonormalize_block(torch.from_numpy(b)).numpy()
    want = np.asarray(jpmeth.orthonormalize_block(jnp.asarray(b)))
    assert np.all(np.isfinite(got))
    q = np.linalg.qr(base)[0]
    _close(q @ (q.T @ got), got, rtol=1e-4, atol_rel=1e-4)  # inside span(B)
    _close(got[:, :3], want[:, :3], rtol=1e-4, atol_rel=1e-4)
    _close(got[:, :3].T @ got[:, :3], np.eye(3), atol_rel=1e-5)


def test_block_power_step_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((30, 20)).astype(np.float32)
    q = rng.standard_normal((20, 4)).astype(np.float32)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    p, q2 = power_method.block_power_step(lambda v: ta @ v, lambda u: ta.T @ u,
                                          torch.from_numpy(q))
    jp, jq2 = jpmeth.block_power_step(lambda v: ja @ v, lambda u: ja.T @ u, jnp.asarray(q))
    _close(p, jp, atol_rel=1e-5)
    _close(q2, jq2, atol_rel=1e-5)


def _spectrum_matrix(d, m, seed, decay=0.7):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((d, min(d, m))))[0]
    v = np.linalg.qr(rng.standard_normal((m, min(d, m))))[0]
    s = decay ** np.arange(min(d, m))
    return ((u * s) @ v.T).astype(np.float32)


@pytest.mark.parametrize("comm", ["dense", "int8", "topk:12"])
@pytest.mark.parametrize("adapt", [False, True])
def test_block_power_iterations_match_jax(comm, adapt):
    """Explicit (36, 28) matrix, k = 4, K = 8, each reducer; with ``adapt``
    the iteration stops early at the same count in both."""
    d, m, k, K = 36, 28, 4, 8
    a = _spectrum_matrix(d, m, 6)
    v0 = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    adapt_ref = 0.5
    kw = dict(adapt_rtol=0.05, adapt_ref=jnp.float32(adapt_ref)) if adapt else {}
    jres, jstate = jpmeth.block_power_iterations(
        lambda v: ja @ v, lambda u: ja.T @ u, jnp.asarray(v0), K,
        reducer=jmake_reducer(comm), key=key, **kw)
    noise = None
    if comm == "int8":
        tabs = [np.array([np.asarray(jax.random.uniform(jax.random.fold_in(
            jax.random.fold_in(key, i), slot), (dim,), jnp.float32)) for i in range(K)])[None]
            for slot, dim in enumerate((d * k, m * k))]
        noise = NoiseStream.from_tables(*tabs)
    reducer = {"dense": None, "int8": Int8Reducer(), "topk:12": TopKReducer(12)}[comm]
    state = () if reducer is None else reducer.init_state(d * k, m * k)
    res, tstate = power_method.block_power_iterations(
        lambda v: ta @ v, lambda u: ta.T @ u, torch.from_numpy(v0), K, reducer=reducer,
        comm_state=state, noise=noise,
        **(dict(adapt_rtol=0.05, adapt_ref=torch.tensor(adapt_ref)) if adapt else {}))
    assert res.iters == int(jres.iters)
    assert res.iters < K if adapt else res.iters == K
    if reducer is not None:
        assert reducer.exchanges == 2 * res.iters  # block_collective_rounds_contract
    assert power_method.block_collective_rounds_contract(K, k)["exchanges"] == 2 * K
    for got, want in ((res.u, jres.u), (res.v, jres.v), (res.sigma, jres.sigma),
                      (res.probe, jres.probe)):
        _close(got, want, rtol=1e-4, atol_rel=1e-4)
    if comm.startswith("topk"):
        for slot in ("u", "v"):
            _close(tstate[slot], jstate[slot], rtol=1e-4, atol_rel=1e-4)


def test_fw_update_block_matches_jax():
    rng = np.random.default_rng(8)
    d, m, k = 7, 5, 3
    u = rng.standard_normal((d, k)).astype(np.float32)
    v = rng.standard_normal((m, k)).astype(np.float32)
    c = np.array([0.5, 0.3, 0.2], np.float32)
    tit, jit = low_rank.init(12, d, m, device="cpu"), jlr.init(12, d, m)
    for gamma in (0.4, 1.0, 0.25):  # gamma = 1 kills the iterate: W <- S
        tit = low_rank.fw_update_block(tit, torch.from_numpy(u), torch.from_numpy(v),
                                       torch.from_numpy(c), torch.tensor(gamma), 2.0)
        jit = jlr.fw_update_block(jit, jnp.asarray(u), jnp.asarray(v), jnp.asarray(c),
                                  jnp.float32(gamma), 2.0)
        assert int(tit.count) == int(jit.count)
        for name in ("u", "s", "v", "alpha"):
            _close(getattr(tit, name), getattr(jit, name))
        _close(low_rank.materialize(tit), jlr.materialize(jit))
        u, v = u * 0.5, v[::-1].copy()


# ---------------------------------------------------------------------------
# The tasks' block atoms and the plain versions of the kernels' block forms
# ---------------------------------------------------------------------------


def _states(kind, data):
    if kind == "mtls":
        jt, tt = jtasks.MultiTaskLeastSquares(D, M), tasks.MultiTaskLeastSquares(D, M)
        x, y = data["x"][:200], data["y"][:200]
    elif kind == "logistic":
        jt, tt = jtasks.MultinomialLogistic(D, M), tasks.MultinomialLogistic(D, M)
        x, y = data["x"][:200], data["labels"][:200]
    else:
        jt, tt = jtasks.MatrixCompletion(MD, MM), tasks.MatrixCompletion(MD, MM)
        x, y = tasks.pack_observations(data["rows"], data["cols"], data["vals"])
        x, y = x.numpy(), y.numpy()
    return jt, tt, jt.init_state(jnp.asarray(x), jnp.asarray(y)), tt.init_state(
        torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y)))


@pytest.mark.parametrize("kind", ["mtls", "logistic", "mc"])
def test_task_block_update_and_linesearch_match_jax(kind, data):
    """The block atom (u with the blend folded in, (d, k); v (m, k)) in the
    three tasks' ``update`` and ``linesearch_terms``, twice in a row, and
    the plain operator chains (``matvec``/``rmatvec``) on blocks."""
    jt, tt, js, ts = _states(kind, data)
    rng = np.random.default_rng(10)
    k = 3
    for step, gamma in enumerate((0.5, 0.2)):
        u = (rng.standard_normal((tt.d, k)) * 0.3).astype(np.float32)
        v = rng.standard_normal((tt.m, k)).astype(np.float32)
        v /= np.linalg.norm(v, axis=0)
        tu, tv, ju, jv = torch.from_numpy(u), torch.from_numpy(v), jnp.asarray(u), jnp.asarray(v)
        _close(tt.matvec(ts, tv), jax.vmap(lambda c: jt.matvec(js, c), 1, 1)(jv), atol_rel=1e-5)
        _close(tt.rmatvec(ts, tu), jax.vmap(lambda c: jt.rmatvec(js, c), 1, 1)(ju), atol_rel=1e-5)
        if kind != "logistic":
            got = tt.linesearch_terms(ts, tu, tv, 1.5)
            want = jt.linesearch_terms(js, ju, jv, 1.5)
            _close([float(g) for g in got], [float(w) for w in want])
        ts = tt.update(ts, tu, tv, torch.tensor(gamma), 1.5)
        js = jt.update(js, ju, jv, jnp.float32(gamma), 1.5)
        _close(tt.local_loss(ts), jt.local_loss(js))
        field = {"mtls": "r", "logistic": "z", "mc": "resid"}[kind]
        _close(getattr(ts, field), getattr(js, field))
    if kind == "mc":
        # the sorted copies the update writes are the caller-order residual's
        for order in ("row", "col"):
            perm = getattr(ts, f"by_{order}").perm.long()
            assert torch.equal(ts.copies(order)[0], ts.resid[perm])


@pytest.mark.parametrize("n,m,k", [(300, 40, 5), (65, 33, 1), (37, 5, 3), (70, 9, 33)])
def test_matmat_rmatmat_plain_match_the_vmapped_jax_kernels(n, m, k):
    """K1: the plain matmat/rmatmat against the reference's Pallas
    matvec/rmatvec vmapped over the k columns, in interpret mode."""
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((n, m)) / np.sqrt(m)).astype(np.float32)
    v = rng.standard_normal((m, k)).astype(np.float32)
    u = rng.standard_normal((n, k)).astype(np.float32)
    ja = jnp.asarray(a)
    want_mm = jax.vmap(lambda c: jpm.ops.matvec(ja, c, block_r=64, block_c=64, interpret=True),
                       1, 1)(jnp.asarray(v))
    want_rmm = jax.vmap(lambda c: jpm.ops.rmatvec(ja, c, block_r=64, block_c=64,
                                                  interpret=True), 1, 1)(jnp.asarray(u))
    ta = torch.from_numpy(a)
    _close(pm.matmat(ta, torch.from_numpy(v)), want_mm)
    _close(pm.rmatmat(ta, torch.from_numpy(u)), want_rmm)


@pytest.mark.parametrize("k", [1, 4])
def test_rankk_update_plain_matches_jax_block_update(k, data):
    """K2: ``rankk_update_axpy`` is the MTLS block update and
    ``rankk_update`` the logistic one, held to the JAX block
    ``tasks.update`` (the reference forms (X u) v^T with XLA)."""
    rng = np.random.default_rng(12)
    x, y = data["x"][:100], data["y"][:100]
    u = (rng.standard_normal((D, k)) * 0.2).astype(np.float32)
    v = rng.standard_normal((M, k)).astype(np.float32)
    gamma, mu = 0.3, 1.25
    js = jtasks.MultiTaskLeastSquares(D, M).update(
        jtasks.MultiTaskLeastSquares(D, M).init_state(jnp.asarray(x), jnp.asarray(y)),
        jnp.asarray(u), jnp.asarray(v), jnp.float32(gamma), mu)
    r0 = -torch.from_numpy(y)
    xu = torch.from_numpy(x) @ torch.from_numpy(u)
    got = r1.rankk_update_axpy(r0, torch.from_numpy(y), xu, torch.from_numpy(v),
                               1.0 - gamma, -(gamma * mu), -gamma)
    _close(got, js.r)
    z0 = torch.from_numpy(rng.standard_normal((100, M)).astype(np.float32))
    got = r1.rankk_update(z0, xu, torch.from_numpy(v), 1.0 - gamma, -(gamma * mu))
    want = (1.0 - gamma) * z0.numpy() - (gamma * mu) * (xu.numpy() @ v.T)
    _close(got, want)
    out = z0.clone()
    assert r1.rankk_update(out, xu, torch.from_numpy(v), 0.5, 2.0, out=out) is out


@pytest.mark.parametrize("k", [3, 34])
def test_coo_matmat_plain_matches_the_vmapped_jax_kernel(k, data):
    """K3: ``coo_matmat`` over the row and the column order against the
    reference's COO matvec vmapped over the k columns (interpret mode)."""
    rows, cols = data["rows"], data["cols"]
    vals = np.random.default_rng(13).standard_normal(rows.size).astype(np.float32)
    x_v = np.random.default_rng(14).standard_normal((MM, k)).astype(np.float32)
    x_u = np.random.default_rng(15).standard_normal((MD, k)).astype(np.float32)
    tr, tc, tvals = (torch.from_numpy(a) for a in (rows, cols, vals))
    by_row = mc.build_order(tr, tc, MD, MM)
    by_col = mc.build_order(tc, tr, MM, MD)
    jr, jc, jv = jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals)
    want_gv = jax.vmap(lambda c: jmc.ops.matvec(jr, jc, jv, c, MD, block_e=128, interpret=True),
                       1, 1)(jnp.asarray(x_v))
    want_gu = jax.vmap(lambda c: jmc.ops.rmatvec(jr, jc, jv, c, MM, block_e=128,
                                                 interpret=True), 1, 1)(jnp.asarray(x_u))
    _close(mc.coo_matmat(by_row, mc.gather_sorted(by_row, tvals), torch.from_numpy(x_v)),
           want_gv)
    _close(mc.coo_matmat(by_col, mc.gather_sorted(by_col, tvals), torch.from_numpy(x_u)),
           want_gu)


@pytest.mark.parametrize("k", [1, 3, 17])
def test_update_resid_block_plain_matches_jax(k, data):
    """K4: ``update_resid`` with block factors against the JAX block
    ``MatrixCompletion.update``; its row- and column-order results are the
    caller-order result's entries, bit for bit (one chain in all three)."""
    jt, tt, js, ts = _states("mc", data)
    rng = np.random.default_rng(16)
    u = (rng.standard_normal((MD, k)) * 0.3).astype(np.float32)
    v = rng.standard_normal((MM, k)).astype(np.float32)
    gamma = torch.tensor(0.35)
    resid, by_row, by_col = mc.update_resid(
        gamma, 2.0, torch.from_numpy(u), torch.from_numpy(v), ts.rows, ts.cols, ts.resid,
        ts.vals, ts.weight, ts.by_row, ts.copies("row"), ts.by_col, ts.copies("col"))
    want = jt.update(js, jnp.asarray(u), jnp.asarray(v), jnp.float32(0.35), 2.0).resid
    _close(resid, want)
    assert torch.equal(by_row, resid[ts.by_row.perm.long()])
    assert torch.equal(by_col, resid[ts.by_col.perm.long()])


@pytest.mark.parametrize("k", [2, 3, 17])
def test_update_resid_caller_is_the_caller_order_of_update_resid(k, data):
    """The block line search's entry values: ``update_resid_caller`` gives
    the three-order ``update_resid``'s caller-order bits (gamma = 1, as the
    line search calls it, and another gamma)."""
    _, _, _, ts = _states("mc", data)
    rng = np.random.default_rng(17)
    u = torch.from_numpy((rng.standard_normal((MD, k)) * 0.3).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((MM, k)).astype(np.float32))
    for gamma in (torch.tensor(1.0), torch.tensor(0.35)):
        args = (gamma, 2.0, u, v, ts.rows, ts.cols, ts.resid, ts.vals, ts.weight)
        want = mc.update_resid(*args, ts.by_row, ts.copies("row"), ts.by_col,
                               ts.copies("col"))[0]
        assert torch.equal(mc.update_resid_caller(*args), want)


@pytest.mark.parametrize("bad", ["vector u", "k mismatch", "float64 v", "int64 rows"])
def test_update_resid_caller_refuses_bad_operands(bad, data):
    _, _, _, ts = _states("mc", data)
    u, v = torch.randn(MD, 3), torch.randn(MM, 3)
    rows = ts.rows
    if bad == "vector u":
        u = torch.randn(MD)
    elif bad == "k mismatch":
        v = torch.randn(MM, 4)
    elif bad == "float64 v":
        v = v.double()
    else:
        rows = rows.long()
    with pytest.raises((ValueError, TypeError)):
        mc.update_resid_caller(torch.tensor(1.0), 1.0, u, v, rows, ts.cols, ts.resid,
                               ts.vals, ts.weight)


def test_update_resid_rank1_bits_unchanged_by_the_block_form(data):
    """A rank-1 atom keeps the rank-1 chain: u[row] * v[col], then the step."""
    _, _, _, ts = _states("mc", data)
    u, v = torch.randn(MD), torch.randn(MM)
    got = mc.update_resid(torch.tensor(0.2), 1.5, u, v, ts.rows, ts.cols, ts.resid, ts.vals,
                          ts.weight, ts.by_row, ts.copies("row"), ts.by_col, ts.copies("col"))
    want = mc.ref.resid_step(torch.tensor(0.2), 1.5, ts.resid, ts.vals, ts.weight,
                             u[ts.rows], v[ts.cols])
    assert torch.equal(got[0], want)


# ---------------------------------------------------------------------------
# Whole fits against the reference
# ---------------------------------------------------------------------------


def _margins_recorder(monkeypatch):
    """Wraps the port's block power iteration to record, for every adaptive
    iteration, |criterion / threshold - 1| from the exchanged blocks."""
    margins = []
    orig = frank_wolfe.block_power_iterations

    def run(matmat, rmatmat, v0, num_iters, *, reducer, adapt_rtol=None, adapt_ref=None, **kw):
        sigs = []

        class Spy:
            def __getattr__(self, name):
                return getattr(reducer, name)

            def exchange(self, x, state, *, slot, **kws):
                out, state = reducer.exchange(x, state, slot=slot, **kws)
                if slot == "v":
                    sigs.append(torch.linalg.vector_norm(out.reshape(v0.shape[0], -1), dim=0))
                return out, state

        res = orig(matmat, rmatmat, v0, num_iters, reducer=Spy(), adapt_rtol=adapt_rtol,
                   adapt_ref=adapt_ref, **kw)
        prev = torch.zeros(v0.shape[1])
        for sig in sigs if adapt_rtol is not None else ():
            ref = torch.maximum(torch.max(sig), adapt_ref)
            crit = torch.max(torch.abs(sig - prev)) / (adapt_rtol * (ref + 1e-30))
            margins.append(abs(float(crit) - 1.0))
            prev = sig
        return res

    monkeypatch.setattr(frank_wolfe, "block_power_iterations", run)
    return margins


FITS = {
    "mtls-block4-linesearch": ("mtls", "block:4", dict(
        mu=1.0, num_epochs=12, schedule="const:3", step_size="linesearch")),
    "mtls-block4-cold": ("mtls", "block:4:cold", dict(
        mu=1.0, num_epochs=12, schedule="const:3", step_size="linesearch")),
    "mtls-block4-adapt": ("mtls", "block:4:adapt", dict(
        mu=1.0, num_epochs=12, schedule="const:6", step_size="linesearch")),
    "mtls-block3-log-default": ("mtls", "block:3", dict(mu=1.0, num_epochs=12, schedule="log")),
    "mtls-block4-int8": ("mtls", "block:4", dict(
        mu=1.0, num_epochs=10, schedule="const:2", step_size="linesearch", comm="int8")),
    "mtls-block3-topk": ("mtls", "block:3:cold", dict(
        mu=1.0, num_epochs=10, schedule="const:4", step_size="linesearch", comm="topk:24")),
    "mtls-block3-adapt-cold": ("mtls", "block:3:adapt:cold", dict(
        mu=1.0, num_epochs=10, schedule="const:8", step_size="linesearch")),
    "logistic-block4": ("logistic", "block:4", dict(mu=10.0, num_epochs=10,
                                                    schedule="log_half")),
    "mc-block2-linesearch": ("mc", "block:2", dict(
        mu=3.0, num_epochs=10, schedule="const:3", step_size="linesearch")),
    "logistic-block3-adapt-int8": ("logistic", "block:3:adapt", dict(
        mu=10.0, num_epochs=8, schedule="const:6", comm="int8")),
    "mc-block2-cold-topk": ("mc", "block:2:cold", dict(
        mu=3.0, num_epochs=8, schedule="const:3", step_size="linesearch", comm="topk:40")),
    "mc-block3-adapt-gap_tol": ("mc", "block:3:adapt", dict(
        mu=3.0, num_epochs=14, schedule="const:5", step_size="linesearch", gap_tol=1.0,
        block_epochs=4)),
}


def _problem(kind, data):
    if kind == "mtls":
        return (jtasks.MultiTaskLeastSquares(D, M), tasks.MultiTaskLeastSquares(D, M),
                data["x"], data["y"])
    if kind == "logistic":
        return (jtasks.MultinomialLogistic(D, M), tasks.MultinomialLogistic(D, M),
                data["x"], data["labels"])
    idx, yw = tasks.pack_observations(data["rows"], data["cols"], data["vals"])
    return (jtasks.MatrixCompletion(MD, MM), tasks.MatrixCompletion(MD, MM), idx.numpy(),
            yw.numpy())


def _assert_same_fit(tr, jr, rtol=1e-4):
    assert tr.epochs_run == jr.epochs_run
    for name in ("loss", "gap", "sigma", "gamma"):
        _close(tr.history[name], jr.history[name], rtol=rtol, atol_rel=1e-6)
    assert tr.history["k"] == jr.history["k"]
    _close(tr.final_loss, jr.final_loss, rtol=rtol)
    _close(low_rank.materialize(tr.iterate), jlr.materialize(jr.iterate), rtol=rtol,
           atol_rel=rtol)
    assert int(tr.iterate.count) == int(jr.iterate.count)


@pytest.mark.parametrize("case", list(FITS))
def test_fit_serial_block_matches_jax(case, data, monkeypatch):
    kind, solver, kw = FITS[case]
    jt, tt, x, y = _problem(kind, data)
    k = int(solver.split(":")[1])
    jp, tp = [], []
    jr = jdfw.fit_serial(jt, x, y, cfg=jdfw.DFWConfig(use_pallas=False, solver=solver, **kw),
                         key=KEY, callback=lambda s, aux: jp.extend(np.asarray(aux.piters)))
    noise = None
    if kw.get("comm") == "int8":
        noise = NoiseStream.from_tables(*_noise_tables(
            kw["num_epochs"], max(jr.history["k"]), (tt.d * k, tt.m * k)))
    margins = _margins_recorder(monkeypatch)
    tr = dfw.fit_serial(tt, x, y, cfg=dfw.DFWConfig(solver=solver, **kw),
                        key=V0Stream.from_table(_block_table(kw["num_epochs"], tt.m, k)),
                        noise=noise, probe=np.asarray(jfw.init_probe(solver, tt.m)),
                        device="cpu", callback=lambda s, aux: tp.extend(aux.piters))
    _assert_same_fit(tr, jr)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(jp))  # NaN rows too
    live = [p for p in tp if p == p]
    if ":adapt" in solver:
        print(f"{case}: piters {[int(p) for p in live]}; the stop criterion's least distance from its "
              f"threshold: {min(margins):.3e} of it")
        assert min(live) < max(tr.history["k"]), "the adaptive stop never fired"
        assert min(margins) > 1e-3
        # the engine counts one host read of the stop's verdict an iteration
        # run, beside a callback's per segment, gap_tol's per epoch and the
        # final loss's
        other = tr.stats["segments_run"] + (tr.epochs_run if "gap_tol" in kw else 0) + 1
        assert tr.stats["host_syncs"] == other + int(sum(live))
    else:
        assert live == tr.history["k"]
    if "gap_tol" in kw:
        assert tr.epochs_run < kw["num_epochs"]
    assert tr.probe.shape == (tt.m, k)


def _caveat_data():
    """tests/test_block_fw.py::test_warm_start_beats_cold_start's problem."""
    kx, kw = jax.random.split(jax.random.PRNGKey(6))
    w = jax.random.normal(kw, (32, 24))
    u, s, vt = jnp.linalg.svd(w, full_matrices=False)
    w = (u[:, :6] * s[:6]) @ vt[:6]
    w = w / jnp.linalg.norm(w, ord="nuc")
    x = jax.random.normal(kx, (600, 32))
    return np.asarray(x), np.asarray(x @ w)


@pytest.mark.parametrize("solver", ["block:6", "block:6:cold"])
def test_warm_and_cold_each_follow_the_reference(solver):
    """ROADMAP caveat (a): the reference's warm start does not beat its cold
    start on this problem (final gap 0.789 warm, 0.180 cold). The port holds
    each run to the reference's own trajectory and asserts nothing about
    which of the two wins.

    Tolerance 1e-2 on the histories and W: K = 2 iterations leave the k = 6
    block of this rank-6 problem unconverged, and the f32 differences of the
    two packages grow by about 10x an epoch over the last epochs of the cold
    run (under 5e-5 to epoch 11, then up to 2.1e-3 in sigma at epoch 14;
    the warm run stays under 5e-5). The two runs' own gaps differ by 4x."""
    x, y = (a.copy() for a in _caveat_data())
    kw = dict(mu=1.0, num_epochs=15, schedule="const:2", step_size="linesearch")
    jt, tt = jtasks.MultiTaskLeastSquares(32, 24), tasks.MultiTaskLeastSquares(32, 24)
    jr = jfw.fit(jt, jt.init_state(jnp.asarray(x), jnp.asarray(y)), key=KEY, solver=solver,
                 **kw)
    tr = frank_wolfe.fit(dfw.kernelize(tt), tt.init_state(torch.from_numpy(x),
                                                          torch.from_numpy(y)),
                         key=V0Stream.from_table(_block_table(15, 24, 6)), solver=solver,
                         probe=np.asarray(jfw.init_probe(solver, 24)), device="cpu", **kw)
    _assert_same_fit(tr, jr, rtol=1e-2)
    print(f"{solver}: final gap port {tr.history['gap'][-1]:.4f}, reference "
          f"{jr.history['gap'][-1]:.4f}; final loss {tr.final_loss:.5f}")


def test_block1_cold_tracks_rank1(data):
    """block:1:cold and rank1 reach the same top atom each epoch from
    different start vectors: the reference's own check, port only."""
    x, y = (np.ascontiguousarray(a) for a in (data["x"][:400, :24], data["y"][:400, :18]))
    task = tasks.MultiTaskLeastSquares(24, 18)
    kw = dict(mu=1.0, num_epochs=10, schedule="const:25", step_size="linesearch")
    r1_run = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(**kw), key=1, device="cpu")
    rb = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(solver="block:1:cold", **kw), key=1,
                        device="cpu")
    assert rb.history["loss"][0] == r1_run.history["loss"][0]
    np.testing.assert_allclose(rb.history["loss"], r1_run.history["loss"], rtol=2e-2)
    np.testing.assert_allclose(rb.history["gap"], r1_run.history["gap"], rtol=5e-2, atol=1e-4)
    assert rb.epochs_run == r1_run.epochs_run


def test_block_fit_routes_through_the_block_forms(data, monkeypatch):
    """MTLS per iteration: 2 matmat + 2 rmatmat; an epoch adds the update's
    and the line search's X U and one rankk_update_axpy; the vector forms are
    not called. The analytic comm cost counts (d + m) k floats an exchange,
    and the reducer made 2 exchanges per executed iteration."""
    calls = {}
    for mod, name in ((pm.ops, "matvec"), (pm.ops, "rmatvec"), (pm.ops, "matmat"),
                      (pm.ops, "rmatmat"), (r1.ops, "rankk_update_axpy"),
                      (r1.ops, "rank1_update_axpy")):
        fn = getattr(mod, name)
        calls[name] = 0

        def wrapper(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)
    k, epochs = 3, 5
    res = dfw.fit_serial(tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"],
                         cfg=dfw.DFWConfig(mu=1.0, num_epochs=epochs, schedule="const:2",
                                           step_size="linesearch", solver=f"block:{k}",
                                           verify_kernels=False), key=3, device="cpu")
    iters = sum(res.history["k"])
    assert calls == {"matvec": 0, "rmatvec": 0, "matmat": 2 * iters + 2 * epochs,
                     "rmatmat": 2 * iters, "rankk_update_axpy": epochs,
                     "rank1_update_axpy": 0}
    assert res.stats["comm_rounds"] == 2 * iters
    assert res.stats["comm_logical_bytes"] == 8 * (D + M) * k * iters
    assert int(res.iterate.count) == k * epochs


def test_block_checkpoint_reads_back_in_jax(data, tmp_path):
    """A block run's checkpoint, written by the port, read by the JAX
    package's ``restore_run``: the probe leaf, the iterate and the state are
    the port's, and the top-k residuals come back at d k and m k."""
    k = 3
    task = tasks.MultiTaskLeastSquares(D, M)
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=6, schedule="const:2", step_size="linesearch",
                        solver=f"block:{k}", comm="topk:20", block_epochs=3,
                        checkpoint_dir=str(tmp_path))
    res = dfw.fit_serial(task, data["x"][:200], data["y"][:200], cfg=cfg, key=2,
                         device="cpu")
    _, extra = jckpt.read_run_extra(str(tmp_path))
    assert extra["solver"] == f"block:{k}" and extra["payload_format"] == 3
    jtask = jtasks.MultiTaskLeastSquares(D, M)
    snap = jckpt.restore_run(str(tmp_path), state_like=jtask.init_state(
        jnp.asarray(data["x"][:200]), jnp.asarray(data["y"][:200])))
    assert snap.t == 6
    np.testing.assert_array_equal(np.asarray(snap.carry.probe), res.probe.numpy())
    packed = low_rank.pack_live(res.iterate)
    for key_ in low_rank.PACKED_KEYS:
        np.testing.assert_array_equal(np.asarray(snap.carry.iterate[key_]), packed[key_])
    np.testing.assert_array_equal(np.asarray(snap.carry.state.r), res.state.r.numpy())
    for slot, dim in (("u", D * k), ("v", M * k)):
        assert np.asarray(snap.carry.comm_state[slot]).shape == (dim,)
        np.testing.assert_array_equal(np.asarray(snap.carry.comm_state[slot]),
                                      res.comm_state[slot].numpy())
    assert snap.history["k"] == res.history["k"]
