"""The port's int8 and top-k reducers (``repro_torch.comm``) and the
quantize kernel module against the JAX package, on the CPU.

The same numpy inputs, and the same uniform noise, go through ``repro`` and
``repro_torch``. The port's quantize/dequantize must give the bits of the
JAX package's plain versions (``kernels/quantize/ref.py``, run op by op):
``budget / (scale + 1e-30)`` is one f32 division, and the multiply and the
add are rounded one at a time. Under ``jax.jit`` (the Pallas ops in
interpret mode, and the reducer inside a fit) XLA on the CPU rewrites two
of those steps: it contracts ``x * inv + noise`` into one FMA, and divides
by the constant budget by multiplying with its f32 reciprocal. So against
jitted JAX code quantize agrees exactly on random inputs (which do not land
within an ulp of an integer; the boundary test shows where the FMA floors
differently) and dequantize to two ulps (the steps s / b and
s * f32(1 / b) differ by at most one ulp, and the product with the integer
rounds that to at most two). A whole int8 fit is held to the
JAX fit with the JAX run's start vectors and noise injected, at the
histories' rtol 1e-4 of the dense fits (tests/test_torch_fit.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.kernels import quantize as jq
from repro.launch import dfw as jdfw
from repro_torch import NoiseStream, V0Stream, kernels
from repro_torch import comm
from repro_torch.core import frank_wolfe, tasks
from repro_torch.kernels import quantize as tq
from repro_torch.launch import dfw

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
RTOL = 1e-4


def jax_tables(key, epochs, iters, d, m):
    """The JAX run's start vectors and int8 noise: v0 of epoch t is
    sphere_vector(fold_in(key, t), m); exchange (t, i, slot) draws
    uniform(fold_in(fold_in(fold_in(fold_in(key, t), 0xC033), i), slot))."""
    v0, nu, nv = [], [], []
    for t in range(epochs):
        ekey = jax.random.fold_in(key, t)
        v0.append(np.asarray(sphere_vector(ekey, m)))
        ckey = jax.random.fold_in(ekey, 0xC033)
        ki = [jax.random.fold_in(ckey, i) for i in range(iters)]
        nu.append([np.asarray(jax.random.uniform(jax.random.fold_in(k, 0), (d,))) for k in ki])
        nv.append([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (m,))) for k in ki])
    return V0Stream.from_table(np.stack(v0)), NoiseStream.from_tables(np.array(nu), np.array(nv))


def _vec(rng, n, spread):
    return (rng.standard_normal(n) * spread).astype(np.float32)


@pytest.mark.parametrize("n,budget", [(1, 127), (37, 127), (300, 15), (1000, 63), (513, 1)])
def test_quantize_pair_matches_jax_bit_for_bit(n, budget):
    rng = np.random.default_rng(n + budget)
    x = _vec(rng, n, 3.0)
    noise = rng.random(n).astype(np.float32)
    for scale in (np.abs(x).max(), np.float32(0.7) * np.abs(x).max(), np.float32(0.0)):
        scale = np.float32(scale)
        jx, jn, js = jnp.asarray(x), jnp.asarray(noise), jnp.asarray(scale)
        want = np.asarray(jq.ref.quantize(jx, jn, js, budget))
        interp = np.asarray(jq.ops.quantize(jx, jn, js, budget=budget, block_n=64,
                                            interpret=True))
        got = tq.quantize(torch.from_numpy(x), torch.from_numpy(noise), torch.tensor(scale),
                          budget=budget)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), interp)
        jd = np.asarray(jq.ref.dequantize(jnp.asarray(want), js, budget))
        jdi = np.asarray(jq.ops.dequantize(jnp.asarray(want), js, budget=budget, block_n=64,
                                           interpret=True))
        td = tq.dequantize(got, torch.tensor(scale), budget=budget).numpy()
        np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))
        np.testing.assert_array_max_ulp(td, jdi, maxulp=2)  # jit: * f32(1/budget)


def test_quantize_at_integer_boundaries():
    """x * inv + noise landing on and beside integers floors like the JAX
    plain version, op by op. Jitted, XLA contracts the multiply-add into an
    FMA, and that floors some of these differently; the kernel's intrinsics
    keep the plain version's two roundings. (The neighbours of 0 are left
    out: they are subnormal, and XLA on the CPU flushes those to zero.)"""
    b, scale = 127, np.float32(3.0)
    k = np.concatenate([np.arange(-127, 0), np.arange(1, 128)]).astype(np.float32)
    x = (k * scale / b).astype(np.float32)
    x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf)), np.float32([0.0])])
    fma_differs = 0
    for noise in (np.zeros_like(x), np.full_like(x, 0.5), np.full_like(x, np.float32(1 - 2**-24))):
        args = (jnp.asarray(x), jnp.asarray(noise), jnp.asarray(scale))
        want = np.asarray(jq.ref.quantize(*args, b))
        jitted = np.asarray(jax.jit(lambda a, n, s: jq.ref.quantize(a, n, s, b))(*args))
        got = tq.quantize(torch.from_numpy(x), torch.from_numpy(noise), torch.tensor(scale),
                          budget=b)
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.max(np.abs(jitted.astype(int) - want.astype(int))) <= 1
        fma_differs += int(np.sum(jitted != want))
    assert fma_differs > 0  # the boundary cases are really there


@pytest.mark.parametrize("case", ["x", "noise", "scale", "budget", "q"])
def test_quantize_wrappers_refuse_bad_inputs(case):
    x, noise, s = torch.randn(8), torch.rand(8), torch.tensor(1.0)
    if case == "x":
        with pytest.raises(TypeError):
            tq.quantize(x.double(), noise, s, budget=3)
    elif case == "noise":
        with pytest.raises(ValueError):
            tq.quantize(x, torch.rand(7), s, budget=3)
    elif case == "scale":
        with pytest.raises(TypeError):
            tq.quantize(x, noise, torch.ones(2), budget=3)
    elif case == "budget":
        for b in (0, 128):
            with pytest.raises(ValueError):
                tq.quantize(x, noise, s, budget=b)
    else:
        with pytest.raises(TypeError):
            tq.dequantize(torch.zeros(8, dtype=torch.int32), s, budget=3)


@pytest.mark.parametrize("workers", [1, 8])
@pytest.mark.parametrize("slot,dim", [("u", 300), ("v", 41)])
def test_int8_exchange_matches_jax_reducer(workers, slot, dim):
    rng = np.random.default_rng(dim + workers)
    x = _vec(rng, dim, 0.3)
    key = jax.random.PRNGKey(dim)
    jr = jcomm.make_reducer("int8", num_workers=workers, use_pallas=False)
    want, jstate = jr.exchange(jnp.asarray(x), (), slot=slot, key=key)
    tr = comm.make_reducer("int8", num_workers=workers)
    assert tr.budget == jr.budget and tr.spec == jr.spec
    noise = np.asarray(jax.random.uniform(key, (dim,), jnp.float32))
    got, state = tr.exchange(torch.from_numpy(x), (), slot=slot,
                             noise=lambda n, dev: torch.tensor(noise, device=dev))
    assert state == () and jstate == () and tr.exchanges == 1
    # exact against the JAX plain versions, op by op ...
    xj, nj = jnp.asarray(x), jnp.asarray(noise)
    scale = jnp.max(jnp.abs(xj))
    plain = jq.ref.dequantize(jq.ref.quantize(xj, nj, scale, jr.budget), scale, jr.budget)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(plain).view(np.int32))
    # ... and to two ulps against the jitted JAX reducer (* f32(1/budget))
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=2)


def test_int8_exchange_needs_noise_and_checks_workers():
    with pytest.raises(ValueError, match="noise"):
        comm.Int8Reducer().exchange(torch.ones(3), (), slot="u")
    for n in (0, 128):
        with pytest.raises(ValueError, match="1..127 workers"):
            comm.Int8Reducer(num_workers=n)
        with pytest.raises(ValueError, match="1..127 workers"):
            jcomm.Int8Reducer(num_workers=n)


@pytest.mark.parametrize("spec,workers", [("dense", 1), ("int8", 1), ("int8", 8), ("topk:16", 1),
                                          ("topk:16", 8)])
def test_wire_bytes_match_jax(spec, workers):
    jr = jcomm.make_reducer(spec, num_workers=workers)
    tr = comm.make_reducer(spec, num_workers=workers)
    for dim in (1, 384, 480_189):
        assert tr.wire_bytes(dim, workers) == jr.wire_bytes(dim, workers)


def test_make_reducer_ports_dense_and_int8_only():
    """Every comm spec builds its reducer (top-k since the slice that
    ported it; before, "topk:4" raised NotYetPorted here)."""
    assert isinstance(comm.make_reducer("dense"), comm.DenseReducer)
    assert comm.make_reducer("int8", num_workers=8).budget == 15
    topk = comm.make_reducer("topk:4")
    assert isinstance(topk, comm.TopKReducer) and topk.k == 4 and topk.spec == "topk:4"
    assert topk.spec == jcomm.make_reducer("topk:4").spec
    assert dfw.DFWConfig(mu=1.0, num_epochs=2, comm="int8").comm == "int8"
    assert dfw.DFWConfig(mu=1.0, num_epochs=2, comm="topk:4").comm == "topk:4"


def test_verify_quantize_kernels_is_exact_on_cpu(monkeypatch):
    assert comm.verify_quantize_kernels(device="cpu") == 0.0
    # a quantize that rounds the other way is caught
    bad = tq.ops.quantize
    monkeypatch.setattr(tq.ops, "quantize", lambda x, n, s, budget: bad(x, 1.0 - n, s,
                                                                        budget=budget))
    with pytest.raises(AssertionError, match="quantize kernel diverges"):
        comm.verify_quantize_kernels(device="cpu")


def test_noise_stream_free_run_and_tables():
    s = NoiseStream(7)
    a = s(3, 1, "u", 500, "cpu")
    assert a.dtype == torch.float32 and a.shape == (500,)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    s(0, 0, "v", 9, "cpu")  # another draw in between changes nothing
    assert torch.equal(NoiseStream(7)(3, 1, "u", 500, "cpu"), a)
    for other in (s(3, 1, "v", 500, "cpu"), s(3, 0, "u", 500, "cpu"), s(2, 1, "u", 500, "cpu"),
                  NoiseStream(8)(3, 1, "u", 500, "cpu")):
        assert not torch.equal(other, a)
    u, v = np.random.default_rng(0).random((2, 4, 2, 5)).astype(np.float32)
    t = NoiseStream.from_tables(u, v[..., :3])
    np.testing.assert_array_equal(t(2, 1, "u", 5, "cpu").numpy(), u[2, 1])
    np.testing.assert_array_equal(t(3, 0, "v", 3, "cpu").numpy(), v[3, 0, :3])
    with pytest.raises(IndexError):
        t(4, 0, "u", 5, "cpu")
    with pytest.raises(ValueError):
        s(0, 0, "w", 5, "cpu")


def test_power_method_makes_2k_int8_exchanges_through_the_kernels():
    """An int8 epoch with K power iterations makes 2K exchanges, each one
    quantize and one dequantize: the launch counts the card run expects."""
    calls = {"quantize": 0, "dequantize": 0}
    qz, dq = tq.ops.quantize, tq.ops.dequantize

    def count(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    y = rng.standard_normal((64, 9)).astype(np.float32)
    task = dfw.kernelize(tasks.MultiTaskLeastSquares(12, 9))
    red = comm.Int8Reducer()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq.ops, "quantize", count("quantize", qz))
        mp.setattr(tq.ops, "dequantize", count("dequantize", dq))
        res = frank_wolfe.fit(task, task.init_state(torch.from_numpy(x), torch.from_numpy(y)),
                              mu=1.0, num_epochs=7, schedule="log", reducer=red, device="cpu")
    iters = sum(res.history["k"])
    assert red.exchanges == 2 * iters == calls["quantize"] == calls["dequantize"]
    kernels.reset_launches()  # the CPU path launched nothing
    assert all(v == 0 for v in kernels.launches().values())


@pytest.fixture(scope="module")
def mtls_data():
    rng = np.random.default_rng(0)
    n, d, m = 256, 24, 20
    w = rng.standard_normal((d, 4)) @ rng.standard_normal((4, m)) / 30
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((n, m))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("step", ["default", "linesearch"])
def test_int8_fit_serial_mtls_matches_jax(mtls_data, step):
    x, y = mtls_data
    d, m = x.shape[1], y.shape[1]
    kw = dict(mu=1.0, num_epochs=12, schedule="const:2", step_size=step, comm="int8")
    jr = jdfw.fit_serial(jtasks.MultiTaskLeastSquares(d, m), x, y, key=KEY,
                         cfg=jdfw.DFWConfig(use_pallas=False, **kw))
    v0, noise = jax_tables(KEY, 12, max(jr.history["k"]), d, m)
    tr = dfw.fit_serial(tasks.MultiTaskLeastSquares(d, m), x, y, cfg=dfw.DFWConfig(**kw),
                        key=v0, noise=noise, device="cpu")
    assert tr.history["k"] == jr.history["k"] and tr.epochs_run == jr.epochs_run
    for name in ("loss", "gap", "sigma", "gamma"):
        np.testing.assert_allclose(tr.history[name], jr.history[name], rtol=RTOL,
                                   atol=1e-6 * np.max(np.abs(jr.history[name])))
    np.testing.assert_allclose(tr.final_loss, jr.final_loss, rtol=RTOL)


# ---------------------------------------------------------------------------
# top-k: the reference's tie rule and error feedback
# ---------------------------------------------------------------------------


def _topk_inputs(rng, dim):
    """Integer-valued f32 vectors with many equal magnitudes (±1..±4 and 0)."""
    return rng.integers(-4, 5, dim).astype(np.float32)


@pytest.mark.parametrize("k,dim", [(4, 16), (8, 33), (16, 16), (40, 30)])
def test_topk_exchange_matches_jax_with_ties(k, dim):
    """Equal magnitudes: the port takes the lower index first, as
    jax.lax.top_k does, so both send the same indices and keep the same
    residual, exchange after exchange (state threaded through)."""
    rng = np.random.default_rng(k * dim)
    jr, tr = jcomm.TopKReducer(k=k), comm.make_reducer(f"topk:{k}")
    jst, tst = jr.init_state(dim, 3), tr.init_state(dim, 3)
    for step in range(5):
        x = _topk_inputs(rng, dim)
        want_idx = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(x) + jst["u"]), min(k, dim))[1])
        got_idx = comm.topk.top_k_indices(torch.from_numpy(x) + tst["u"], min(k, dim))
        np.testing.assert_array_equal(got_idx.numpy(), want_idx)
        want, jst = jr.exchange(jnp.asarray(x), jst, slot="u", key=KEY)
        got, tst = tr.exchange(torch.from_numpy(x), tst, slot="u")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tst["u"].numpy(), np.asarray(jst["u"]))
        np.testing.assert_array_equal(tst["v"].numpy(), np.asarray(jst["v"]))
    assert tr.exchanges == 5


def test_topk_exact_when_k_covers_dim():
    r = comm.TopKReducer(k=64)
    st = r.init_state(16, 12)
    x = torch.randn(16, generator=torch.Generator().manual_seed(0))
    y, st = r.exchange(x, st, slot="u")
    assert torch.equal(y, x) and float(torch.linalg.vector_norm(st["u"])) == 0.0


def test_topk_error_feedback_residual_decays():
    """The reference's EF check (tests/test_comm.py): for a constant input
    the residual stays under the EF plateau and the running mean's error
    decays as O(1/T) (sum_t y_t = T x - e_T)."""
    r = comm.TopKReducer(k=8)
    d = 32
    st = {"u": torch.zeros(d), "v": torch.zeros(2)}
    x = torch.from_numpy(np.array(jax.random.normal(KEY, (d,))))
    x_norm = float(torch.linalg.vector_norm(x))
    ys, enorms = [], []
    for _ in range(64):
        y, st = r.exchange(x, st, slot="u")
        ys.append(y.numpy())
        enorms.append(float(torch.linalg.vector_norm(st["u"])))
    c = np.sqrt(1.0 - r.k / d)
    assert max(enorms) <= c / (1.0 - c) * x_norm * (1 + 1e-5)
    err_10 = np.linalg.norm(np.mean(ys[:10], axis=0) - x.numpy())
    err_64 = np.linalg.norm(np.mean(ys, axis=0) - x.numpy())
    assert err_64 < err_10 / 2.0
    np.testing.assert_allclose(err_64, enorms[-1] / 64, rtol=1e-4)


def test_topk_masked_worker_sends_nothing_and_freezes_residual():
    """Weight 0: nothing sent, residual frozen; any weight > 0 (a fractional
    reweight too) sends as a full participant does; all as in the
    reference."""
    r, jr = comm.TopKReducer(k=4), jcomm.TopKReducer(k=4)
    e0 = np.asarray(jax.random.normal(KEY, (16,)))
    st = {"u": torch.from_numpy(e0.copy()), "v": torch.zeros(2)}
    y, st2 = r.exchange(torch.zeros(16), st, slot="u", weight=0.0)
    assert torch.equal(y, torch.zeros(16)) and np.array_equal(st2["u"].numpy(), e0)
    x = np.array(jax.random.normal(jax.random.fold_in(KEY, 2), (16,)))
    y_w, s_w = r.exchange(torch.from_numpy(x), st, slot="u", weight=8.0 / 5.0)
    y_n, s_n = r.exchange(torch.from_numpy(x), st, slot="u", weight=None)
    assert torch.equal(y_w, y_n) and torch.equal(s_w["u"], s_n["u"])
    want, jst = jr.exchange(jnp.asarray(x), {"u": jnp.asarray(e0), "v": jnp.zeros(2)},
                            slot="u", key=KEY, weight=jnp.float32(8.0 / 5.0))
    np.testing.assert_array_equal(y_w.numpy(), np.asarray(want))
    np.testing.assert_array_equal(s_w["u"].numpy(), np.asarray(jst["u"]))


@pytest.mark.parametrize("k", [1, 16, 64])
def test_topk_wire_bytes_match_jax(k):
    jr, tr = jcomm.TopKReducer(k=k), comm.TopKReducer(k=k)
    for dim in (1, 30, 384, 480_189):
        for workers in (1, 2, 4, 8, 96):
            assert tr.wire_bytes(dim, workers) == jr.wire_bytes(dim, workers) \
                == workers * min(k, dim) * 8


def test_wire_byte_ratios_of_the_benchmark():
    """BENCH_smoke.json table1.measured_epoch: one epoch at d = 256, m = 128,
    K = 2 on 8 workers, with the four exact scalar sums; the port's wire
    bytes give its ratios to dense, int8 3.86x and topk:16 1.5x."""
    def epoch(spec):
        r = comm.make_reducer(spec, num_workers=8)
        return 2 * (r.wire_bytes(256, 8) + r.wire_bytes(128, 8)) + 4 * 2 * 4

    assert [epoch(s) for s in ("dense", "int8", "topk:16")] == [6176, 1600, 4128]
    assert round(epoch("dense") / epoch("int8"), 2) == 3.86
    assert round(epoch("dense") / epoch("topk:16"), 2) == 1.5


def test_topk_fit_serial_matches_jax(mtls_data):
    """A serial top-k fit (one worker's error feedback) against the JAX
    fit_serial with its start vectors injected: the histories at the dense
    fits' rtol 1e-4, W to 1e-4 of its max."""
    x, y = mtls_data
    d, m = x.shape[1], y.shape[1]
    kw = dict(mu=1.0, num_epochs=12, schedule="const:2", step_size="linesearch", comm="topk:8")
    jr = jdfw.fit_serial(jtasks.MultiTaskLeastSquares(d, m), x, y, key=KEY,
                         cfg=jdfw.DFWConfig(use_pallas=False, **kw))
    v0, _ = jax_tables(KEY, 12, 2, d, m)
    tr = dfw.fit_serial(tasks.MultiTaskLeastSquares(d, m), x, y, cfg=dfw.DFWConfig(**kw),
                        key=v0, device="cpu")
    assert tr.history["k"] == jr.history["k"]
    for name in ("loss", "gap", "sigma", "gamma"):
        np.testing.assert_allclose(tr.history[name], jr.history[name], rtol=RTOL,
                                   atol=1e-6 * np.max(np.abs(jr.history[name])))
    from repro.core import low_rank as jlr
    from repro_torch.core import low_rank

    W, W_ref = low_rank.materialize(tr.iterate).numpy(), np.asarray(jlr.materialize(jr.iterate))
    assert np.max(np.abs(W - W_ref)) <= 1e-4 * np.max(np.abs(W_ref))


def test_topk_run_continues_from_the_jax_comm_state(mtls_data, tmp_path):
    """A JAX top-k run stopped at epoch 6 (its checkpoint: state, iterate,
    error-feedback residuals) continues in the port (``convert``) to epoch
    12 and tracks the uninterrupted JAX run: the histories at rtol 1e-4, W
    to 1e-4 of its max. Without the residuals it would restart the error
    feedback from zero."""
    from repro.checkpoint import restore_run
    from repro.core import low_rank as jlr
    from repro_torch import convert
    from repro_torch.core import low_rank

    x, y = mtls_data
    d, m = x.shape[1], y.shape[1]
    kw = dict(mu=1.0, schedule="const:2", step_size="linesearch", comm="topk:4")
    jtask = jtasks.MultiTaskLeastSquares(d, m)
    full = jdfw.fit_serial(jtask, x, y, key=KEY,
                           cfg=jdfw.DFWConfig(num_epochs=12, use_pallas=False, **kw))
    jdfw.fit_serial(jtask, x, y, key=KEY, cfg=jdfw.DFWConfig(
        num_epochs=6, use_pallas=False, checkpoint_dir=str(tmp_path), **kw))
    snap = restore_run(tmp_path, state_like=jtask.init_state(x, y))
    assert snap.t == 6 and set(snap.carry.comm_state) == {"u", "v"}
    cs = convert.comm_state(snap.carry.comm_state, device="cpu")
    assert float(torch.linalg.vector_norm(cs["u"])) > 0  # k = 4 < d: mass withheld
    v0, _ = jax_tables(KEY, 12, 2, d, m)
    ttask = dfw.kernelize(tasks.MultiTaskLeastSquares(d, m))
    got = frank_wolfe.fit(
        ttask, convert.task_state(snap.carry.state, device="cpu"),
        iterate=convert.iterate(snap.carry.iterate, 12, device="cpu"), comm_state=cs,
        start_t=snap.t, initial_history=snap.history, num_epochs=12, key=v0, mu=1.0,
        schedule="const:2", step_size="linesearch", reducer=comm.make_reducer("topk:4"),
        device="cpu")
    for name in ("loss", "gap", "sigma", "gamma"):
        np.testing.assert_allclose(got.history[name], full.history[name], rtol=RTOL,
                                   atol=1e-6 * np.max(np.abs(full.history[name])))
    W, W_ref = low_rank.materialize(got.iterate).numpy(), np.asarray(jlr.materialize(full.iterate))
    assert np.max(np.abs(W - W_ref)) <= 1e-4 * np.max(np.abs(W_ref))
    with pytest.raises(TypeError):
        convert.comm_state({"w": np.zeros(3)}, device="cpu")
    stacked = {"u": np.arange(12, dtype=np.float32).reshape(3, 4), "v": np.zeros((3, 2))}
    np.testing.assert_array_equal(convert.comm_state(stacked, worker=1, device="cpu")["u"],
                                  [4, 5, 6, 7])
