"""The port's core modules against the JAX package, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``. Tolerances
are stated per test; the common one is rtol 1e-5 with an atol of 1e-6 times
max|reference|, for f32 results whose sums run in another order.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import specs as jspecs
from repro.core import engine as jengine
from repro.core import frank_wolfe as jfw
from repro.core import low_rank as jlr
from repro.core import power_method as jpmeth
from repro.core import tasks as jtasks
from repro.launch import dfw as jdfw
from repro_torch import V0Stream, convert, specs
from repro_torch.comm import DenseReducer
from repro_torch.core import engine, frank_wolfe, low_rank, power_method, tasks, trace_norm
from repro_torch.launch import dfw

# ``repro.core`` re-exports a function named trace_norm over its module.
jtn = importlib.import_module("repro.core.trace_norm")

torch.set_num_threads(2)

N, D, M = 512, 48, 40


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, 4)) @ rng.standard_normal((4, M)) / 40).astype(np.float32)
    y = (x @ w + 0.1 * rng.standard_normal((N, M))).astype(np.float32)
    labels = np.argmax(x @ w + 0.3 * rng.standard_normal((N, M)), axis=1).astype(np.int32)
    u = rng.standard_normal(D).astype(np.float32)
    v = rng.standard_normal(M).astype(np.float32)
    z0 = (0.2 * rng.standard_normal((N, M))).astype(np.float32)
    return dict(x=x, y=y, labels=labels, u=u / np.linalg.norm(u), v=v / np.linalg.norm(v), z0=z0)


# ---------------------------------------------------------------------------
# trace_norm, low_rank
# ---------------------------------------------------------------------------


def test_trace_norm_functions():
    _close(trace_norm.duality_gap(torch.tensor(-3.5), torch.tensor(2.25), 1.5),
           jtn.duality_gap(jnp.float32(-3.5), jnp.float32(2.25), 1.5))
    for t in (0, 1, 7, 1000):
        _close(trace_norm.default_step_size(torch.tensor(float(t))),
               jtn.default_step_size(jnp.float32(t)), rtol=0, atol_rel=0)
    s = trace_norm.lmo_trace_ball(torch.ones(3), torch.ones(2), 2.0)
    assert float(s.scale) == float(jtn.lmo_trace_ball(jnp.ones(3), jnp.ones(2), 2.0).scale)


def test_fw_update_sequence_matches_jax_including_gamma_one():
    """Same (u, v, gamma) sequence -> same factors; gamma = 1 at t = 3 must
    zero the live factors (the alpha-underflow rule), not resurrect them."""
    rng = np.random.default_rng(4)
    d, m, mu = 7, 5, 1.5
    gammas = [1.0, 0.5, 0.25, 1.0, 0.2, 2 / 7]
    jit = jlr.init(len(gammas), d, m)
    tit = low_rank.init(len(gammas), d, m, device="cpu")
    for g in gammas:
        u = rng.standard_normal(d).astype(np.float32)
        v = rng.standard_normal(m).astype(np.float32)
        jit = jlr.fw_update(jit, jnp.asarray(u), jnp.asarray(v), jnp.float32(g), mu)
        tit = low_rank.fw_update(tit, _t(u), _t(v), torch.tensor(g, dtype=torch.float32), mu)
    for name in ("u", "s", "v", "alpha"):
        _close(getattr(tit, name), getattr(jit, name))
    assert int(tit.count) == int(jit.count) == len(gammas)
    _close(low_rank.materialize(tit), jlr.materialize(jit))
    xd = rng.standard_normal(m).astype(np.float32)
    xm = rng.standard_normal(d).astype(np.float32)
    _close(low_rank.matvec(tit, _t(xd)), jlr.matvec(jit, jnp.asarray(xd)))
    _close(low_rank.rmatvec(tit, _t(xm)), jlr.rmatvec(jit, jnp.asarray(xm)))


def test_pack_live_round_trip_and_convert_from_jax():
    rng = np.random.default_rng(5)
    jit = jlr.init(6, 4, 3)
    for g in (1.0, 0.5, 0.3):
        jit = jlr.fw_update(jit, jnp.asarray(rng.standard_normal(4), jnp.float32),
                            jnp.asarray(rng.standard_normal(3), jnp.float32), jnp.float32(g), 1.0)
    packed = jlr.pack_live(jit)
    for src in (packed, jit):  # the packed dict or the full FactoredIterate
        tit = convert.iterate(src, 9, device="cpu")
        assert tit.u.shape == (9, 4) and int(tit.count) == 3
        _close(low_rank.materialize(tit), jlr.materialize(jit))
    back = low_rank.pack_live(tit)
    for name in packed:
        np.testing.assert_array_equal(back[name], packed[name])
    with pytest.raises(ValueError):
        low_rank.unpack_live(back, 2, device="cpu")


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def _task_pair(kind, data):
    if kind == "mtls":
        j, t = jtasks.MultiTaskLeastSquares(D, M), tasks.MultiTaskLeastSquares(D, M)
        js = j.init_state(jnp.asarray(data["x"]), jnp.asarray(data["y"]))
        js = js._replace(r=js.r + jnp.asarray(data["z0"]))  # a residual away from W = 0
    else:
        j, t = jtasks.MultinomialLogistic(D, M), tasks.MultinomialLogistic(D, M)
        js = j.init_state(jnp.asarray(data["x"]), jnp.asarray(data["labels"]))
        js = js._replace(z=jnp.asarray(data["z0"]))
    return j, t, js, convert.task_state(js, device="cpu")


@pytest.mark.parametrize("kind", ["mtls", "logistic"])
def test_task_operators_match_jax(kind, data):
    """matvec/rmatvec (plain and kernel-routed), loss, inner, linesearch.
    index_add_ and softmax sum in another order than XLA: rtol 1e-5."""
    j, t, js, ts = _task_pair(kind, data)
    kt, kj = dfw.kernelize(t), jdfw.kernelize(j, use_pallas=False)
    u, v = data["u"], data["v"]
    want_mv = j.matvec(js, jnp.asarray(v))
    want_rmv = j.rmatvec(js, jnp.asarray(u))
    _close(t.matvec(ts, _t(v)), want_mv)
    _close(kt.matvec(ts, _t(v)), want_mv)
    _close(kt.matvec(ts, _t(v)), kj.matvec(js, jnp.asarray(v)))
    _close(t.rmatvec(ts, _t(u)), want_rmv)
    _close(kt.rmatvec(ts, _t(u)), want_rmv)
    _close(t.local_loss(ts), j.local_loss(js))
    _close(t.inner_w_grad(ts), j.inner_w_grad(js))
    if kind == "mtls":
        got = t.linesearch_terms(ts, _t(u), _t(v), 1.3)
        want = j.linesearch_terms(js, jnp.asarray(u), jnp.asarray(v), 1.3)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("kind", ["mtls", "logistic"])
@pytest.mark.parametrize("gamma", [0.4, 1.0])
def test_task_update_matches_jax(kind, gamma, data):
    """The port's update goes through rank1_update; it is held to JAX's
    ``tasks.update`` (not to the kernel's plain version). The fused form
    adds a*Z + b*x y^T + c*Y in another order than JAX: rtol 1e-5."""
    j, t, js, ts = _task_pair(kind, data)
    u, v = jnp.asarray(data["u"]), jnp.asarray(data["v"])
    want = j.update(js, u, v, jnp.float32(gamma), 1.3)
    got = t.update(ts, _t(data["u"]), _t(data["v"]), torch.tensor(gamma), 1.3)
    name = "r" if kind == "mtls" else "z"
    _close(getattr(got, name), getattr(want, name))
    assert getattr(got, name) is getattr(ts, name)  # updated in place


def test_logistic_rejects_out_of_range_labels():
    with pytest.raises(ValueError):
        tasks.MultinomialLogistic(3, 4).init_state(torch.zeros(2, 3), torch.tensor([0, 4]))


# ---------------------------------------------------------------------------
# power method
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mtls", "logistic"])
@pytest.mark.parametrize("k", [1, 3])
def test_power_iterations_match_jax_with_injected_v0(kind, k, data):
    j, t, js, ts = _task_pair(kind, data)
    v0 = np.asarray(jpmeth.sphere_vector(jax.random.PRNGKey(7), M))
    want = jpmeth.power_iterations(
        lambda vv: j.matvec(js, vv), lambda uu: j.rmatvec(js, uu), jnp.asarray(v0), k)
    kt = dfw.kernelize(t)
    reducer = DenseReducer()
    got, _ = power_method.power_iterations(
        lambda vv: kt.matvec(ts, vv), lambda uu: kt.rmatvec(ts, uu), _t(v0), k,
        reducer=reducer)
    _close(got.u, want.u, rtol=1e-4, atol_rel=1e-5)
    _close(got.v, want.v, rtol=1e-4, atol_rel=1e-5)
    _close(got.sigma, want.sigma)
    assert reducer.exchanges == 2 * k  # sigma carried, never recomputed


def test_power_iterations_rejects_zero_iterations():
    with pytest.raises(ValueError):
        power_method.power_iterations(lambda v: v, lambda u: u, torch.ones(3), 0)


def test_v0_stream_seed_and_table():
    s = V0Stream(3)
    a, b = s(5, 40, "cpu"), V0Stream(3)(5, 40, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, s(6, 40, "cpu"))
    assert abs(float(torch.linalg.vector_norm(a)) - 1.0) < 1e-6
    table = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert torch.equal(V0Stream.from_table(table)(2, 4, "cpu"), _t(table[2]))
    with pytest.raises(IndexError):
        V0Stream.from_table(table)(3, 4, "cpu")


# ---------------------------------------------------------------------------
# schedules, segments, specs, configs, device policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["const:2", "log", "log_half", "linear:0.5"])
@pytest.mark.parametrize("block_epochs,start", [(None, 0), (3, 0), (4, 8)])
def test_schedules_and_segment_plans_match_jax(schedule, block_epochs, start):
    ts, js = frank_wolfe.k_schedule(schedule), jfw.k_schedule(schedule)
    assert [ts(t) for t in range(60)] == [js(t) for t in range(60)]
    got = engine.plan_segments(schedule, 40, block_epochs, start=start)
    want = jengine.plan_segments(schedule, 40, block_epochs, start=start)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert engine.resolve_max_rank(None, 40) == jengine.resolve_max_rank(None, 40)
    with pytest.raises(ValueError):
        engine.resolve_max_rank(10, 40)


@pytest.mark.parametrize("bad", [
    dict(solver="block:"), dict(solver="block:0"), dict(comm="topk:x"),
    dict(topology="gossip:3"), dict(topology="hier:1"), dict(solver="nope"),
])
def test_malformed_specs_fail_like_jax(bad):
    with pytest.raises(jspecs.SpecError) as want:
        jspecs.validate(**bad)
    with pytest.raises(specs.SpecError) as got:
        specs.validate(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    dict(solver="block:4"), dict(solver="block:2:adapt"), dict(solver="block:2", comm="int8"),
    dict(comm="topk:8"), dict(topology="ring"), dict(topology="hier:2"),
])
def test_valid_but_unported_specs_raise(spec):
    """Valid in the reference, and ported: top-k, ring and hier (in the
    slice that brought the graphs) and the block solvers (in the slice that
    brought the block tier; each raised NotYetPorted here before) parse as
    in the reference and their config builds."""
    want = jspecs.validate(**spec)  # valid in the reference
    assert [tuple(a) for a in specs.validate(**spec)] == [tuple(a) for a in want]
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=3, **spec)
    assert all(getattr(cfg, k) == v for k, v in spec.items())


@pytest.mark.parametrize("field,value", [
    ("gossip_rounds", 4), ("engine", "legacy"), ("resume_step", 3),
    ("use_pallas", False), ("interpret", True), ("resume_from", "ckpt"),
    ("gossip_rounds", 2), ("telemetry", object()),
])
def test_config_rejects_unported_fields(field, value):
    """Every field not yet ported raises NotYetPorted. ``gossip_rounds`` is
    ported with the gossip graph (it raised here before): the config takes
    it, as the reference's does."""
    assert field in {f.name for f in dataclasses.fields(jdfw.DFWConfig)}
    if field == "gossip_rounds":
        cfg = dfw.DFWConfig(mu=1.0, num_epochs=3, topology="ring", **{field: value})
        assert cfg.gossip_rounds == value
        assert jdfw.DFWConfig(mu=1.0, num_epochs=3, topology="ring",
                              **{field: value}).gossip_rounds == value
        return
    with pytest.raises(specs.NotYetPorted):
        dfw.DFWConfig(mu=1.0, num_epochs=3, **{field: value})


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.default_device()
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dfw.fit_serial(tasks.MultiTaskLeastSquares(3, 2), torch.zeros(4, 3),
                       torch.zeros(4, 2), cfg=cfg)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kind", ["mtls", "logistic"])
def test_row_chunked_reductions_equal_one_pass(kind, data, monkeypatch):
    """The (n, m) reductions run over row chunks (bounded temporaries at the
    full size); many chunks give the one-pass values (rtol 1e-5)."""
    _, t, _, ts = _task_pair(kind, data)
    one = [t.local_loss(ts), t.inner_w_grad(ts)]
    if kind == "mtls":
        one += list(t.linesearch_terms(ts, _t(data["u"]), _t(data["v"]), 1.3))
    monkeypatch.setattr(tasks, "_CHUNK_ELEMS", 7 * M)  # 7 rows per chunk
    many = [t.local_loss(ts), t.inner_w_grad(ts)]
    if kind == "mtls":
        many += list(t.linesearch_terms(ts, _t(data["u"]), _t(data["v"]), 1.3))
    for a, b in zip(many, one):
        _close(a, b)
