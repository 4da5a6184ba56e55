"""The port's telemetry (``repro_torch.obs``) on the CPU, test by test after
tests/test_obs.py, against the JAX package's ``repro.obs``.

Both packages get the same inputs: the same observations into the
registries and histograms, the same records into the handles, the same
numpy data and (for the fits) the reference's start vectors injected into
the port. The registry and histogram snapshots are equal; both sinks parse
alike; an instrumented MTLS fit carries at least the reference's event
names, its ``dfw.*`` samples agree at tests/test_torch_fit.py's rtol 1e-4
and ``engine.epochs`` and the ``comm.*`` counters are equal exactly; the
checkpoint store's events and counters equal the reference's; the serving
engine's histogram, events and registry-backed ``stats`` do. An enabled
handle changes no bit, no ``stats`` entry and no launch count.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch import V0Stream, kernels
from repro_torch.analysis import recorder
from repro_torch.core import engine, frank_wolfe, tasks
from repro_torch.launch import dfw
from repro_torch.obs import Histogram, MetricsRegistry, Telemetry, noop_contract

torch.set_num_threads(2)

N, D, M = 400, 24, 18
RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here rather than at module level: the
    worker processes of ``four_workers`` import this module and need none
    of it."""
    import jax
    import jax.numpy as jnp

    from repro import serve
    from repro.checkpoint.store import CheckpointStore
    from repro.core import frank_wolfe, low_rank, tasks
    from repro.core.power_method import sphere_vector
    from repro.obs import Histogram, MetricsRegistry, Telemetry

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, serve=serve, CheckpointStore=CheckpointStore, fw=frank_wolfe,
        low_rank=low_rank, tasks=tasks, sphere_vector=sphere_vector, Histogram=Histogram,
        MetricsRegistry=MetricsRegistry, Telemetry=Telemetry, KEY=jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((D, M))
    w = w / np.linalg.norm(w, ord="nuc")
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _v0(jx, epochs):
    """The reference's start vectors: sphere_vector(fold_in(KEY, t), m)."""
    return V0Stream.from_table(np.stack([
        np.asarray(jx.sphere_vector(jx.jax.random.fold_in(jx.KEY, t), M))
        for t in range(epochs)]))


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------


def _feed(reg):
    c, g, h = reg.counter("a"), reg.gauge("g"), reg.histogram("h")
    c.inc(3)
    c.inc()
    g.set(1.5)
    g.set(-2)
    for v in (0.0, 0.5, 1.0, 3.0, 1000.0, 2.0 ** 30):
        h.observe(v)
    reg.counter("b")
    return c, g, h


def test_registry_get_or_create_returns_same_instrument(jx):
    reg = MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    assert reg.gauge("g") is reg.gauge("g")
    assert reg.histogram("h") is reg.histogram("h")
    _feed(reg)
    ref = jx.MetricsRegistry()
    _feed(ref)
    assert reg.snapshot() == ref.snapshot()
    assert reg.snapshot()["counters"]["a"] == 4.0


def test_registry_reset_zeroes_in_place_keeping_handles(jx):
    reg, ref = MetricsRegistry(), jx.MetricsRegistry()
    for r in (reg, ref):
        c, g, h = _feed(r)
        r.reset()
        assert c.value == 0.0 and g.value is None and h.count == 0
        c.inc()  # the old handle still feeds the registry
    assert reg.snapshot() == ref.snapshot()
    assert reg.snapshot()["counters"]["a"] == 1.0


@pytest.mark.parametrize("values", [(0.5, 1.0, 3.0, 1000.0), "random"])
def test_histogram_log2_buckets_and_summary(jx, values):
    if values == "random":
        values = np.random.default_rng(0).lognormal(3.0, 4.0, 500).tolist()
    h, ref = Histogram("lat"), jx.Histogram("lat")
    for v in values:
        h.observe(v)
        ref.observe(v)
    assert h.snapshot() == ref.snapshot()
    assert h.snapshot()["count"] == len(values)
    if len(values) == 4:
        assert h.snapshot()["buckets"] == {"0": 1, "1": 1, "2": 1, "10": 1}


# ---------------------------------------------------------------------------
# The handle: events, bounds, no-op
# ---------------------------------------------------------------------------


def _strip(ev):
    """An event without its clock and thread (which differ by run)."""
    return {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid", "tid")}


def test_span_and_event_forms(jx):
    got = []
    for tel in (Telemetry(), jx.Telemetry()):
        with tel.span("work", "test", detail=7):
            pass
        tel.event("marker", "test", note="x")
        tel.counter_sample("metric", 3.0)
        tel.complete("done", "test", 5.0, -1.0, n=2)
        evs = tel.events()
        assert [ev["ph"] for ev in evs] == ["X", "i", "C", "X"]
        assert evs[0]["dur"] >= 0.0 and evs[3]["dur"] == 0.0
        got.append([_strip(ev) for ev in evs])
    assert got[0] == got[1]


def test_event_stream_is_bounded_and_counts_drops(jx):
    for tel in (Telemetry(max_events=3), jx.Telemetry(max_events=3)):
        for i in range(5):
            tel.event(f"e{i}")
        assert tel.event_count() == 3
        assert tel._meta()["dropped_events"] == 2
    assert set(Telemetry()._meta()) == set(jx.Telemetry()._meta())


def test_noop_is_a_singleton_and_records_nothing():
    tel = Telemetry.noop()
    assert tel is Telemetry.noop()
    assert not tel.enabled and not tel.wants_hlo
    with tel.span("x"):
        pass
    tel.event("y")
    tel.complete("z", "c", 0.0, 1.0)
    tel.counter_sample("w", 1.0)
    with tel.profiler():
        pass
    assert tel.event_count() == 0
    noop_contract().check_telemetry(tel)


def test_noop_contract_rejects_an_enabled_handle():
    with pytest.raises(AssertionError, match="max_events"):
        noop_contract().check_telemetry(Telemetry())


def test_noop_contract_names_every_failed_clause(monkeypatch):
    """A clock that steps 1 s a read (the probe reads it before and after its
    2000 spans: 500 us a span) fails the timing clause on purpose; the
    violation still names the event clause an enabled handle breaks (one
    violation naming both), whatever the machine's load, and a disabled
    handle fails the timing clause alone."""
    from repro_torch.analysis import contracts

    ticks = iter(range(10**9))
    monkeypatch.setattr(contracts, "time",
                        types.SimpleNamespace(perf_counter=lambda: float(next(ticks))))
    with pytest.raises(contracts.ContractViolation) as err:
        noop_contract().check_telemetry(Telemetry())
    assert "max_noop_span_us" in str(err.value) and "max_events" in str(err.value)
    with pytest.raises(contracts.ContractViolation) as err:
        noop_contract().check_telemetry(Telemetry.noop())
    assert "max_noop_span_us" in str(err.value) and "max_events" not in str(err.value)


# ---------------------------------------------------------------------------
# Sinks from an instrumented fit
# ---------------------------------------------------------------------------


def _jax_fit(jx, tel, data, num_epochs=12, gap_tol=None, block_epochs=None):
    x, y = data
    task = jx.tasks.MultiTaskLeastSquares(d=D, m=M)
    return jx.fw.fit(task, task.init_state(jx.jnp.asarray(x), jx.jnp.asarray(y)), mu=1.0,
                     num_epochs=num_epochs, key=jx.KEY, step_size="linesearch", gap_tol=gap_tol,
                     block_epochs=block_epochs, telemetry=tel)


def _port_fit(jx, tel, data, num_epochs=12, **kw):
    x, y = data
    task = tasks.MultiTaskLeastSquares(D, M)
    return frank_wolfe.fit(task, task.init_state(torch.from_numpy(x), torch.from_numpy(y)),
                           mu=1.0, num_epochs=num_epochs, key=_v0(jx, num_epochs),
                           step_size="linesearch", device="cpu", telemetry=tel, **kw)


def _samples(tel):
    return [(ev["name"], ev["args"]["value"]) for ev in tel.events()
            if ev["ph"] == "C" and ev["name"].startswith("dfw.")]


@pytest.fixture(scope="module")
def fits(jx, data):
    jtel, ttel = jx.Telemetry(), Telemetry()
    return jtel, _jax_fit(jx, jtel, data), ttel, _port_fit(jx, ttel, data)


def test_fit_emits_engine_and_comm_events_and_metrics(fits):
    jtel, jres, tel, res = fits
    names = {ev["name"] for ev in tel.events()}
    assert {ev["name"] for ev in jtel.events()} <= names
    assert {"engine.compile", "engine.dispatch", "engine.segment", "engine.fetch",
            "comm.exchange", "comm.executable", "engine.final_loss"} <= names
    loss_samples = [ev for ev in tel.events() if ev["name"] == "dfw.loss"]
    assert len(loss_samples) == res.epochs_run == jres.epochs_run == 12
    got, want = _samples(tel), _samples(jtel)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=RTOL, atol=1e-6)
    snap, jsnap = tel.registry.snapshot(), jtel.registry.snapshot()
    for name in ("engine.epochs", "comm.rounds", "comm.logical_bytes", "comm.wire_bytes"):
        assert snap["counters"][name] == jsnap["counters"][name], name
    assert snap["counters"]["engine.epochs"] == 12
    assert set(snap["gauges"]) == set(jsnap["gauges"])
    assert snap["gauges"]["dfw.final_loss"] == res.final_loss
    np.testing.assert_allclose(snap["gauges"]["dfw.final_loss"],
                               jsnap["gauges"]["dfw.final_loss"], rtol=RTOL)
    # the reference's comm.exchange args, the same keys and values
    ex = [_strip(ev) for ev in tel.events() if ev["name"] == "comm.exchange"]
    jex = [_strip(ev) for ev in jtel.events() if ev["name"] == "comm.exchange"]
    assert ex == jex


def test_jsonl_and_chrome_trace_sinks_are_valid(fits, tmp_path):
    jtel, _, tel, _ = fits
    parsed = []
    for label, handle in (("port", tel), ("ref", jtel)):
        jl, ct = tmp_path / f"{label}.jsonl", tmp_path / f"{label}.trace.json"
        handle.write_jsonl(jl)
        handle.write_chrome_trace(ct)
        lines = [json.loads(s) for s in jl.read_text().splitlines()]
        assert lines[0]["type"] == "meta" and lines[-1]["type"] == "metrics"
        assert len(lines) - 2 == handle.event_count()
        doc = json.loads(ct.read_text())
        evs = doc["traceEvents"]
        assert len(evs) == handle.event_count()
        assert {ev["ph"] for ev in evs} <= {"X", "i", "C"}
        for ev in evs:  # Perfetto's minimum: name/ph/ts/pid on every event
            assert {"name", "ph", "ts", "pid"} <= set(ev)
            if ev["ph"] == "X":
                assert ev["dur"] >= 0.0
        parsed.append((set(lines[0]), set(lines[-1]["data"]), set(doc), set(doc["otherData"])))
    assert parsed[0] == parsed[1]


# ---------------------------------------------------------------------------
# Early stop: event epoch == epochs_run == truncated history
# ---------------------------------------------------------------------------


def test_early_stop_event_matches_truncated_history_serial(jx, data):
    full = _jax_fit(jx, jx.Telemetry.noop(), data, num_epochs=40)
    tol = float(full.history["gap"][0]) * 0.4
    jtel, tel = jx.Telemetry(), Telemetry()
    jres = _jax_fit(jx, jtel, data, num_epochs=40, gap_tol=tol, block_epochs=5)
    res = _port_fit(jx, tel, data, num_epochs=40, gap_tol=tol, block_epochs=5)
    assert res.epochs_run == jres.epochs_run < 40
    stops = [ev for ev in tel.events() if ev["name"] == "engine.early_stop"]
    assert len(stops) == 1
    assert stops[0]["args"]["epoch"] == res.epochs_run
    assert stops[0]["args"]["gap"] == res.history["gap"][-1]
    assert len(res.history["loss"]) == res.epochs_run
    loss_samples = [ev for ev in tel.events() if ev["name"] == "dfw.loss"]
    assert len(loss_samples) == res.epochs_run
    assert tel.registry.snapshot()["counters"]["comm.rounds"] == \
        jtel.registry.snapshot()["counters"]["comm.rounds"]


def _early_stop_worker(group, device, x, y):
    """One of four gloo workers: in each mode a full run, then one stopped
    by gap_tol, each run with the worker's own handle (module level:
    run_workers starts it)."""
    task = tasks.MultiTaskLeastSquares(40, 30)
    out = {}
    for mode in ("scan", "legacy"):
        kw = dict(mu=1.0, num_epochs=40, schedule="const:2", step_size="linesearch", engine=mode)
        full = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=1, group=group, device=device)
        tol = float(full.history["gap"][0]) * 0.4
        tel = Telemetry()
        res = dfw.fit(task, x, y, key=1, group=group, device=device,
                      cfg=dfw.DFWConfig(gap_tol=tol, block_epochs=5, telemetry=tel, **kw))
        out[mode] = dict(
            epochs_run=res.epochs_run, history_len=len(res.history["loss"]),
            names=[ev["name"] for ev in tel.events()],
            stops=[ev["args"] for ev in tel.events() if ev["name"] == "engine.early_stop"],
            starts=[ev["args"] for ev in tel.events() if ev["name"] == "run.start"])
    return out


@pytest.fixture(scope="module")
def four_workers():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 30))
    w = w / np.linalg.norm(w, ord="nuc")
    x = rng.standard_normal((1600, 40)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    return dfw.run_workers(4, _early_stop_worker, x, y, device="cpu")


@pytest.mark.parametrize("mode", ["scan", "legacy"])
def test_early_stop_event_matches_truncated_history_4way(four_workers, mode):
    out = [worker[mode] for worker in four_workers]
    for rank, got in enumerate(out):
        assert got["epochs_run"] < 40
        assert got["epochs_run"] == out[0]["epochs_run"]
        assert len(got["stops"]) == 1, got["names"]
        assert got["stops"][0]["epoch"] == got["epochs_run"] == got["history_len"]
        assert got["names"].count("dfw.loss") == got["epochs_run"]
        assert got["starts"][0]["driver"] == "launch.dfw.fit"
        assert (got["starts"][0]["rank"], got["starts"][0]["num_workers"]) == (rank, 4)


# ---------------------------------------------------------------------------
# Checkpoint and serving instrumentation
# ---------------------------------------------------------------------------


def test_checkpoint_store_stamps_writes_and_prunes(jx, tmp_path):
    from repro_torch.checkpoint.store import CheckpointStore

    seen = []
    for label, make, tree in (
            ("port", CheckpointStore, {"w": torch.ones((8, 8))}),
            ("ref", jx.CheckpointStore, {"w": np.ones((8, 8), np.float32)})):
        tel = (Telemetry if label == "port" else jx.Telemetry)()
        store = make(tmp_path / label, keep_last=1, telemetry=tel)
        store.save(0, tree)
        store.save_async(1, tree)
        store.wait()
        store.restore()
        writes = [ev for ev in tel.events() if ev["name"] == "checkpoint.write"]
        assert [w["args"]["step"] for w in writes] == [0, 1]
        assert all(w["args"]["bytes"] == 8 * 8 * 4 for w in writes)
        prunes = [ev for ev in tel.events() if ev["name"] == "checkpoint.prune"]
        assert len(prunes) == 1 and prunes[0]["args"]["steps"] == [0]
        snap = tel.registry.snapshot()
        assert snap["counters"]["checkpoint.saves"] == 2
        assert snap["histograms"]["checkpoint.write_us"]["count"] == 2
        seen.append(([_strip(ev) for ev in tel.events()], snap["counters"]))
    assert seen[0] == seen[1]


def _iterates(rank=4, d=32, m=24):
    g = np.random.default_rng(0)
    u, v = g.standard_normal((rank, d)), g.standard_normal((rank, m))
    return u.astype(np.float32), np.ones(rank, np.float32), v.astype(np.float32)


def test_serving_latency_histogram_and_hot_swap_event(jx):
    from repro_torch import serve
    from repro_torch.core import low_rank

    d, m = 32, 24
    u, s, v = _iterates()
    out = []
    for port in (True, False):
        tel = (Telemetry if port else jx.Telemetry)()
        if port:
            eng = serve.ServingEngine(d, m, serve.ServeConfig(
                max_batch=8, rank_block=4, verify_kernels=False, telemetry=tel), device="cpu")
            it = low_rank.FactoredIterate(u=torch.from_numpy(u), s=torch.from_numpy(s),
                                          v=torch.from_numpy(v), alpha=torch.tensor(1.0),
                                          count=torch.tensor(4, dtype=torch.int32))
            swap = it._replace(s=it.s * 0.5)
        else:
            jnp = jx.jnp
            eng = jx.serve.ServingEngine(d, m, jx.serve.ServeConfig(
                max_batch=8, rank_block=4, verify_kernels=False, telemetry=tel))
            it = jx.low_rank.FactoredIterate(
                u=jnp.asarray(u), s=jnp.asarray(s), v=jnp.asarray(v), alpha=jnp.asarray(1.0),
                count=jnp.asarray(4, jnp.int32))
            swap = it._replace(s=it.s * 0.5)
        eng.load(it)
        scores = [eng.score(np.ones((8, d), np.float32)) for _ in range(3)]
        eng.load(swap)  # hot swap
        hist = tel.registry.snapshot()["histograms"]["serve.latency_us"]
        assert hist["count"] == 3
        names = [ev["name"] for ev in tel.events()]
        assert names.count("serve.dispatch") == 3
        assert "serve.compile" in names and "serve.hot_swap" in names
        assert eng.stats["dispatches"] == 3 and eng.stats["loads"] == 2
        assert tel.registry.snapshot()["counters"]["serve.dispatches"] == 3
        assert {k: int(v) for k, v in tel.registry.snapshot()["counters"].items()} == {
            f"serve.{k}": v for k, v in eng.stats.items()}
        out.append((eng.stats, [n for n in names if n != "serve.executable"],
                    [_strip(ev) for ev in tel.events() if ev["name"] in (
                        "serve.hot_swap", "serve.dispatch")], scores))
    assert out[0][:3] == out[1][:3]
    np.testing.assert_allclose(np.array(out[0][3]), np.array(out[1][3]), rtol=1e-5, atol=1e-5)


def test_disabled_engines_do_not_share_counters():
    from repro_torch import serve

    a = serve.ServingEngine(16, 12, serve.ServeConfig(max_batch=4, verify_kernels=False),
                            device="cpu")
    b = serve.ServingEngine(16, 12, serve.ServeConfig(max_batch=4, verify_kernels=False),
                            device="cpu")
    a._counters["dispatches"].inc()
    assert b.stats["dispatches"] == 0 and a.stats["dispatches"] == 1
    assert Telemetry.noop().registry.snapshot()["counters"] == {}


# ---------------------------------------------------------------------------
# An enabled handle changes nothing of the run
# ---------------------------------------------------------------------------


def test_serial_const2_pin_holds_with_telemetry_enabled(jx, data):
    """The counterpart of tests/test_engine.py's pin: a live handle keeps the
    same stats under the dispatch contract, the same bits and launch
    counts, and the run reads nothing from the device outside its two
    counted fetches (the op recorder's count: on the CPU one of them, the
    final loss's ``float()``, reads; the rows are host memory already)."""
    base = _port_fit(jx, None, data, num_epochs=30)
    tel = Telemetry()
    contract = engine.dispatch_contract()
    kernels.reset_launches()
    with recorder.OpRecorder() as rec, contract.guard():
        res = _port_fit(jx, tel, data, num_epochs=30)
    assert res.epochs_run == 30
    contract.check_stats(res.stats)
    seen = contract.check_ops(rec)
    assert seen["implicit_syncs"] == 0 and seen["explicit_syncs"] == 1
    assert res.stats["host_syncs"] == 2
    assert res.stats == base.stats
    assert res.history == base.history and res.final_loss == base.final_loss
    for p, q in zip(res.iterate, base.iterate):
        assert torch.equal(p, q)
    names = {ev["name"] for ev in tel.events()}
    assert {"engine.segment", "engine.dispatch", "comm.exchange"} <= names


RUNS = {
    "mtls-log-ckpt": ("mtls", dict(mu=1.0, num_epochs=10, schedule="log",
                                   step_size="linesearch")),
    "mtls-legacy": ("mtls", dict(mu=1.0, num_epochs=6, engine="legacy")),
    "logistic-int8": ("logistic", dict(mu=10.0, num_epochs=8, schedule="log_half", comm="int8")),
    "mc-block-adapt": ("mc", dict(mu=2.0, num_epochs=6, schedule="const:3",
                                  solver="block:4:adapt", step_size="linesearch")),
    "mtls-hier-topk": ("mtls", dict(mu=1.0, num_epochs=6, topology="hier:2", comm="topk:6")),
}


def _problem(kind, data):
    x, y = data
    if kind == "mc":
        rng = np.random.default_rng(1)
        rows, cols = rng.integers(0, 60, 900), rng.integers(0, 50, 900)
        vals = rng.standard_normal(900).astype(np.float32)
        idx, yw = tasks.pack_observations(rows, cols, vals)
        return tasks.MatrixCompletion(60, 50), idx, yw
    if kind == "logistic":
        return tasks.MultinomialLogistic(D, M), x, np.argmax(x @ x[:M].T, 1).astype(np.int32)
    return tasks.MultiTaskLeastSquares(D, M), x, y


@pytest.mark.parametrize("case", list(RUNS))
def test_fit_serial_with_telemetry_gives_the_same_run(data, case, tmp_path):
    """fit_serial with and without a handle (and its checkpoints): the same
    history, final loss, iterate, stats and launches; the handle holds
    run.start, the checkpoint store's writes and checkpoint.join, one
    engine.epochs a history row, and the profiler bracket writes a trace."""
    kind, kw = RUNS[case]
    task, x, y = _problem(kind, data)
    runs, tels = [], []
    for on in (False, True):
        tel = Telemetry(profiler_dir=str(tmp_path / "prof")) if on else None
        cfg = dfw.DFWConfig(checkpoint_dir=str(tmp_path / f"ck{on}"), telemetry=tel, **kw)
        kernels.reset_launches()
        res = dfw.fit_serial(task, x, y, cfg=cfg, key=5, device="cpu")
        runs.append((res, kernels.launches()))
        tels.append(tel)
    (a, la), (b, lb) = runs
    assert a.history == b.history and a.final_loss == b.final_loss
    assert a.stats == b.stats and la == lb
    for p, q in zip(a.iterate, b.iterate):
        assert torch.equal(p, q)
    tel = tels[1]
    names = [ev["name"] for ev in tel.events()]
    for name in ("run.start", "checkpoint.snapshot", "checkpoint.write", "checkpoint.join",
                 "engine.final_loss", "engine.segment", "comm.exchange"):
        assert name in names, name
    snap = tel.registry.snapshot()
    assert snap["counters"]["engine.epochs"] == b.epochs_run
    assert snap["counters"]["checkpoint.saves"] == names.count("checkpoint.write") >= 1
    assert names.count("dfw.loss") == b.epochs_run
    starts = [ev["args"] for ev in tel.events() if ev["name"] == "run.start"]
    assert starts[0]["driver"] == "launch.dfw.fit_serial" and starts[0]["task"] == type(
        task).__name__
    if "block" in kw.get("solver", ""):
        assert snap["gauges"]["dfw.block.k"] == 4
        # the iterations that ran (fewer than K under :adapt), as the stats count them
        assert snap["counters"]["dfw.block.power_iters"] == b.stats["comm_rounds"] // 2
    if kw.get("topology", "flat") != "flat":
        assert "comm.topology" in names
        assert any(k.startswith("comm.hop_bytes.") for k in snap["counters"])
    (trace,) = tel.profiler_traces
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


def test_dfwconfig_takes_a_handle_and_it_is_not_pickled():
    tel = Telemetry()
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=2, telemetry=tel)
    assert cfg.telemetry is tel
    assert dataclasses.replace(cfg, telemetry=None).telemetry is None
