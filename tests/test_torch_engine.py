"""The port's epoch engine (``repro_torch.core.engine``) on the CPU, case by
case after tests/test_engine.py.

``mode="scan"`` runs one segment program a (K, length) signature (on the
card a CUDA graph replay; here the same program uncaptured) and
``mode="legacy"`` one epoch a segment with four blocking pulls each. They
run the same epochs, so they must agree bit for bit (``torch.equal``) on
the history, the final loss, the iterate, the state, the reducer state and
the probe, serial and on two gloo workers. Against the JAX package's
``run_epochs`` (through its ``fit_serial``, ``engine=mode``) with its start
vectors and int8 noise injected, both modes agree within
tests/test_torch_fit.py's parity tolerances: rtol 1e-4 on the histories and
the final loss, 1e-4 of max|W| on the iterate (the power method amplifies
f32 sums in another order over the epochs). The dispatch and host-sync
counts are pinned with ``engine.dispatch_contract``, as in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import low_rank as jlr
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.launch import dfw as jdfw
from repro_torch import NoiseStream, V0Stream
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import engine, low_rank, power_method, tasks
from repro_torch.launch import dfw

torch.set_num_threads(2)

N, D, M = 256, 40, 30
MD, MM, P = 60, 50, 800
KEY = jax.random.PRNGKey(1)
RTOL = 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((D, 4)))[0]
    v = np.linalg.qr(rng.standard_normal((M, 4)))[0]
    w = (u * np.array([0.4, 0.3, 0.2, 0.1])) @ v.T
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    labels = np.argmax(x @ rng.standard_normal((D, M)), axis=1).astype(np.int32)
    um, vm = rng.standard_normal((MD, 3)), rng.standard_normal((MM, 3))
    rows, cols = rng.integers(0, MD, P), rng.integers(0, MM, P)
    vals = ((um @ vm.T)[rows, cols] / 3).astype(np.float32)
    return dict(x=x, y=y, labels=labels, rows=rows.astype(np.int32),
                cols=cols.astype(np.int32), vals=vals)


def _problem(kind, data):
    """(port task, x, y, mu) of one task on the module's data."""
    if kind == "mc":
        idx, yw = tasks.pack_observations(data["rows"], data["cols"], data["vals"])
        return tasks.MatrixCompletion(MD, MM), idx, yw, 2.0
    if kind == "logistic":
        return tasks.MultinomialLogistic(D, M), data["x"], data["labels"], 10.0
    return tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"], 1.0


def _fit(kind, data, mode="scan", callback=None, **kw):
    task, x, y, mu = _problem(kind, data)
    return dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(mu=mu, engine=mode, **kw), key=3,
                          device="cpu", callback=callback)


def _assert_same_bits(a, b):
    assert a.epochs_run == b.epochs_run
    assert a.history == b.history
    assert a.final_loss == b.final_loss
    for p, q in zip(a.iterate, b.iterate):
        assert torch.equal(p, q)
    for p, q in zip(engine._leaves(a.state), engine._leaves(b.state)):
        assert torch.equal(p, q)
    for p, q in zip(engine._leaves(a.comm_state), engine._leaves(b.comm_state)):
        assert torch.equal(p, q)
    if isinstance(a.probe, torch.Tensor):
        assert torch.equal(a.probe, b.probe)


# ---------------------------------------------------------------------------
# scan against legacy, bit for bit
# ---------------------------------------------------------------------------

SCAN_CASES = {
    "mtls-const2": ("mtls", dict(num_epochs=12, schedule="const:2", step_size="linesearch")),
    "mtls-log": ("mtls", dict(num_epochs=12, schedule="log", step_size="linesearch")),
    "logistic-int8": ("logistic", dict(num_epochs=10, schedule="log", comm="int8")),
    "mc-dense": ("mc", dict(num_epochs=10, schedule="log", step_size="linesearch")),
    "mc-int8": ("mc", dict(num_epochs=10, schedule="const:2", step_size="linesearch",
                           comm="int8")),
    "mtls-topk4": ("mtls", dict(num_epochs=10, schedule="const:2", comm="topk:4")),
    "mtls-block4": ("mtls", dict(num_epochs=8, schedule="const:3", solver="block:4",
                                 step_size="linesearch")),
    "mtls-block4-adapt": ("mtls", dict(num_epochs=10, schedule="const:5",
                                       solver="block:4:adapt", step_size="linesearch")),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_equals_legacy_bit_for_bit(data, case):
    kind, kw = SCAN_CASES[case]
    blocks = {"scan": [], "legacy": []}
    runs = {mode: _fit(kind, data, mode, callback=lambda s, aux, mode=mode: blocks[mode].append(
        np.asarray(aux.piters)), **kw) for mode in blocks}
    sc, lg = runs["scan"], runs["legacy"]
    _assert_same_bits(sc, lg)
    assert sc.epochs_run == kw["num_epochs"]
    # the executed power iterations, the :adapt stop's record
    np.testing.assert_array_equal(np.concatenate(blocks["scan"]),
                                  np.concatenate(blocks["legacy"]))
    if case == "mtls-block4-adapt":
        assert np.concatenate(blocks["scan"]).min() < 5, "the adaptive stop never fired"
    if kind == "mtls" and "topk" in kw.get("comm", ""):
        assert float(torch.sum(torch.abs(sc.comm_state["u"]))) > 0  # residuals carried
    assert sc.stats["dispatches"] == sc.stats["segments_run"] + 1
    assert lg.stats["dispatches"] == kw["num_epochs"] + 1


# ---------------------------------------------------------------------------
# Gap-certificate early stopping
# ---------------------------------------------------------------------------


def _tol(data, num_epochs=40):
    full = _fit("mtls", data, num_epochs=num_epochs, step_size="linesearch")
    return full, float(full.history["gap"][0]) * 0.4


def test_early_stop_truncates_consistently(data):
    full, tol = _tol(data)
    sc = _fit("mtls", data, num_epochs=40, step_size="linesearch", gap_tol=tol)
    lg = _fit("mtls", data, "legacy", num_epochs=40, step_size="linesearch", gap_tol=tol)
    assert 0 < sc.epochs_run < 40
    _assert_same_bits(sc, lg)
    for key in ("loss", "gap", "sigma", "gamma", "k"):
        assert len(sc.history[key]) == sc.epochs_run, key
        assert np.all(np.isfinite(np.asarray(sc.history[key], np.float64))), key
    assert sc.history["gap"][-1] <= tol
    assert all(g > tol for g in sc.history["gap"][:-1])
    # the epochs before the stop are the unstopped run's, bit for bit
    assert sc.history["loss"] == full.history["loss"][:sc.epochs_run]
    assert int(sc.iterate.count) == sc.epochs_run


def test_early_stop_block_epochs_bounds_overshoot(data):
    """With blocks of 5 the run stops at the boundary after the certificate:
    the epochs behind it in its segment are NaN rows, cut from the history."""
    _, tol = _tol(data)
    blocks = []
    res = _fit("mtls", data, num_epochs=40, step_size="linesearch", gap_tol=tol,
               block_epochs=5, callback=lambda s, aux: blocks.append((s, np.asarray(aux.gap))))
    assert res.epochs_run < 40
    assert res.stats["segments_run"] == -(-res.epochs_run // 5) == len(blocks)
    tail = blocks[-1][1]
    live = res.epochs_run - blocks[-1][0]
    assert np.all(np.isfinite(tail[:live])) and np.all(np.isnan(tail[live:]))
    assert len(res.history["gap"]) == res.epochs_run


PIECE_CASES = {
    "mtls-const2": ("mtls", dict(num_epochs=11, schedule="const:2", step_size="linesearch")),
    "mc-int8": ("mc", dict(num_epochs=8, schedule="const:2", step_size="linesearch",
                           comm="int8")),
    "mtls-block4-adapt": ("mtls", dict(num_epochs=8, schedule="const:5",
                                       solver="block:4:adapt", step_size="linesearch")),
}


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_long_segment_runs_in_bounded_pieces(data, case, monkeypatch):
    """A segment longer than MAX_PROGRAM_EPOCHS (here 3) runs as pieces of
    that many epochs: legacy's bits, one dispatch for the segment, two
    programs (a whole piece and the rest) whose tables hold a piece."""
    kind, kw = PIECE_CASES[case]
    lg = _fit(kind, data, "legacy", **kw)
    whole = _fit(kind, data, **kw)
    monkeypatch.setattr(engine, "MAX_PROGRAM_EPOCHS", 3)
    sc = _fit(kind, data, **kw)
    _assert_same_bits(sc, lg)
    _assert_same_bits(sc, whole)
    assert (sc.stats["segments_run"], sc.stats["dispatches"], sc.stats["compilations"]) == (1, 2, 2)
    assert len(sc.timings["draw_us"]) == -(-kw["num_epochs"] // 3)  # one fill a piece
    assert whole.stats["compilations"] == 1
    piece_bytes = max(sc.timings["table_bytes"])
    assert piece_bytes * (kw["num_epochs"] // 3) <= whole.timings["table_bytes"][0]


@pytest.mark.parametrize("piece", [1, 3])
def test_gap_tol_stops_inside_a_later_piece(data, monkeypatch, piece):
    """A later piece's first epoch runs under the flag too: the certificate
    fired in an earlier piece stops the run at legacy's epoch, with no host
    read between the pieces."""
    _, tol = _tol(data)
    lg = _fit("mtls", data, "legacy", num_epochs=40, step_size="linesearch", gap_tol=tol)
    monkeypatch.setattr(engine, "MAX_PROGRAM_EPOCHS", piece)
    sc = _fit("mtls", data, num_epochs=40, step_size="linesearch", gap_tol=tol)
    assert piece < sc.epochs_run < 40
    _assert_same_bits(sc, lg)
    # one segment: the flag at its end, the final fetch and the final loss
    assert (sc.stats["segments_run"], sc.stats["host_syncs"]) == (1, 3)
    # the first piece, the later whole pieces (gated) and the rest (gated)
    assert sc.stats["compilations"] == (2 if 40 % piece == 0 else 3)


def test_gap_tol_none_runs_everything(data):
    res = _fit("mtls", data, num_epochs=12)
    assert res.epochs_run == 12 and len(res.history["loss"]) == 12
    assert int(res.iterate.count) == 12


# ---------------------------------------------------------------------------
# The dispatch contract on the CPU
# ---------------------------------------------------------------------------


def test_const2_is_two_dispatches_o1_syncs(data):
    """30 const:2 epochs: one segment (two programs: pieces of
    MAX_PROGRAM_EPOCHS = 16 and 14 epochs) and the final loss, the declared
    bounds of ``engine.dispatch_contract()``; legacy pays an epoch's
    dispatch and four pulls an epoch."""
    assert engine.MAX_PROGRAM_EPOCHS == 16
    res = _fit("mtls", data, num_epochs=30, step_size="linesearch")
    assert res.epochs_run == 30
    engine.dispatch_contract().check_stats(res.stats)
    st = res.stats
    assert (st["dispatches"], st["compilations"], st["host_syncs"]) == (2, 2, 2)
    legacy = _fit("mtls", data, "legacy", num_epochs=30, step_size="linesearch")
    assert legacy.stats["dispatches"] == 31
    assert legacy.stats["host_syncs"] >= 4 * 30
    with pytest.raises(AssertionError, match="dispatches"):
        engine.dispatch_contract().check_stats(legacy.stats)


def test_log_schedule_is_segments_plus_one_dispatches(data):
    n_segments = len(engine.plan_segments("log", 30))
    contract = engine.dispatch_contract(segments=n_segments, max_compilations=None)
    res = _fit("mtls", data, num_epochs=30, schedule="log", step_size="linesearch")
    contract.check_stats(res.stats)
    assert res.stats["dispatches"] == n_segments + 1  # the cap is tight
    assert res.stats["graph_replays"] == 0  # no graph off the card


def test_callback_fires_per_segment_with_host_blocks(data):
    calls = []
    res = _fit("mtls", data, num_epochs=20, step_size="linesearch", block_epochs=8,
               callback=lambda start, aux: calls.append((start, np.asarray(aux.loss))))
    assert [(s, len(b)) for s, b in calls] == [(0, 8), (8, 8), (16, 4)]
    np.testing.assert_array_equal(np.concatenate([b for _, b in calls]),
                                  np.asarray(res.history["loss"], np.float32))
    # a fetch a boundary, then the final fetch and the final loss
    assert res.stats["host_syncs"] == 3 + 2
    assert res.stats["compilations"] == 2  # lengths 8 and 4


@pytest.mark.parametrize("every", [1, 2])
def test_checkpointed_run_pays_one_sync_per_wanted_boundary(data, tmp_path, every):
    base = dict(num_epochs=12, step_size="linesearch", block_epochs=4)
    plain = _fit("mtls", data, **base)
    ck = _fit("mtls", data, checkpoint_dir=str(tmp_path), checkpoint_every=every,
              checkpoint_keep=None, **base)
    saved = CheckpointStore(tmp_path).steps()
    assert saved == ([4, 8, 12] if every == 1 else [8, 12])
    assert ck.stats["host_syncs"] == plain.stats["host_syncs"] + len(saved)
    assert ck.history == plain.history


@pytest.mark.parametrize("mode", ["scan", "legacy"])
def test_resume_gives_the_uninterrupted_bits(data, tmp_path, mode):
    """A run resumed from its step 4 in either mode gives the uninterrupted
    run's bits (the uninterrupted run in scan: the modes agree)."""
    base = dict(num_epochs=10, schedule="const:2", step_size="linesearch", block_epochs=4,
                comm="topk:4")
    full = _fit("mtls", data, checkpoint_dir=str(tmp_path), checkpoint_keep=None, **base)
    resumed = _fit("mtls", data, mode, resume_from=str(tmp_path), resume_step=4, **base)
    assert resumed.stats["segments_run"] == (2 if mode == "scan" else 6)
    _assert_same_bits(resumed, full)


def test_dfwconfig_takes_the_engine_field():
    assert dfw.DFWConfig(mu=1.0, num_epochs=2, engine="legacy").engine == "legacy"
    assert "engine" not in dfw._UNPORTED
    assert "telemetry" not in dfw._UNPORTED
    assert set(dfw._UNPORTED) == {"use_pallas", "interpret"}
    with pytest.raises(ValueError, match="engine"):
        dfw.DFWConfig(mu=1.0, num_epochs=2, engine="bogus")
    with pytest.raises(ValueError, match="mode"):
        engine.run_epochs(None, None, mu=1.0, num_epochs=2, key=0, device="cpu", mode="bogus")


# ---------------------------------------------------------------------------
# The when seam and the segment draws
# ---------------------------------------------------------------------------


def test_host_when_skips_a_false_body_and_leaves_its_outputs():
    out = torch.full((3,), 7.0)
    calls = []

    def body():
        calls.append(1)
        out.zero_()

    power_method.host_when(torch.tensor(False), body)
    assert calls == [] and torch.equal(out, torch.full((3,), 7.0))
    power_method.host_when(torch.tensor(True), body)
    assert calls == [1] and torch.equal(out, torch.zeros(3))


def test_adaptive_iterations_run_under_the_seam():
    """K - 1 iterations of an :adapt block iteration go through ``when``; a
    seam that never runs its body leaves the first iteration's result."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((20, 12)).astype(np.float32))
    v0 = torch.from_numpy(rng.standard_normal((12, 3)).astype(np.float32))
    preds = []
    kw = dict(adapt_rtol=1e-12, adapt_ref=torch.tensor(1.0))
    res, _ = power_method.block_power_iterations(
        lambda v: a @ v, lambda u: a.T @ u, v0, 6,
        when=lambda pred, body: preds.append(bool(pred)), **kw)
    one, _ = power_method.block_power_iterations(lambda v: a @ v, lambda u: a.T @ u, v0, 1, **kw)
    assert preds == [True] * 5 and float(res.iters) == 1.0
    for p, q in zip(res[:4], one[:4]):
        assert torch.equal(p, q)


@pytest.mark.parametrize("tabled", [False, True])
def test_segment_draws_are_the_per_epoch_draws(tabled):
    rng = np.random.default_rng(2)
    if tabled:
        key = V0Stream.from_table(rng.standard_normal((9, 7)).astype(np.float32))
        bkey = V0Stream.from_table(rng.standard_normal((9, 7, 3)).astype(np.float32))
        noise = NoiseStream.from_tables(rng.random((9, 4, 5)), rng.random((9, 4, 7)))
    else:
        key = bkey = V0Stream(5)
        noise = NoiseStream(5, worker=1)
    assert torch.equal(key.segment(3, 4, 7, "cpu"),
                       torch.stack([key(t, 7, "cpu") for t in range(3, 7)]))
    assert torch.equal(bkey.block_segment(3, 4, 7, 3, "cpu"),
                       torch.stack([bkey.block(t, 7, 3, "cpu") for t in range(3, 7)]))
    u, v = noise.segment(3, 4, 2, 5, 7, "cpu")
    assert torch.equal(u, torch.stack([torch.stack([noise(t, i, "u", 5, "cpu") for i in range(2)])
                                       for t in range(3, 7)]))
    assert torch.equal(v, torch.stack([torch.stack([noise(t, i, "v", 7, "cpu") for i in range(2)])
                                       for t in range(3, 7)]))


# ---------------------------------------------------------------------------
# Against the JAX package's run_epochs, both modes
# ---------------------------------------------------------------------------


def _v0_table(epochs, m):
    return np.stack([np.asarray(sphere_vector(jax.random.fold_in(KEY, t), m))
                     for t in range(epochs)])


def _noise_tables(epochs, iters, dims):
    """The reference's serial int8 noise: uniform(fold_in(fold_in(fold_in(
    fold_in(key, t), 0xC033), i), slot))."""
    return [np.array([[np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(KEY, t), 0xC033), i), slot), (dim,), jnp.float32))
        for i in range(iters)] for t in range(epochs)]) for slot, dim in enumerate(dims)]


def _close(got, want, atol_rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol_rel * np.max(np.abs(want)))


JAX_CASES = {
    "mtls": ("mtls", dict(mu=1.0, num_epochs=10, schedule="log", step_size="linesearch")),
    "logistic-int8": ("logistic", dict(mu=10.0, num_epochs=8, schedule="log_half",
                                       comm="int8")),
    "mc": ("mc", dict(mu=2.0, num_epochs=10, schedule="const:2", step_size="linesearch")),
}


@pytest.mark.parametrize("mode", ["scan", "legacy"])
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_modes_match_jax_run_epochs(data, case, mode):
    kind, kw = JAX_CASES[case]
    task, x, y, _ = _problem(kind, data)
    jtask = type(task).__name__
    jtask = {"MultiTaskLeastSquares": jtasks.MultiTaskLeastSquares,
             "MultinomialLogistic": jtasks.MultinomialLogistic,
             "MatrixCompletion": jtasks.MatrixCompletion}[jtask](d=task.d, m=task.m)
    jx, jy = (x, y) if kind != "mc" else jtasks.pack_observations(
        data["rows"], data["cols"], data["vals"])
    jr = jdfw.fit_serial(jtask, np.asarray(jx), np.asarray(jy), key=KEY,
                         cfg=jdfw.DFWConfig(use_pallas=False, engine=mode, **kw))
    noise = None
    if kw.get("comm") == "int8":
        noise = NoiseStream.from_tables(*_noise_tables(kw["num_epochs"], max(jr.history["k"]),
                                                       (task.d, task.m)))
    tr = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(engine=mode, **kw), device="cpu",
                        key=V0Stream.from_table(_v0_table(kw["num_epochs"], task.m)),
                        noise=noise)
    assert tr.epochs_run == jr.epochs_run and tr.history["k"] == jr.history["k"]
    for name in ("loss", "gap", "sigma", "gamma"):
        _close(tr.history[name], jr.history[name])
    _close(tr.final_loss, jr.final_loss)
    _close(low_rank.materialize(tr.iterate).numpy(), jlr.materialize(jr.iterate), atol_rel=RTOL)
    # the reference's own counts: its scan pays a dispatch a segment, legacy one an epoch
    assert tr.stats["dispatches"] == jr.stats["dispatches"]
    assert tr.stats["segments_run"] == jr.stats["segments_run"]


# ---------------------------------------------------------------------------
# Two gloo workers
# ---------------------------------------------------------------------------

MULTI = {
    "mtls-sampled": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:2",
                                  step_size="linesearch", sample_prob=0.7)),
    "logistic-int8": ("logistic", dict(mu=10.0, num_epochs=8, schedule="log", comm="int8",
                                       sample_prob=0.7)),
    "mc-hier-int8": ("mc", dict(mu=2.0, num_epochs=8, schedule="const:2",
                                step_size="linesearch", comm="int8", topology="hier:2")),
}


def _multi_ranks(group, device, data):
    """One worker: every MULTI case in both modes, then gap_tol in both."""
    out = {}
    for name, (kind, kw) in MULTI.items():
        task, x, y, _ = _problem(kind, data)
        if kind == "mc":
            x, y = dfw.shard_observations(data["rows"], data["cols"], data["vals"], group.size,
                                          MD, m=MM)
        for mode in ("scan", "legacy"):
            res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(engine=mode, **kw), key=3, group=group,
                          device=device)
            out[name, mode] = dict(
                history=res.history, final_loss=res.final_loss, epochs_run=res.epochs_run,
                iterate=[t.numpy() for t in res.iterate],
                state=[t.numpy() for t in engine._leaves(res.state)],
                masks=None if res.masks is None else res.masks.numpy(), stats=res.stats)
    task, x, y, _ = _problem("mtls", data)
    kw = dict(mu=1.0, num_epochs=30, schedule="const:2", step_size="linesearch",
              comm="int8", topology="hier:2")
    full = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=3, group=group, device=device)
    tol = float(full.history["gap"][0]) * 0.4
    for mode in ("scan", "legacy"):
        res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(engine=mode, gap_tol=tol, block_epochs=4, **kw),
                      key=3, group=group, device=device)
        out["gap_tol", mode] = dict(epochs_run=res.epochs_run, history=res.history,
                                    final_loss=res.final_loss, tol=tol,
                                    stats=res.stats)
    return out


@pytest.fixture(scope="module")
def multi(data):
    return dfw.run_workers(2, _multi_ranks, data, device="cpu")


@pytest.mark.parametrize("case", list(MULTI))
def test_two_workers_scan_equals_legacy(multi, case):
    for worker in multi:
        sc, lg = worker[case, "scan"], worker[case, "legacy"]
        assert sc["epochs_run"] == lg["epochs_run"] == MULTI[case][1]["num_epochs"]
        assert sc["history"] == lg["history"] and sc["final_loss"] == lg["final_loss"]
        for a, b in zip(sc["iterate"] + sc["state"], lg["iterate"] + lg["state"]):
            np.testing.assert_array_equal(a, b)
        if sc["masks"] is not None:
            np.testing.assert_array_equal(sc["masks"], lg["masks"])
        assert sc["stats"]["dispatches"] == sc["stats"]["segments_run"] + 1
        # the collectives the workers ran are the same in both modes
        assert sc["stats"]["all_reduces"] == lg["stats"]["all_reduces"]


def test_two_workers_gap_tol_stops_every_worker_at_one_epoch(multi):
    """Every worker reads the device flag of the same all-reduced gap, so
    both stop at the same epoch, in both modes, with the same history."""
    runs = [w["gap_tol", mode] for w in multi for mode in ("scan", "legacy")]
    assert len({r["epochs_run"] for r in runs}) == 1
    assert 0 < runs[0]["epochs_run"] < 30
    for r in runs:
        assert len(r["history"]["loss"]) == r["epochs_run"]
    for w in multi:
        assert w["gap_tol", "scan"]["history"] == w["gap_tol", "legacy"]["history"]
