"""The port's run checkpoints (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint``, on the CPU.

The store's semantics mirror tests/test_checkpoint_resume.py: a ``.tmp_``
step is invisible, ``keep_last`` prunes, a failed async write is raised at
``wait()``, ``discard_after`` drops later steps, a step saved again replaces
the old one. Across the packages: a checkpoint written by the JAX package
is served by the port (its packed iterate read bit for bit); a port
``fit_serial(checkpoint_dir=...)`` (MTLS and MC, the JAX run's v0 stream
injected) is read by ``repro.checkpoint.read_iterate_packed`` and
``restore_run``; the same fits in both packages write manifests with the
same (path, shape, dtype) leaves in the same order. Leaves written from the
port's own arrays must match them exactly; scores of the two engines agree
to rtol 1e-5 with an atol of 1e-6 times max|score|.
"""
import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import serve as jserve
from repro.core import low_rank as jlr
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.launch import dfw as jdfw
from repro_torch import V0Stream, checkpoint
from repro_torch import serve as pserve
from repro_torch.checkpoint.store import CheckpointStore, read_leaves
from repro_torch.core import frank_wolfe, low_rank, tasks
from repro_torch.launch import dfw

torch.set_num_threads(2)

N, D, M = 200, 24, 18
KEY = jax.random.PRNGKey(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, 3)) @ rng.standard_normal((3, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    labels = np.argmax(x @ w, axis=1).astype(np.int32)
    p = 400
    rows = rng.integers(0, D, p).astype(np.int32)
    cols = rng.integers(0, M, p).astype(np.int32)
    vals = (3.0 * w[rows, cols] + 0.05 * rng.standard_normal(p)).astype(np.float32)
    return dict(x=x, y=y, labels=labels, rows=rows, cols=cols, vals=vals)


def _v0_table(epochs):
    return np.stack([np.asarray(sphere_vector(jax.random.fold_in(KEY, t), M))
                     for t in range(epochs)])


# kind -> (port task, JAX task, DFWConfig fields)
FITS = {
    "mtls": dict(mu=1.0, num_epochs=6, schedule="log", step_size="linesearch"),
    "mtls-int8": dict(mu=1.0, num_epochs=5, schedule="log", comm="int8"),
    "logistic": dict(mu=5.0, num_epochs=5, schedule="log_half"),
    "mc": dict(mu=3.0, num_epochs=6, schedule="log", step_size="linesearch"),
}


def _problem(kind, data):
    """(port task, JAX task, port inputs, JAX inputs)."""
    if kind.startswith("mc"):
        tidx, tyw = tasks.pack_observations(data["rows"], data["cols"], data["vals"])
        jidx, jyw = jtasks.pack_observations(data["rows"], data["cols"], data["vals"])
        return (tasks.MatrixCompletion(D, M), jtasks.MatrixCompletion(D, M),
                (tidx, tyw), (jidx, jyw))
    if kind == "logistic":
        return (tasks.MultinomialLogistic(D, M), jtasks.MultinomialLogistic(D, M),
                (data["x"], data["labels"]), (data["x"], data["labels"]))
    return (tasks.MultiTaskLeastSquares(D, M), jtasks.MultiTaskLeastSquares(D, M),
            (data["x"], data["y"]), (data["x"], data["y"]))


def _fit_both(kind, data, tmp_path, **over):
    """The same fit, checkpointed, in both packages: (port result, port dir,
    JAX result, JAX dir)."""
    kw = {**FITS[kind], **over}
    ptask, jtask, pin, jin = _problem(kind, data)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    jr = jdfw.fit_serial(jtask, *jin, key=KEY, cfg=jdfw.DFWConfig(
        use_pallas=False, checkpoint_dir=str(jdir), checkpoint_keep=None, **kw))
    pr = dfw.fit_serial(ptask, *pin, cfg=dfw.DFWConfig(
        checkpoint_dir=str(pdir), checkpoint_keep=None, **kw),
        key=V0Stream.from_table(_v0_table(kw["num_epochs"])), device="cpu")
    return pr, pdir, jr, jdir


def _manifest(directory, step):
    return json.loads((directory / f"step_{step:08d}" / "manifest.json").read_text())


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


def test_tmp_step_is_invisible(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(5, {"x": np.arange(4, dtype=np.float32)})
    partial = tmp_path / ".tmp_step_00000010"
    partial.mkdir()
    np.save(partial / "leaf_00000.npy", np.arange(9))
    (partial / "manifest.json").write_text('{"truncated')
    assert store.steps() == [5] and store.latest_step() == 5
    step, leaves, _ = read_leaves(tmp_path)
    assert step == 5
    np.testing.assert_array_equal(leaves["x"], np.arange(4, dtype=np.float32))


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_last_prunes_old_steps(tmp_path, keep):
    store = CheckpointStore(tmp_path, keep_last=keep)
    for s in (1, 2, 3, 4):
        store.save_async(s, {"x": np.full(2, s)})
    store.wait()
    assert store.steps() == [1, 2, 3, 4][-keep:]
    assert read_leaves(tmp_path)[1]["x"][0] == 4
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointStore(tmp_path, keep_last=0)


def test_failed_async_write_is_raised_at_wait(tmp_path):
    store = CheckpointStore(tmp_path)
    blocker = tmp_path / ".tmp_step_00000007"
    blocker.write_text("a file where the staging directory must go")
    store.save_async(7, {"x": np.arange(3)})
    with pytest.raises(RuntimeError, match=r"step 7.*step_00000007") as ei:
        store.wait()
    assert ei.value.__cause__ is not None
    assert store.latest_step() is None
    store.wait()  # the error is consumed
    blocker.unlink()
    store.save_async(7, {"x": np.arange(3)})
    store.wait()
    assert store.latest_step() == 7


def test_failed_async_write_is_raised_at_next_save(tmp_path):
    store = CheckpointStore(tmp_path)
    (tmp_path / ".tmp_step_00000003").write_text("blocker")
    store.save_async(3, {"x": np.zeros(2)})
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="step 3"):
        store.save_async(4, {"x": np.zeros(2)})


def test_discard_after_removes_later_steps(tmp_path):
    store = CheckpointStore(tmp_path)
    for s in (2, 4, 6, 8):
        store.save(s, {"x": np.full(1, s)})
    store.discard_after(4)
    assert store.steps() == [2, 4]


def test_step_saved_again_replaces_the_old_one(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(5, {"x": np.zeros(3, np.float32)})
    store.save(5, {"x": np.ones(3, np.float32)})
    assert store.steps() == [5]
    np.testing.assert_array_equal(read_leaves(tmp_path, 5)[1]["x"], np.ones(3, np.float32))
    assert not list(tmp_path.glob(".old_step_*"))


def test_orphaned_old_step_is_put_back_on_open(tmp_path):
    CheckpointStore(tmp_path).save(5, {"x": np.zeros(2, np.float32)})
    (tmp_path / "step_00000005").rename(tmp_path / ".old_step_00000005")
    assert checkpoint.store.list_steps(tmp_path) == []  # readers rename nothing
    assert CheckpointStore(tmp_path).steps() == [5]
    (tmp_path / ".old_step_00000005").mkdir()
    assert CheckpointStore(tmp_path).steps() == [5]
    assert not list(tmp_path.glob(".old_step_*"))


def test_newer_manifest_format_is_rejected(tmp_path):
    out = CheckpointStore(tmp_path).save(1, {"x": np.zeros(1)})
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["format"] == checkpoint.MANIFEST_FORMAT == jck.MANIFEST_FORMAT
    assert manifest["treedef"] is None
    manifest["format"] += 1
    (out / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="manifest format"):
        read_leaves(tmp_path, 1)


def test_save_async_snapshots_before_returning(tmp_path):
    """The dense tasks update their residual in place; a step must hold the
    values of its boundary, not of a later epoch."""
    r = torch.zeros(4)
    store = CheckpointStore(tmp_path)
    store.save_async(1, {"r": r, "scalar": 3})
    r.add_(1.0)
    store.wait()
    leaves = read_leaves(tmp_path)[1]
    np.testing.assert_array_equal(leaves["r"], np.zeros(4, np.float32))
    assert leaves["scalar"] == 3


def test_readers_need_a_step(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.read_iterate_packed(tmp_path / "missing")
    assert not (tmp_path / "missing").exists()


def test_read_iterate_packed_rejects_foreign_checkpoints(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, {"weights": np.ones(3, np.float32)}, extra={"payload_format": 1})
    with pytest.raises(ValueError, match="no packed iterate"):
        checkpoint.read_iterate_packed(tmp_path)
    store.save(2, {"x": np.ones(2, np.float32)}, extra={})
    with pytest.raises(ValueError, match="payload format"):
        checkpoint.read_iterate_packed(tmp_path)


def test_run_checkpointer_requires_restorable_extra(tmp_path):
    with pytest.raises(ValueError, match="run_extra"):
        checkpoint.RunCheckpointer(tmp_path)
    with pytest.raises(ValueError, match="comm"):
        checkpoint.RunCheckpointer(tmp_path, extra={"task": "X"})
    with pytest.raises(ValueError, match="save_every"):
        checkpoint.RunCheckpointer(tmp_path, save_every=0)


# ---------------------------------------------------------------------------
# The payload against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 3, 12345, 2**31 + 7, 2**32 - 1])
def test_carry_key_is_the_prng_key_layout(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = checkpoint.dfw.prng_key(seed)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_fit_writes_its_seed_as_carry_key(data, tmp_path):
    dfw.fit_serial(tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"],
                   cfg=dfw.DFWConfig(mu=1.0, num_epochs=2, checkpoint_dir=str(tmp_path)),
                   key=12345, device="cpu")
    key = read_leaves(tmp_path, prefix="carry/key")[1]["carry/key"]
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(12345)))


@pytest.mark.parametrize("kind", list(FITS))
def test_manifests_match_jax_leaf_for_leaf(kind, data, tmp_path):
    """Same steps; per step the same (path, shape, dtype) list in the same
    order; the same extra but for jax_version/torch_version."""
    _, pdir, _, jdir = _fit_both(kind, data, tmp_path)
    steps = jck.CheckpointStore(jdir).steps()
    assert steps and CheckpointStore(pdir).steps() == steps
    for step in steps:
        pm, jm = _manifest(pdir, step), _manifest(jdir, step)
        assert [(r["path"], r["shape"], r["dtype"]) for r in pm["leaves"]] == \
            [(r["path"], r["shape"], r["dtype"]) for r in jm["leaves"]]
        assert [r["file"] for r in pm["leaves"]] == [r["file"] for r in jm["leaves"]]
        pe, je = dict(pm["extra"]), dict(jm["extra"])
        assert pe.pop("torch_version") == torch.__version__
        assert je.pop("jax_version") == jax.__version__
        assert pe == je
        assert (pm["format"], pm["step"]) == (jm["format"], jm["step"])


@pytest.mark.parametrize("kind", ["mtls", "mc", "mtls-int8"])
def test_port_checkpoint_is_read_by_jax(kind, data, tmp_path):
    """repro.checkpoint.read_iterate_packed gives the port's pack_live bit
    for bit; restore_run maps every leaf by order into the JAX skeleton."""
    pr, pdir, _, _ = _fit_both(kind, data, tmp_path)
    step, packed, extra = jck.read_iterate_packed(pdir)
    assert step == FITS[kind]["num_epochs"] and extra["payload_format"] == 3
    want = low_rank.pack_live(pr.iterate)
    assert sorted(packed) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(packed[k], want[k])
    _, jtask, _, jin = _problem(kind, data)
    snap = jck.restore_run(pdir, state_like=jtask.init_state(*jin))
    assert snap.t == pr.epochs_run and not snap.done
    assert snap.history == pr.history
    derived = getattr(pr.state, "DERIVED", ())  # the MC state's sorted copies: not written
    for name, val in zip(pr.state._fields, pr.state):
        if isinstance(val, torch.Tensor) and name not in derived:
            np.testing.assert_array_equal(getattr(snap.carry.state, name), val.numpy())
    np.testing.assert_array_equal(np.asarray(snap.carry.key), np.asarray(jax.random.PRNGKey(0)))
    assert int(snap.carry.t) == pr.epochs_run
    np.testing.assert_array_equal(jlr.materialize(snap.unpack_iterate(8)),
                                  jlr.materialize(jlr.unpack_live(want, 8)))


@pytest.mark.parametrize("kind", ["mtls", "mc"])
def test_jax_checkpoint_is_served_by_the_port(kind, data, tmp_path):
    """Every step a JAX run wrote: the port reads the packed iterate bit for
    bit, and its engine scores as the JAX engine on the same checkpoint."""
    _, _, jr, jdir = _fit_both(kind, data, tmp_path)
    x = np.random.default_rng(3).standard_normal((5, D)).astype(np.float32)
    for step in jck.CheckpointStore(jdir).steps():
        pstep, packed, extra = checkpoint.read_iterate_packed(jdir, step)
        _, want, _ = jck.read_iterate_packed(jdir, step)
        assert pstep == step and (extra["d"], extra["m"]) == (D, M)
        for k in want:
            np.testing.assert_array_equal(packed[k], np.asarray(want[k]))
        cfg = dict(max_batch=8, rank_block=4)
        port = pserve.ServingEngine.from_checkpoint(jdir, pserve.ServeConfig(**cfg),
                                                    step=step, device="cpu")
        ref = jserve.ServingEngine.from_checkpoint(jdir, jserve.ServeConfig(**cfg), step=step)
        want_scores = ref.score(x)
        np.testing.assert_allclose(port.score(x), want_scores, rtol=1e-5,
                                   atol=1e-6 * np.max(np.abs(want_scores)))
        assert port.model.step == step and port.model.live_rank == ref.model.live_rank
    np.testing.assert_array_equal(packed["u"], np.asarray(jlr.pack_live(jr.iterate)["u"]))


def test_payload_refuses_unported_carry_parts():
    """Every carry part is written now. Reducer state is written since top-k
    was ported (it was refused before): its residuals u, v follow the
    iterate, in the reference's leaf order. A block-solver probe is written
    since the block tier was ported (it was refused before): the (m, k)
    leaf ``carry/probe`` follows ``carry/key``, the carry's last field, as
    in the reference's format 3; a rank1 carry has no probe leaf."""
    it = low_rank.init(2, D, M, device="cpu")
    state = tasks.MTLSState(*[torch.zeros(1, 1)] * 3)
    residuals = {"v": torch.arange(M, dtype=torch.float32), "u": torch.ones(D)}
    carry = frank_wolfe.init_carry(state, it, 0, comm_state=residuals)
    leaves = checkpoint.dfw.payload(carry, {})
    paths = list(leaves)
    assert paths[paths.index("carry/iterate/v") + 1:paths.index("carry/t")] == [
        "carry/comm_state/u", "carry/comm_state/v"]
    assert leaves["carry/comm_state/v"] is residuals["v"]
    assert "carry/probe" not in leaves
    probe = torch.zeros(M, 2)
    paths = list(checkpoint.dfw.payload(carry._replace(probe=probe), {}))
    assert paths[paths.index("carry/key") + 1] == "carry/probe"
    assert checkpoint.dfw.payload(carry._replace(probe=probe), {})["carry/probe"] is probe


# ---------------------------------------------------------------------------
# fit_serial with checkpointing
# ---------------------------------------------------------------------------


def test_dfwconfig_takes_the_checkpoint_fields(tmp_path):
    """(telemetry: tests/test_torch_obs.py; resume_*:
    tests/test_torch_resume.py)"""
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=2, checkpoint_dir=str(tmp_path),
                        checkpoint_every=3, checkpoint_keep=None)
    assert (cfg.checkpoint_every, cfg.checkpoint_keep) == (3, None)


def test_checkpointing_changes_nothing_in_the_run(data, tmp_path):
    """Same history, iterate and state bits with and without checkpoints;
    one host sync per saved boundary; the writer is joined on return."""
    base = dict(mu=1.0, num_epochs=8, schedule="log", step_size="linesearch")
    task = tasks.MultiTaskLeastSquares(D, M)
    plain = dfw.fit_serial(task, data["x"], data["y"], cfg=dfw.DFWConfig(**base), key=4,
                           device="cpu")
    ck = dfw.fit_serial(task, data["x"], data["y"], device="cpu", key=4,
                        cfg=dfw.DFWConfig(checkpoint_dir=str(tmp_path), checkpoint_keep=None,
                                          **base))
    assert ck.history == plain.history
    for a, b in zip(ck.iterate, plain.iterate):
        assert torch.equal(a, b)
    saves = plain.stats["segments_run"]  # log over 8 epochs: K = 1 1 2 2 2 2 2 3
    assert CheckpointStore(tmp_path).steps() == [2, 7, 8] and saves == 3
    # each saved boundary adds a sync (the final fetch stays, as the
    # reference counts it)
    assert ck.stats["host_syncs"] == plain.stats["host_syncs"] + saves
    assert ck.stats["dispatches"] == plain.stats["dispatches"]
    _, leaves, extra = read_leaves(tmp_path, 8, prefix="history/")
    assert extra["t"] == 8 and extra["done"] is False
    np.testing.assert_array_equal(leaves["history/loss"], np.asarray(plain.history["loss"]))


def test_fit_serial_owns_its_checkpoint_dir(data, tmp_path):
    """A fresh run clears an earlier run's steps; checkpoint_every thins the
    boundaries but keeps the last; checkpoint_keep prunes."""
    task = tasks.MultiTaskLeastSquares(D, M)
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=30, block_epochs=5, checkpoint_dir=str(tmp_path),
                        checkpoint_keep=None)
    dfw.fit_serial(task, data["x"], data["y"], cfg=cfg, key=0, device="cpu")
    assert CheckpointStore(tmp_path).steps() == [5, 10, 15, 20, 25, 30]
    dfw.fit_serial(task, data["x"], data["y"], key=0, device="cpu",
                   cfg=dataclasses.replace(cfg, num_epochs=12, checkpoint_every=2))
    assert CheckpointStore(tmp_path).steps() == [10, 12]
    dfw.fit_serial(task, data["x"], data["y"], key=0, device="cpu",
                   cfg=dataclasses.replace(cfg, num_epochs=20, checkpoint_keep=2))
    assert CheckpointStore(tmp_path).steps() == [15, 20]
    assert checkpoint.read_run_extra(tmp_path)[1]["num_epochs"] == 20


def test_gap_tol_stop_is_saved_as_done(data, tmp_path):
    task = tasks.MultiTaskLeastSquares(D, M)
    res = dfw.fit_serial(task, data["x"], data["y"], key=0, device="cpu", cfg=dfw.DFWConfig(
        mu=1.0, num_epochs=40, schedule="const:2", block_epochs=10, gap_tol=1e9,
        checkpoint_dir=str(tmp_path)))
    assert res.epochs_run == 1
    step, extra = checkpoint.read_run_extra(tmp_path)
    assert step == 1 and extra["done"] is True and extra["t"] == 1
