"""Resuming a DFW-Trace run from its checkpoint in the port
(``DFWConfig(resume_from=..., resume_step=...)``), the contracts of
tests/test_checkpoint_resume.py, on the CPU.

- **Bit-exact.** A run that checkpoints every segment, resumed at an
  interior step, gives the uninterrupted run's history, final loss, iterate,
  state, reducer state and probe bit for bit (``torch.equal``): serially for
  the three tasks under dense, int8 and topk:4 and for MTLS and MC under
  block:4:adapt; over four gloo workers (``run_workers``) resumed on four
  for top-k with sampled workers, a gossip graph and hier:2 with block:4.
- **Elastic.** Four workers resumed on two stay within the reference's
  sharded-vs-serial tolerances (tests/test_dfw_launch.py): loss rtol 1e-5,
  gap rtol 1e-4 with atol 1e-5, sigma rtol 1e-4, W to 1e-5 of max|W|.
- **Warm restart and the edges:** a finished run, the wrong problem, a
  shrunk budget, a changed schedule, comm and budget, a fired gap
  certificate, the abandoned tail of the directory, a format-1 step or
  another block width (cold probe), a table-fed key.
- **Across the packages.** The JAX package's ``fit_serial`` (plain jnp
  path) writes a checkpoint and resumes from it; the port resumes from the
  same step with the JAX draws of every epoch injected
  (``V0Stream.from_table``). Then the other way round, from a port
  checkpoint. The resumed runs agree to the tolerances of
  tests/test_torch_fit.py: rtol 1e-4 on the histories and the final loss,
  W to 1e-4 of max|W|.
- **The dense MTLS operator** against the JAX package's on the same numpy
  inputs (rtol 1e-5, atol 1e-5 of max) and against the port's factored
  MTLS operator (the tolerances of tests/test_frank_wolfe.py).
"""
import dataclasses
import json
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch import V0Stream, checkpoint
from repro_torch.checkpoint.store import CheckpointStore, read_leaves
from repro_torch.core import frank_wolfe, low_rank, tasks
from repro_torch.launch import dfw

torch.set_num_threads(2)

N, D, M = 256, 40, 30  # the dense tasks
MD, MM = 60, 50  # matrix completion
NW = 4


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here rather than at module level: the
    worker processes of ``multi`` import this module and need none of it."""
    import jax

    from repro.core import low_rank as jlr
    from repro.core import tasks as jtasks
    from repro.core.power_method import sphere_vector
    from repro.launch import dfw as jdfw

    key = jax.random.PRNGKey(0)

    def table(m, epochs=10):
        """The JAX run's start vectors: sphere_vector(fold_in(key, t), m)."""
        return np.stack([np.asarray(sphere_vector(jax.random.fold_in(key, t), m))
                         for t in range(epochs)])

    return types.SimpleNamespace(jax=jax, jlr=jlr, jtasks=jtasks, jdfw=jdfw, key=key,
                                 table=table)


def _data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, 4)) @ rng.standard_normal((4, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    labels = np.argmax(x @ w, axis=1).astype(np.int32)
    u = np.linalg.qr(rng.standard_normal((MD, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((MM, 5)))[0]
    wm = (u * np.linspace(3.0, 0.6, 5)) @ v.T
    rows, cols = np.nonzero(rng.random((MD, MM)) < 0.27)
    vals = (wm[rows, cols] + 0.01 * rng.standard_normal(rows.size)).astype(np.float32)
    return dict(x=x, y=y, labels=labels, rows=rows.astype(np.int32),
                cols=cols.astype(np.int32), vals=vals)


@pytest.fixture(scope="module")
def data():
    return _data()


def _problem(kind, data, workers=None):
    """(port task, x, y); matrix completion in ``shard_observations``'
    layout for ``workers`` workers (None: ``pack_observations``)."""
    if kind == "mc":
        if workers is None:
            idx, yw = tasks.pack_observations(data["rows"], data["cols"], data["vals"])
        else:
            idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], workers,
                                             MD, m=MM)
        return tasks.MatrixCompletion(MD, MM), idx, yw
    if kind == "logistic":
        return tasks.MultinomialLogistic(D, M), data["x"], data["labels"]
    return tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]


def _kw(kind):
    if kind == "logistic":
        return dict(mu=5.0, schedule="const:2")
    return dict(mu=1.0 if kind == "mtls" else 3.0, schedule="const:2", step_size="linesearch")


def _same_bits(got, want, probe=False):
    assert got.epochs_run == want.epochs_run
    assert got.history == want.history
    assert got.final_loss == want.final_loss
    for name, a, b in zip(got.iterate._fields, got.iterate, want.iterate):
        assert torch.equal(a, b), name
    derived = getattr(want.state, "DERIVED", ())
    for name, a, b in zip(want.state._fields, got.state, want.state):
        if name not in derived:
            assert torch.equal(a, b), name
    if want.comm_state != ():
        for k in want.comm_state:
            assert torch.equal(got.comm_state[k], want.comm_state[k]), k
    if probe:
        assert torch.equal(got.probe, want.probe)


# ---------------------------------------------------------------------------
# Serial resume, bit for bit
# ---------------------------------------------------------------------------


SERIAL = [(kind, comm, "rank1") for kind in ("mtls", "logistic", "mc")
          for comm in ("dense", "int8", "topk:4")] + [
    ("mtls", "dense", "block:4:adapt"), ("mc", "dense", "block:4:adapt")]


@pytest.mark.parametrize("kind,comm,solver", SERIAL, ids=["-".join(c) for c in SERIAL])
def test_serial_resume_bitexact(kind, comm, solver, data, tmp_path):
    """Checkpoints every segment (3 epochs), resume at step 6 of 12: the
    carry, the seed, the reducer's residuals and the block probe restored,
    the start vectors, block columns and int8 noise are functions of (seed,
    t), and the MC state's sorted copies are rebuilt from its caller-order
    fields with the same bits."""
    task, x, y = _problem(kind, data)
    cfg = dfw.DFWConfig(num_epochs=12, block_epochs=3, comm=comm, solver=solver,
                        checkpoint_dir=str(tmp_path), checkpoint_keep=None, **_kw(kind))
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=11, device="cpu")
    assert CheckpointStore(tmp_path).steps() == [3, 6, 9, 12]
    res = dfw.fit_serial(task, x, y, device="cpu", key=11, cfg=dataclasses.replace(
        cfg, checkpoint_dir=None, resume_from=str(tmp_path), resume_step=6))
    assert res.stats["segments_run"] == 2
    _same_bits(res, full, probe=solver != "rank1")


def test_checkpoint_seed_replaces_an_int_key(data, tmp_path):
    """The run continues with the checkpoint's seed, whatever int key the
    resuming caller passes (the reference restores its carried key)."""
    task, x, y = _problem("mtls", data)
    cfg = dfw.DFWConfig(num_epochs=8, block_epochs=4, checkpoint_dir=str(tmp_path),
                        checkpoint_keep=None, **_kw("mtls"))
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=2**40 + 3, device="cpu")
    snap = checkpoint.restore_run(tmp_path, task=task, step=4)
    assert snap.seed == 2**40 + 3 and snap.t == 4 and not snap.done
    res = dfw.fit_serial(task, x, y, device="cpu", key=0, cfg=dataclasses.replace(
        cfg, checkpoint_dir=None, resume_from=str(tmp_path), resume_step=4))
    _same_bits(res, full)


def test_table_fed_key_is_kept(data, jx, tmp_path):
    """A table-fed stream's rows are indexed by absolute epoch: the resume
    keeps it, and does not replace it by the checkpoint's seed. A table-fed
    run records seed 0, the JAX run's key here."""
    task, x, y = _problem("mtls", data)
    table = jx.table(M)
    cfg = dfw.DFWConfig(num_epochs=10, block_epochs=5, checkpoint_dir=str(tmp_path),
                        checkpoint_keep=None, **_kw("mtls"))
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=V0Stream.from_table(table), device="cpu")
    key = read_leaves(tmp_path, 5, prefix="carry/key")[1]["carry/key"]
    np.testing.assert_array_equal(key, np.asarray(jx.key))
    rcfg = dataclasses.replace(cfg, checkpoint_dir=None, resume_from=str(tmp_path),
                               resume_step=5)
    res = dfw.fit_serial(task, x, y, cfg=rcfg, key=V0Stream.from_table(table), device="cpu")
    _same_bits(res, full)
    seeded = dfw.fit_serial(task, x, y, cfg=rcfg, key=0, device="cpu")  # the seed's own draws
    assert seeded.history["loss"][:5] == full.history["loss"][:5]
    assert seeded.history["sigma"][5:] != full.history["sigma"][5:]


# ---------------------------------------------------------------------------
# Edge cases and warm restarts
# ---------------------------------------------------------------------------


def test_resume_finished_run_returns_without_engine(data, tmp_path):
    task, x, y = _problem("mc", data)
    cfg = dfw.DFWConfig(num_epochs=8, block_epochs=4, solver="block:4",
                        checkpoint_dir=str(tmp_path), checkpoint_keep=None, **_kw("mc"))
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=3, device="cpu")
    res = dfw.fit_serial(task, x, y, key=3, device="cpu", cfg=dataclasses.replace(
        cfg, checkpoint_dir=None, resume_from=str(tmp_path)))
    assert res.stats == {"segments_planned": 0, "segments_run": 0, "dispatches": 1,
                         "host_syncs": 1}
    _same_bits(res, full, probe=True)


@pytest.mark.parametrize("other", ["task", "d", "m"])
def test_resume_rejects_wrong_problem(other, data, tmp_path):
    task, x, y = _problem("mtls", data)
    cfg = dfw.DFWConfig(num_epochs=4, checkpoint_dir=str(tmp_path), **_kw("mtls"))
    dfw.fit_serial(task, x, y, cfg=cfg, key=1, device="cpu")
    rcfg = dataclasses.replace(cfg, checkpoint_dir=None, resume_from=str(tmp_path))
    if other == "task":
        task, x, y = tasks.MultinomialLogistic(D, M), data["x"], data["labels"]
        rcfg = dataclasses.replace(rcfg, step_size="default")
    elif other == "d":
        task, x = tasks.MultiTaskLeastSquares(D - 1, M), data["x"][:, :-1]
    else:
        task, y = tasks.MultiTaskLeastSquares(D, M - 1), data["y"][:, :-1]
    with pytest.raises(ValueError, match="same problem"):
        dfw.fit_serial(task, x, y, cfg=rcfg, key=1, device="cpu")


def test_resume_rejects_shrunk_num_epochs(data, tmp_path):
    task, x, y = _problem("mtls", data)
    cfg = dfw.DFWConfig(num_epochs=10, block_epochs=5, checkpoint_dir=str(tmp_path),
                        checkpoint_keep=None, **_kw("mtls"))
    dfw.fit_serial(task, x, y, cfg=cfg, key=1, device="cpu")
    with pytest.raises(ValueError, match="num_epochs"):
        dfw.fit_serial(task, x, y, key=1, device="cpu", cfg=dataclasses.replace(
            cfg, num_epochs=8, checkpoint_dir=None, resume_from=str(tmp_path), resume_step=10))


def test_warm_restart_changes_schedule_comm_num_epochs(data, tmp_path):
    """Resumed at 10 with K = 2 where the run had K = 1, int8 where it had
    dense, 40 epochs where it had 30, and a gap certificate: the prefix is
    the checkpoint's, the new schedule applies from the resume point, the
    certificate stops the run, and it equals the same warm restart driven
    through the engine by hand."""
    task, x, y = _problem("mtls", data)
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=30, schedule="const:1", step_size="linesearch",
                        block_epochs=5, checkpoint_dir=str(tmp_path), checkpoint_keep=None)
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=1, device="cpu")
    tol = full.history["gap"][10] * 0.3
    warm = dfw.fit_serial(task, x, y, key=1, device="cpu", cfg=dataclasses.replace(
        cfg, schedule="const:2", comm="int8", num_epochs=40, gap_tol=tol,
        checkpoint_dir=None, resume_from=str(tmp_path), resume_step=10))
    assert warm.history["loss"][:10] == full.history["loss"][:10]
    assert warm.history["k"] == [1] * 10 + [2] * (warm.epochs_run - 10)
    assert 10 < warm.epochs_run < 40 and warm.history["gap"][-1] <= tol
    assert warm.final_loss < full.history["loss"][10]


def test_warm_restart_past_fired_certificate(data, tmp_path):
    """A run stopped by its gap certificate: the same gap_tol returns the
    stopped run; dropping it and extending num_epochs runs on from there."""
    task, x, y = _problem("mtls", data)
    kw = dict(mu=1.0, schedule="const:2", step_size="linesearch")
    probe = dfw.fit_serial(task, x, y, key=1, device="cpu",
                           cfg=dfw.DFWConfig(num_epochs=40, **kw))
    tol = probe.history["gap"][0] * 0.4
    cfg = dfw.DFWConfig(num_epochs=40, gap_tol=tol, block_epochs=5,
                        checkpoint_dir=str(tmp_path), checkpoint_keep=None, **kw)
    stopped = dfw.fit_serial(task, x, y, cfg=cfg, key=1, device="cpu")
    assert 0 < stopped.epochs_run < 40
    same = dfw.fit_serial(task, x, y, key=1, device="cpu", cfg=dataclasses.replace(
        cfg, checkpoint_dir=None, resume_from=str(tmp_path)))
    assert same.stats["segments_run"] == 0 and same.epochs_run == stopped.epochs_run
    assert same.final_loss == stopped.final_loss
    more = dfw.fit_serial(task, x, y, key=1, device="cpu", cfg=dataclasses.replace(
        cfg, checkpoint_dir=None, resume_from=str(tmp_path), gap_tol=None, num_epochs=50))
    assert more.epochs_run == 50
    assert more.history["loss"][:stopped.epochs_run] == stopped.history["loss"]
    assert more.final_loss < stopped.final_loss


def test_resume_into_same_dir_drops_abandoned_tail(data, tmp_path):
    task, x, y = _problem("mtls", data)
    cfg = dfw.DFWConfig(num_epochs=20, block_epochs=5, checkpoint_dir=str(tmp_path),
                        checkpoint_keep=None, **_kw("mtls"))
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=1, device="cpu")
    assert CheckpointStore(tmp_path).steps() == [5, 10, 15, 20]
    res = dfw.fit_serial(task, x, y, key=1, device="cpu", cfg=dataclasses.replace(
        cfg, block_epochs=10, resume_from=str(tmp_path), resume_step=10))
    assert res.epochs_run == 20 and res.history == full.history
    assert CheckpointStore(tmp_path).steps() == [5, 10, 20]
    assert checkpoint.restore_run(tmp_path, task=task).t == 20


def _cold_probe_copy(src, dst, step, *, format1):
    """A copy of ``src`` whose step ``step`` has the cold probe: format 1
    (no probe leaf) or the probe leaf overwritten by ``init_probe``'s."""
    shutil.copytree(src, dst)
    sdir = dst / f"step_{step:08d}"
    manifest = json.loads((sdir / "manifest.json").read_text())
    rec = next(r for r in manifest["leaves"] if r["path"] == "carry/probe")
    if format1:
        manifest["leaves"].remove(rec)
        (sdir / rec["file"]).unlink()
        manifest["extra"]["payload_format"] = 1
        (sdir / "manifest.json").write_text(json.dumps(manifest))
    else:
        np.save(sdir / rec["file"], frank_wolfe.init_probe("block:4", MM, "cpu").numpy())


def test_format1_or_another_width_cold_starts_the_probe(data, tmp_path):
    """A format-1 step carries no probe and a probe of another width does
    not fit: the run cold-starts it, as if the saved probe had been the
    cold one, and continues with the saved history."""
    task, x, y = _problem("mc", data)
    cfg = dfw.DFWConfig(num_epochs=8, block_epochs=4, solver="block:4",
                        checkpoint_dir=str(tmp_path / "run"), checkpoint_keep=None, **_kw("mc"))
    full = dfw.fit_serial(task, x, y, cfg=cfg, key=5, device="cpu")
    _cold_probe_copy(tmp_path / "run", tmp_path / "v1", 4, format1=True)
    _cold_probe_copy(tmp_path / "run", tmp_path / "cold", 4, format1=False)
    assert checkpoint.restore_run(tmp_path / "v1", task=task, step=4).probe == ()
    assert checkpoint.restore_run(tmp_path / "cold", task=task, step=4).probe.shape == (MM, 4)

    def resume(src, **over):
        return dfw.fit_serial(task, x, y, key=5, device="cpu", cfg=dataclasses.replace(
            cfg, checkpoint_dir=None, resume_from=str(tmp_path / src), resume_step=4, **over))

    v1, cold = resume("v1"), resume("cold")
    _same_bits(v1, cold, probe=True)
    assert v1.history["loss"][:4] == full.history["loss"][:4]
    assert not torch.equal(v1.probe, full.probe)
    wide = resume("run", solver="block:2", max_rank=32)  # the saved (m, 4) probe cannot serve
    assert wide.history["loss"][:4] == full.history["loss"][:4]
    assert wide.probe.shape == (MM, 2) and wide.epochs_run == 8


# ---------------------------------------------------------------------------
# Multi-worker: same mesh, elastic, gossip, hier + block
# ---------------------------------------------------------------------------


MULTI = {
    "topk-sampled": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:2",
                                  step_size="linesearch", comm="topk:4", sample_prob=0.6)),
    "mc-topk-sampled": ("mc", dict(mu=3.0, num_epochs=8, schedule="const:2",
                                   step_size="linesearch", comm="topk:4", sample_prob=0.6)),
    "gossip": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:2", step_size="linesearch",
                            topology="gossip:2")),
    "hier-block": ("mc", dict(mu=3.0, num_epochs=8, schedule="const:2", step_size="linesearch",
                              topology="hier:2", solver="block:4", comm="topk:4")),
    "elastic-mtls": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:2",
                                  step_size="linesearch")),
    "elastic-mc": ("mc", dict(mu=3.0, num_epochs=8, schedule="const:2",
                              step_size="linesearch")),
}


def _summary(res):
    return dict(history=res.history, final_loss=res.final_loss, epochs_run=res.epochs_run,
                iterate=[t.clone() for t in res.iterate],
                probe=res.probe if isinstance(res.probe, torch.Tensor) else None,
                comm_state={k: v.clone() for k, v in (res.comm_state or {}).items()},
                masks=None if res.masks is None else res.masks.numpy(), stats=res.stats)


def _ranks(group, device, data, ckdir):
    """One worker of the multi-worker runs (module level: run_workers starts
    it by name): each case uninterrupted with checkpoints every segment,
    then resumed at step 4 on the same four workers (or, for the elastic
    cases, on workers 0 and 1); the finished top-k run resumed at its end."""
    torch.set_num_threads(1)
    # workers 0 and 1 (split caches a group per rank set: hier:2 splits the same)
    two = group.split([[0, 1], [2, 3]])
    out = {}
    for name, (kind, kw) in MULTI.items():
        task, x, y = _problem(kind, data, NW)
        d = f"{ckdir}/{name}"
        cfg = dfw.DFWConfig(block_epochs=2, checkpoint_dir=d, checkpoint_keep=None, **kw)
        out[name, "full"] = _summary(dfw.fit(task, x, y, cfg=cfg, key=9, group=group,
                                             device=device))
        rcfg = dataclasses.replace(cfg, checkpoint_dir=None, resume_from=d, resume_step=4)
        if name.startswith("elastic"):
            if group.rank < 2:
                task, x, y = _problem(kind, data, 2)
                out[name, "resumed"] = _summary(dfw.fit(
                    task, x, y, cfg=rcfg, key=9, group=two, device=device))
        else:
            out[name, "resumed"] = _summary(dfw.fit(task, x, y, cfg=rcfg, key=9, group=group,
                                                    device=device))
    kind, kw = MULTI["topk-sampled"]
    task, x, y = _problem(kind, data, NW)
    out["finished"] = _summary(dfw.fit(task, x, y, key=9, group=group, device=device,
                                       cfg=dfw.DFWConfig(resume_from=f"{ckdir}/topk-sampled",
                                                         **kw)))
    if group.rank < 2:  # the sampled top-k run on two workers: fresh residuals, new masks
        out["elastic-topk"] = _summary(dfw.fit(
            task, x, y, key=9, group=two, device=device,
            cfg=dfw.DFWConfig(resume_from=f"{ckdir}/topk-sampled", resume_step=4, **kw)))
    return out


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("resume_multi")
    return dfw.run_workers(NW, _ranks, _data(), str(ckdir), device="cpu")


def _iterate(summary):
    return low_rank.FactoredIterate(*summary["iterate"])


@pytest.mark.parametrize("name", ["topk-sampled", "mc-topk-sampled", "gossip", "hier-block"])
def test_same_mesh_resume_bitexact(name, multi):
    """Every worker's resumed run has its uninterrupted run's bits: history,
    final loss, iterate (a gossip node restarts from node 0's, the one each
    worker returns), probe, its own top-k residuals, the saved masks."""
    for j, worker in enumerate(multi):
        full, res = worker[name, "full"], worker[name, "resumed"]
        assert res["history"] == full["history"], j
        assert res["final_loss"] == full["final_loss"] and res["epochs_run"] == 8
        assert all(torch.equal(a, b) for a, b in zip(res["iterate"], full["iterate"])), j
        assert res["comm_state"].keys() == full["comm_state"].keys()
        assert all(torch.equal(res["comm_state"][k], v) for k, v in full["comm_state"].items())
        if full["probe"] is not None:
            assert torch.equal(res["probe"], full["probe"])
        if full["masks"] is not None:
            np.testing.assert_array_equal(res["masks"], full["masks"])
        assert res["stats"]["segments_run"] == 2
    if "sampled" in name:
        assert (multi[0][name, "full"]["masks"] == 0).any()  # the sampling left workers out


def _within_sharded_tolerances(got, want):
    for key, rtol, atol in (("loss", 1e-5, 0.0), ("gap", 1e-4, 1e-5), ("sigma", 1e-4, 0.0)):
        np.testing.assert_allclose(got["history"][key], want["history"][key], rtol=rtol,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-5)
    w_got = low_rank.materialize(_iterate(got)).numpy()
    w_want = low_rank.materialize(_iterate(want)).numpy()
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-5 * np.abs(w_want).max())


@pytest.mark.parametrize("name", ["elastic-mtls", "elastic-mc"])
def test_elastic_resume_on_two_workers(name, multi):
    """Four workers' checkpoint at epoch 4 resumed on two: each keeps its
    half of the saved rows (matrix completion: two four-worker shards, their
    padding included); the run stays within the sharded tolerances of the
    uninterrupted four-worker run, and the two workers agree bit for bit."""
    full = multi[0][name, "full"]
    a, b = multi[0][name, "resumed"], multi[1][name, "resumed"]
    assert a["history"]["loss"][:4] == full["history"]["loss"][:4]
    assert a["history"] == b["history"] and a["epochs_run"] == 8
    _within_sharded_tolerances(a, full)


def test_elastic_resume_redraws_masks_and_residuals(multi):
    """On two workers the sampled top-k run keeps the saved history, draws a
    (num_epochs, 2) schedule and starts its residuals fresh."""
    got, full = multi[0]["elastic-topk"], multi[0]["topk-sampled", "full"]
    assert got["history"]["loss"][:4] == full["history"]["loss"][:4]
    assert got["masks"].shape == (8, 2) and got["epochs_run"] == 8
    assert np.isfinite(got["final_loss"])
    assert multi[1]["elastic-topk"]["history"] == got["history"]


def test_finished_multi_worker_resume(multi):
    """Resumed at its last step, every worker returns the run's history,
    iterate and the group-summed full-data loss without an epoch."""
    for worker in multi:
        got, full = worker["finished"], worker["topk-sampled", "full"]
        assert got["stats"]["segments_run"] == 0 and got["epochs_run"] == 8
        assert got["history"] == full["history"]
        assert all(torch.equal(a, b) for a, b in zip(got["iterate"], full["iterate"]))
        assert got["final_loss"] == full["final_loss"]
        np.testing.assert_array_equal(got["masks"], full["masks"])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


JAX_CASES = {
    "mtls-topk4": ("mtls", dict(mu=1.0, num_epochs=10, schedule="const:2",
                                step_size="linesearch", comm="topk:4")),
    "mc-dense": ("mc", dict(mu=3.0, num_epochs=10, schedule="const:2", step_size="linesearch")),
}


def _jax_problem(jx, kind, data):
    if kind == "mc":
        idx, yw = jx.jtasks.pack_observations(data["rows"], data["cols"], data["vals"])
        return jx.jtasks.MatrixCompletion(MD, MM), idx, yw
    return jx.jtasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]


def _close(got, want, rtol=1e-4, atol_rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.max(np.abs(want)))


def _assert_same_run(jx, jr, tr):
    assert tr.epochs_run == jr.epochs_run
    for name in ("loss", "gap", "sigma", "gamma"):
        _close(tr.history[name], jr.history[name])
    assert tr.history["k"] == jr.history["k"]
    _close(tr.final_loss, jr.final_loss)
    _close(low_rank.materialize(tr.iterate).numpy(), jx.jlr.materialize(jr.iterate),
           atol_rel=1e-4)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_port_resumes_a_jax_checkpoint(case, data, jx, tmp_path):
    """The JAX package's fit_serial writes steps 5 and 10 and resumes from
    5; the port resumes from the same step with the JAX draws injected. The
    checkpoint's key decodes to the JAX run's seed."""
    kind, kw = JAX_CASES[case]
    jtask, jxs, jys = _jax_problem(jx, kind, data)
    jcfg = jx.jdfw.DFWConfig(use_pallas=False, block_epochs=5, checkpoint_dir=str(tmp_path),
                             checkpoint_keep=None, **kw)
    jx.jdfw.fit_serial(jtask, jxs, jys, cfg=jcfg, key=jx.key)
    jres = jx.jdfw.fit_serial(jtask, jxs, jys, key=jx.key, cfg=dataclasses.replace(
        jcfg, checkpoint_dir=None, resume_from=str(tmp_path), resume_step=5))
    task, x, y = _problem(kind, data)
    snap = checkpoint.restore_run(tmp_path, task=task, step=5)
    assert snap.seed == 0 and snap.t == 5
    tres = dfw.fit_serial(task, x, y, key=V0Stream.from_table(jx.table(task.m)), device="cpu",
                          cfg=dfw.DFWConfig(block_epochs=5, resume_from=str(tmp_path),
                                            resume_step=5, **kw))
    _assert_same_run(jx, jres, tres)
    assert tres.history["loss"][:5] == jres.history["loss"][:5]


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_jax_resumes_a_port_checkpoint(case, data, jx, tmp_path):
    """The port, with the JAX run's draws injected, writes steps 5 and 10
    and records seed 0, the JAX run's key; the JAX package resumes from
    step 5 with the key it reads there, and so does the port with the same
    draws."""
    kind, kw = JAX_CASES[case]
    task, x, y = _problem(kind, data)
    cfg = dfw.DFWConfig(block_epochs=5, checkpoint_dir=str(tmp_path), checkpoint_keep=None, **kw)
    key = V0Stream.from_table(jx.table(task.m))
    dfw.fit_serial(task, x, y, cfg=cfg, key=key, device="cpu")
    assert checkpoint.restore_run(tmp_path, task=task, step=5).seed == 0
    tres = dfw.fit_serial(task, x, y, key=key, device="cpu", cfg=dataclasses.replace(
        cfg, checkpoint_dir=None, resume_from=str(tmp_path), resume_step=5))
    jtask, jxs, jys = _jax_problem(jx, kind, data)
    jres = jx.jdfw.fit_serial(jtask, jxs, jys, key=jx.jax.random.PRNGKey(7),
                              cfg=jx.jdfw.DFWConfig(use_pallas=False, block_epochs=5,
                                                    resume_from=str(tmp_path), resume_step=5,
                                                    **kw))
    _assert_same_run(jx, jres, tres)


# ---------------------------------------------------------------------------
# The dense MTLS operator
# ---------------------------------------------------------------------------


def _dense_inputs(data):
    rng = np.random.default_rng(4)
    u = rng.standard_normal(D).astype(np.float32)
    v = rng.standard_normal(M).astype(np.float32)
    return u / np.linalg.norm(u), v / np.linalg.norm(v), rng.standard_normal(M).astype(
        np.float32), rng.standard_normal(D).astype(np.float32)


def _near(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.max(np.abs(want)))


@pytest.mark.parametrize("gamma,mu", [(0.5, 1.0), (0.1, 3.0), (1.0, 0.5)])
def test_dense_mtls_matches_jax(gamma, mu, data, jx):
    """init_state, matvec, rmatvec, update and local_grad against the JAX
    package's ``MultiTaskLeastSquaresDense`` on the same numpy inputs."""
    u, v, p, q = _dense_inputs(data)
    jt, tt = jx.jtasks.MultiTaskLeastSquaresDense(D, M), tasks.MultiTaskLeastSquaresDense(D, M)
    js = jt.init_state(data["x"], data["y"])
    ts = tt.init_state(torch.from_numpy(data["x"]), torch.from_numpy(data["y"]))
    for name in ("xtx", "xty", "g"):
        _near(getattr(ts, name), getattr(js, name))
    js2, ts2 = jt.update(js, u, v, gamma, mu), tt.update(ts, torch.from_numpy(u),
                                                          torch.from_numpy(v), gamma, mu)
    for s_j, s_t in ((js, ts), (js2, ts2)):
        _near(tt.matvec(s_t, torch.from_numpy(p)), jt.matvec(s_j, p))
        _near(tt.rmatvec(s_t, torch.from_numpy(q)), jt.rmatvec(s_j, q))
        _near(tt.local_grad(s_t), jt.local_grad(s_j))


def test_dense_and_factored_mtls_agree(data):
    """The dense operator and the port's factored MTLS give the same
    gradient products, fresh and after an update (tests/test_frank_wolfe.py's
    tolerances), and the same dense gradient."""
    u, v, p, q = (torch.from_numpy(a) for a in _dense_inputs(data))
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    t1, t2 = tasks.MultiTaskLeastSquares(D, M), tasks.MultiTaskLeastSquaresDense(D, M)
    s1, s2 = t1.init_state(x, y.clone()), t2.init_state(x, y)
    for _ in range(2):
        np.testing.assert_allclose(t1.matvec(s1, p), t2.matvec(s2, p), rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(t1.rmatvec(s1, q), t2.rmatvec(s2, q), rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(t1.local_grad(s1), t2.local_grad(s2), rtol=2e-4, atol=2e-3)
        s1, s2 = t1.update(s1, u, v, 0.5, 1.0), t2.update(s2, u, v, 0.5, 1.0)


def test_kernelized_dense_mtls_delegates(data):
    """KernelizedTask hands the dense state to the base task's products, as
    the reference's does."""
    task = tasks.MultiTaskLeastSquaresDense(D, M)
    s = task.init_state(torch.from_numpy(data["x"]), torch.from_numpy(data["y"]))
    p = torch.from_numpy(_dense_inputs(data)[2])
    assert torch.equal(dfw.kernelize(task).matvec(s, p), task.matvec(s, p))


def test_fits_refuse_dense_mtls(data):
    task = tasks.MultiTaskLeastSquaresDense(D, M)
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=2)
    for run in (dfw.fit_serial, dfw.fit):
        with pytest.raises(TypeError, match="local_loss, inner_w_grad"):
            run(task, data["x"], data["y"], cfg=cfg, device="cpu")
