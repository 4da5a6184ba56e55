"""The multi-worker fit of the port (``repro_torch.launch.dfw.fit`` over a
``torch.distributed`` gloo group of CPU processes) against the JAX
package's ``repro.launch.dfw.fit`` at ``num_workers=4``.

One subprocess runs the JAX package on 8 fake CPU devices (the device count
locks at the first JAX start in a process, so it cannot run in the pytest
process) for five cases at the sizes of tests/test_dfw_launch.py: multi-task
least squares with the line search, multinomial logistic regression, matrix
completion dense and int8, and least squares with ``sample_prob=0.6``. It
saves the histories, W, the masks, the start vectors of every epoch and
every worker's int8 noise (``fold_in(key, j)``) to an ``.npz``. The port
then runs the same cases in 4 gloo processes (``run_workers``) on the same
numpy data, with those tables injected.

Tolerances. Dense runs (the three dense cases and the sampled one) are held
to the reference's own sharded-vs-serial tolerances
(tests/test_dfw_launch.py): loss rtol 1e-5, gap rtol 1e-4 with atol 1e-5
(logistic: 1e-4), sigma rtol 1e-4, W to 1e-6 of max|W|. The int8 run is
held to the serial int8 parity tests' tolerance (tests/test_torch_comm.py,
tests/test_torch_mc.py): rtol 1e-4 on the histories and 1e-4 of max|W|;
against jitted JAX the dequantized sums differ by up to two ulps (XLA
multiplies by f32(1/b) where the port divides once), which the power method
carries into the last digits. The port's world-size-1 ``fit`` equals
``fit_serial`` bit for bit, and a 2-worker run matches the 1-worker run at
the dense tolerances.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import NoiseStream, V0Stream
from repro_torch.comm import WorkerGroup
from repro_torch.core import low_rank, tasks
from repro_torch.launch import dfw

SRC = str(Path(__file__).resolve().parent.parent / "src")
NW = 4
N, D, M = 1600, 40, 30  # dense tasks
MD, MM = 64, 48  # matrix completion

CASES = {
    "mtls-linesearch": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:2",
                                     step_size="linesearch")),
    "logistic-log": ("logistic", dict(mu=10.0, num_epochs=8, schedule="log")),
    "mc-dense": ("mc", dict(mu=1.5, num_epochs=10, schedule="const:2", step_size="linesearch")),
    "mc-int8": ("mc", dict(mu=1.5, num_epochs=10, schedule="const:2", step_size="linesearch",
                           comm="int8")),
    "mtls-sampled": ("mtls", dict(mu=1.0, num_epochs=12, schedule="const:2",
                                  step_size="linesearch", sample_prob=0.6)),
}

_JAX_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import tasks, low_rank
from repro.core.power_method import sphere_vector
from repro.launch import dfw

data = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
key = jax.random.PRNGKey(1)
nw = data["nw"].item()
out = {}
idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], nw, data["md"].item(),
                                 m=data["mm"].item())
out["idx"], out["yw"] = np.asarray(idx), np.asarray(yw)
for name, (kind, kw) in cases.items():
    if kind == "mc":
        task = tasks.MatrixCompletion(d=data["md"].item(), m=data["mm"].item())
        x, y = idx, yw
    elif kind == "mtls":
        task, x, y = tasks.MultiTaskLeastSquares(d=data["x"].shape[1], m=data["y"].shape[1]), \\
            data["x"], data["y"]
    else:
        task, x, y = tasks.MultinomialLogistic(d=data["x"].shape[1], m=data["y"].shape[1]), \\
            data["x"], data["labels"]
    res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=key, num_workers=nw)
    for h in ("loss", "gap", "sigma", "gamma", "k"):
        out[f"{name}/{h}"] = np.asarray(res.history[h])
    out[f"{name}/W"] = np.asarray(low_rank.materialize(res.iterate))
    out[f"{name}/final_loss"] = np.asarray(res.final_loss)
    if res.masks is not None:
        out[f"{name}/masks"] = np.asarray(res.masks)
    T, K = kw["num_epochs"], max(res.history["k"])
    out[f"{name}/v0"] = np.stack([np.asarray(sphere_vector(jax.random.fold_in(key, t), task.m))
                                  for t in range(T)])
    if kw.get("comm") == "int8":
        for j in range(nw):
            for slot, dim in ((0, task.d), (1, task.m)):
                out[f"{name}/noise{j}{'uv'[slot]}"] = np.array([[np.asarray(
                    jax.random.uniform(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                        jax.random.fold_in(jax.random.fold_in(key, t), 0xC033), i), slot), j),
                        (dim,), jnp.float32)) for i in range(K)] for t in range(T)])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    labels = np.argmax(x @ w, axis=1).astype(np.int32)
    u = np.linalg.qr(rng.standard_normal((MD, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((MM, 5)))[0]
    sv = np.linspace(1.0, 0.2, 5)
    wm = (u * (sv / sv.sum())) @ v.T
    rows, cols = np.nonzero(rng.random((MD, MM)) < 0.35)
    return dict(x=x, y=y, labels=labels, rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                vals=wm[rows, cols].astype(np.float32), md=np.int64(MD), mm=np.int64(MM),
                nw=np.int64(NW))


def _summary(res):
    return dict(history=res.history, W=low_rank.materialize(res.iterate).cpu().numpy(),
                final_loss=res.final_loss, epochs_run=res.epochs_run, stats=res.stats,
                masks=None if res.masks is None else res.masks.numpy())


def _problem(kind, data, idx, yw):
    if kind == "mc":
        return tasks.MatrixCompletion(MD, MM), idx, yw
    if kind == "mtls":
        return tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]
    return tasks.MultinomialLogistic(D, M), data["x"], data["labels"]


def _ranks(group, device, data, ref, ckdir):
    """One worker of the port's runs (module level: run_workers pickles it
    by name). The sampled run also writes checkpoints to ``ckdir``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], NW, MD, m=MM)
    out = {}
    for name, (kind, kw) in CASES.items():
        task, x, y = _problem(kind, data, idx, yw)
        noise = None
        if kw.get("comm") == "int8":
            noise = NoiseStream.from_tables(ref[f"{name}/noise{group.rank}u"],
                                            ref[f"{name}/noise{group.rank}v"])
        if kw.get("sample_prob", 1.0) < 1.0:
            kw = dict(kw, checkpoint_dir=ckdir, checkpoint_keep=None)
        res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=V0Stream.from_table(
            ref[f"{name}/v0"]), noise=noise, masks=ref.get(f"{name}/masks"), group=group,
            device=device)
        out[name] = _summary(res)
    # a 1-worker and a 2-worker group of the same processes
    one, two = dist.new_group([0]), dist.new_group([0, 1])
    kind, kw = CASES["mtls-linesearch"]
    task, x, y = _problem(kind, data, idx, yw)
    key = V0Stream.from_table(ref["mtls-linesearch/v0"])
    if group.rank < 2:
        out["two"] = _summary(dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=key,
                                      group=WorkerGroup(two), device=device))
    if group.rank == 0:
        for name in ("mtls-linesearch", "mc-int8"):
            kind, kw = CASES[name]
            task, x, y = _problem(kind, data, idx, yw)
            key = V0Stream.from_table(ref[f"{name}/v0"])
            out[f"one/{name}"] = _summary(dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=key,
                                                  group=WorkerGroup(one), device=device))
            out[f"serial/{name}"] = _summary(dfw.fit_serial(
                task, x, y, cfg=dfw.DFWConfig(**kw), key=key, device=device,
                noise=NoiseStream(0, worker=0)))
    try:
        dfw.fit(tasks.MultiTaskLeastSquares(D, M), data["x"][:N - 3], data["y"][:N - 3],
                cfg=dfw.DFWConfig(mu=1.0, num_epochs=2), group=group, device=device)
    except ValueError as e:
        out["uneven"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dfw_multi")
    data = _data()
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    import json

    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(tmp / "data.npz"),
         str(tmp / "ref.npz"), json.dumps(CASES)],
        capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr[-4000:]}"
    ref = dict(np.load(tmp / "ref.npz"))
    port = dfw.run_workers(NW, _ranks, data, ref, str(tmp / "ckpt"), device="cpu")
    return data, ref, port, tmp / "ckpt"


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _assert_matches(got, ref, name, *, int8=False, logistic=False):
    assert got["history"]["k"] == [int(k) for k in ref[f"{name}/k"]]
    assert got["epochs_run"] == len(ref[f"{name}/loss"])
    h = got["history"]
    W, W_ref = got["W"], ref[f"{name}/W"]
    if int8:
        for key in ("loss", "gap", "sigma", "gamma"):
            _close(h[key], ref[f"{name}/{key}"], 1e-4, 1e-6 * np.max(np.abs(ref[f"{name}/{key}"])))
        _close(W, W_ref, 1e-4, 1e-4 * np.max(np.abs(W_ref)))
        return
    _close(h["loss"], ref[f"{name}/loss"], 1e-5)
    _close(h["gap"], ref[f"{name}/gap"], 1e-4, 1e-4 if logistic else 1e-5)
    _close(h["sigma"], ref[f"{name}/sigma"], 1e-4)
    _close(got["final_loss"], ref[f"{name}/final_loss"], 1e-5)
    assert np.max(np.abs(W - W_ref)) <= 1e-6 * np.max(np.abs(W_ref))


@pytest.mark.parametrize("name", list(CASES))
def test_four_workers_match_jax(runs, name):
    data, ref, port, _ = runs
    kind, kw = CASES[name]
    got = port[0][name]
    _assert_matches(got, ref, name, int8=kw.get("comm") == "int8", logistic=kind == "logistic")
    for other in port[1:]:  # the iterate and the histories are replicated, bit for bit
        assert other[name]["history"] == got["history"]
        assert np.array_equal(other[name]["W"], got["W"])
    if kw.get("sample_prob", 1.0) < 1.0:
        masks = got["masks"]
        np.testing.assert_array_equal(masks, ref[f"{name}/masks"])
        assert masks.shape == (kw["num_epochs"], NW)
        assert np.all((masks > 0).sum(axis=1) >= 1) and np.any((masks > 0).sum(axis=1) < NW)
        assert got["final_loss"] < 0.5 * got["history"]["loss"][0]
    else:
        assert got["masks"] is None


def test_matrix_completion_shards_match_jax(runs):
    data, ref, _, _ = runs
    idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], NW, MD, m=MM)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    np.testing.assert_array_equal(yw.numpy(), ref["yw"])


def test_collectives_per_epoch(runs):
    """Per epoch: one all-reduce of (loss, <W, grad>), 2K vector exchanges
    (int8: a MAX of the scale and an int8 SUM each), one of the line-search
    terms; one more for the final loss."""
    _, _, port, _ = runs
    for name, (kind, kw) in CASES.items():
        got = port[0][name]
        per_exchange = 2 if kw.get("comm") == "int8" else 1
        linesearch = kw.get("step_size") == "linesearch"
        want = sum(1 + 2 * k * per_exchange + linesearch for k in got["history"]["k"]) + 1
        assert got["stats"]["all_reduces"] == want, name


@pytest.mark.parametrize("name", ["mtls-linesearch", "mc-int8"])
def test_world_size_one_fit_is_fit_serial_bit_for_bit(runs, name):
    """fit over a 1-worker group (int8: with worker 0's noise, which
    fit_serial is handed) gives fit_serial's bits."""
    _, _, port, _ = runs
    one, serial = port[0][f"one/{name}"], port[0][f"serial/{name}"]
    assert one["history"] == serial["history"] and one["final_loss"] == serial["final_loss"]
    assert np.array_equal(one["W"], serial["W"])


def test_two_workers_match_one(runs):
    _, ref, port, _ = runs
    two, one = port[0]["two"], port[0]["one/mtls-linesearch"]
    assert port[1]["two"]["history"] == two["history"]
    ref1 = {f"mtls-linesearch/{k}": np.asarray(v) for k, v in one["history"].items()}
    ref1["mtls-linesearch/W"] = one["W"]
    ref1["mtls-linesearch/final_loss"] = one["final_loss"]
    _assert_matches(two, ref1, "mtls-linesearch")


def test_uneven_rows_rejected(runs):
    _, _, port, _ = runs
    for worker in port:
        assert "not divisible by 4 workers" in worker["uneven"]


def test_worker_zero_writes_checkpoints_the_reference_restores(runs):
    """The sampled 4-worker run's checkpoints, written by worker 0, restore
    in the JAX package: the whole state in rank order, the iterate, the
    history, the (num_epochs, 4) masks and the run's configuration."""
    from repro.checkpoint import restore_run
    from repro.core import low_rank as jlr
    from repro.core import tasks as jtasks

    data, _, port, ckdir = runs
    got = port[0]["mtls-sampled"]
    kw = CASES["mtls-sampled"][1]
    snap = restore_run(ckdir, state_like=jtasks.MultiTaskLeastSquares(D, M).init_state(
        data["x"], data["y"]))
    assert snap.t == kw["num_epochs"] and snap.extra["num_workers"] == NW
    assert snap.extra["sample_prob"] == 0.6 and snap.extra["reweight"] is True
    np.testing.assert_array_equal(snap.masks, got["masks"])
    np.testing.assert_array_equal(np.asarray(snap.carry.state.x), data["x"])
    np.testing.assert_array_equal(np.asarray(snap.carry.state.y), data["y"])
    assert snap.history["loss"] == got["history"]["loss"]
    W = np.asarray(jlr.materialize(snap.unpack_iterate(kw["num_epochs"])))
    np.testing.assert_array_equal(W, got["W"])
    # the residual of the restored state is the one of the returned iterate
    r = np.asarray(snap.carry.state.r, np.float64)
    np.testing.assert_allclose(0.5 * np.sum(r * r), got["final_loss"], rtol=1e-5)


def test_worker_schedule_always_keeps_one_alive():
    masks = dfw.worker_schedule(0, 200, 8, 0.05, reweight=False)
    assert masks.shape == (200, 8) and masks.dtype == torch.float32
    assert int((masks > 0).sum(dim=1).min()) >= 1
    assert set(torch.unique(masks).tolist()) <= {0.0, 1.0}
    assert torch.equal(masks, dfw.worker_schedule(0, 200, 8, 0.05, reweight=False))


def test_worker_schedule_reweight_is_unbiased():
    masks = dfw.worker_schedule(1, 100, 8, 0.5, reweight=True)
    np.testing.assert_allclose(masks.sum(dim=1).numpy(), np.full(100, 8.0), rtol=1e-5)
    assert int((masks > 0).sum(dim=1).min()) < 8  # p = 0.5 over 100 epochs varies


def test_worker_schedule_full_participation_and_injected_table():
    assert torch.equal(dfw.worker_schedule(2, 10, 4, 1.0), torch.ones(10, 4))
    table = np.random.default_rng(0).random((5, 3)).astype(np.float32)
    np.testing.assert_array_equal(dfw.worker_schedule(0, 5, 3, 0.5, table=table).numpy(), table)
    with pytest.raises(ValueError, match="shape"):
        dfw.worker_schedule(0, 6, 3, 0.5, table=table)


def test_fit_serial_rejects_sampling():
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=2, sample_prob=0.5)
    with pytest.raises(ValueError, match="needs multiple workers"):
        dfw.fit_serial(tasks.MultiTaskLeastSquares(3, 2), np.zeros((4, 3), np.float32),
                       np.zeros((4, 2), np.float32), cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="sample_prob"):
        dfw.DFWConfig(mu=1.0, num_epochs=2, sample_prob=0.0)


def test_max_abs_is_one_reduction_with_the_same_bits():
    """The int8 exchange's scale, vector_norm(x, inf), has the bits of
    max(abs(x)) (a max is exact in any order)."""
    gen = torch.Generator().manual_seed(0)
    for n in (1, 17, 17_770, 480_189):
        x = torch.randn(n, generator=gen) * torch.rand(n, generator=gen) ** 8
        assert torch.equal(torch.linalg.vector_norm(x, float("inf")), torch.max(torch.abs(x)))


def test_noise_stream_per_worker():
    base = NoiseStream(7)(3, 1, "u", 50, "cpu")
    draws = [NoiseStream(7, worker=j)(3, 1, "u", 50, "cpu") for j in range(3)]
    assert all(not torch.equal(d, base) for d in draws)
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])
    assert torch.equal(NoiseStream(7, worker=1)(3, 1, "u", 50, "cpu"), draws[1])


def _die(group, device, rank, at_exit):
    """Worker ``rank`` aborts (SIGABRT): at once, or at its interpreter's
    exit, after run_workers has torn its groups down and written its result."""
    import atexit
    import resource

    if group.rank == rank:
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))  # no core file
        if at_exit:
            atexit.register(os.abort)
        else:
            os.abort()
    return group.rank


@pytest.mark.parametrize("at_exit", [False, True])
def test_run_workers_names_a_worker_that_died_on_a_signal(at_exit):
    """A native death leaves no error file: the error names the worker, the
    signal, and whether its result had been written."""
    when = "after" if at_exit else "before"
    with pytest.raises(RuntimeError,
                       match=f"worker 1 of 2 died on SIGABRT {when} its result was written"):
        dfw.run_workers(2, _die, 1, at_exit, device="cpu")


def _gone(pid: int) -> bool:
    """Has process ``pid`` died (a zombie, or reaped)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _die_then_peer_fails(group, device, where):
    """Worker 1 aborts (SIGABRT); worker 0 waits until it is dead, then
    raises, so its error file is written after the abort."""
    import resource
    import time

    pid_file = os.path.join(where, "pid1")
    if group.rank == 1:
        with open(pid_file + ".tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(pid_file + ".tmp", pid_file)
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        os.abort()
    deadline = time.monotonic() + 60
    while not os.path.exists(pid_file) and time.monotonic() < deadline:
        time.sleep(0.01)
    with open(pid_file) as f:
        pid = int(f.read())
    while not _gone(pid) and time.monotonic() < deadline:
        time.sleep(0.01)
    raise ValueError("worker 0 failed after its peer died")


def test_run_workers_names_the_signal_over_a_later_peer_error(tmp_path):
    """The bad order: the peer of a worker that died on a signal fails after
    it, with an error file. The dead worker is named, whichever process the
    join reaches first, and whatever the exit codes' order."""
    with pytest.raises(RuntimeError,
                       match="worker 1 of 2 died on SIGABRT before its result was written"):
        dfw.run_workers(2, _die_then_peer_fails, str(tmp_path), device="cpu")
    # the decision alone, from the exit codes in both orders, beside worker 0's error file
    with open(tmp_path / "error0.pkl", "wb") as f:
        pickle.dump((ValueError("later"), "traceback"), f)
    for ended in ({0: 1, 1: -6}, {1: -6, 0: 1}):
        with pytest.raises(RuntimeError, match="worker 1 of 2 died on SIGABRT before"):
            dfw._raise_worker_failure(ended, 2, str(tmp_path))
    with pytest.raises(ValueError, match="later"):  # no signal: the first error file
        dfw._raise_worker_failure({0: 1, 1: 1}, 2, str(tmp_path))


def _hier_then_teardown(group, device, x, y):
    """A hier:2 fit (two subgroup splits: intra and cross), then the
    teardown run_workers does; returns the cache before and after."""
    import torch.distributed as dist

    from repro_torch.comm import base

    dfw.fit(tasks.MultiTaskLeastSquares(D, M), x, y, cfg=dfw.DFWConfig(
        mu=1.0, num_epochs=2, schedule="const:2", topology="hier:2"), key=0, group=group,
        device=device)
    made = sorted(key[1] for key in base._SUBGROUPS)
    base.destroy_groups()
    base.destroy_groups()  # a second call (run_workers' own) does nothing
    return made, len(base._SUBGROUPS), dist.is_initialized()


def test_subgroups_are_released_with_the_world_group():
    """The subgroups a hier:2 run split off are destroyed and forgotten when
    the worker tears its groups down, not left to the interpreter's exit."""
    data = _data()
    got = dfw.run_workers(NW, _hier_then_teardown, data["x"], data["y"], device="cpu")
    for made, left, initialized in got:
        assert made == [(0, 1), (0, 2), (1, 3), (2, 3)]
        assert left == 0 and not initialized
