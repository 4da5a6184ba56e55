"""The block:k solver over four workers: the port's ``launch.dfw.fit`` on a
``torch.distributed`` gloo group of four CPU processes (``run_workers``)
against the JAX package's ``launch.dfw.fit`` at ``num_workers=4`` (8 fake
CPU devices), as ``tests/test_torch_dfw_multi.py`` does for rank1.

One JAX subprocess (the device count locks at the first JAX start in a
process) runs five cases: least squares dense on a flat graph, ``:adapt``
under int8, ``:cold`` on ``hier:2``, logistic regression, and matrix
completion under ``topk:16``. It saves the histories, W, the executed power
iterations, every epoch's k fresh columns, the cold-start probe and every
worker's int8 noise at the flattened widths d k and m k. The port's four
processes run the same cases on the same numpy data with those arrays
injected (``V0Stream.from_table``, ``probe=``, ``NoiseStream.from_tables``).

Tolerances: the serial block tests' (tests/test_torch_block.py): histories
rtol 1e-4 with an atol of 1e-6 of max, W 1e-4 of max|W|; epoch counts and
executed power iterations exactly. Every worker's history and W are worker
0's bits (the probe and the iterate are replicated). The dense flat run's
collectives are counted: per epoch one all-reduce of (loss, <W, grad>), one
of the line-search terms and 2 per executed iteration, whose bytes are the
analytic ``comm_wire_bytes`` (2 x 4 (d + m) k per iteration) exactly.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import NoiseStream, V0Stream
from repro_torch.core import low_rank, tasks
from repro_torch.launch import dfw

SRC = str(Path(__file__).resolve().parent.parent / "src")
NW = 4
N, D, M = 1600, 40, 30
MD, MM = 64, 48

CASES = {
    "mtls-block4-dense": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:3",
                                       step_size="linesearch", solver="block:4")),
    "mtls-block3-adapt-int8": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:6",
                                            step_size="linesearch", solver="block:3:adapt",
                                            comm="int8")),
    "mtls-block3-cold-hier2": ("mtls", dict(mu=1.0, num_epochs=8, schedule="const:3",
                                            step_size="linesearch", solver="block:3:cold",
                                            topology="hier:2")),
    "logistic-block3": ("logistic", dict(mu=10.0, num_epochs=8, schedule="log",
                                         solver="block:3")),
    "mc-block2-topk": ("mc", dict(mu=1.5, num_epochs=8, schedule="const:3",
                                  step_size="linesearch", solver="block:2", comm="topk:16")),
}

_JAX_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import tasks, low_rank, frank_wolfe
from repro.core.power_method import sphere_vector
from repro.launch import dfw

data = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
key = jax.random.PRNGKey(1)
nw = data["nw"].item()
out = {}
idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], nw, data["md"].item(),
                                 m=data["mm"].item())
for name, (kind, kw) in cases.items():
    if kind == "mc":
        task, x, y = tasks.MatrixCompletion(d=data["md"].item(), m=data["mm"].item()), idx, yw
    elif kind == "mtls":
        task, x, y = tasks.MultiTaskLeastSquares(d=data["x"].shape[1], m=data["y"].shape[1]), \\
            data["x"], data["y"]
    else:
        task, x, y = tasks.MultinomialLogistic(d=data["x"].shape[1], m=data["y"].shape[1]), \\
            data["x"], data["labels"]
    piters = []
    res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=key, num_workers=nw,
                  callback=lambda s, aux: piters.extend(np.asarray(aux.piters)))
    for h in ("loss", "gap", "sigma", "gamma", "k"):
        out[f"{name}/{h}"] = np.asarray(res.history[h])
    out[f"{name}/piters"] = np.asarray(piters)
    out[f"{name}/W"] = np.asarray(low_rank.materialize(res.iterate))
    out[f"{name}/final_loss"] = np.asarray(res.final_loss)
    k = int(kw["solver"].split(":")[1])
    T, K = kw["num_epochs"], max(res.history["k"])
    out[f"{name}/v0"] = np.stack([np.stack([np.asarray(sphere_vector(jax.random.fold_in(
        jax.random.fold_in(key, t), 101 + j), task.m)) for j in range(k)], 1) for t in range(T)])
    out[f"{name}/probe"] = np.asarray(frank_wolfe.init_probe(kw["solver"], task.m))
    if kw.get("comm") == "int8":
        for j in range(nw):
            for slot, dim in ((0, task.d * k), (1, task.m * k)):
                out[f"{name}/noise{j}{'uv'[slot]}"] = np.array([[np.asarray(
                    jax.random.uniform(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                        jax.random.fold_in(jax.random.fold_in(key, t), 0xC033), i), slot), j),
                        (dim,), jnp.float32)) for i in range(K)] for t in range(T)])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, 6)) @ rng.standard_normal((6, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    labels = np.argmax(x @ w, axis=1).astype(np.int32)
    u = np.linalg.qr(rng.standard_normal((MD, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((MM, 5)))[0]
    sv = np.linspace(1.0, 0.2, 5)
    wm = (u * (sv / sv.sum())) @ v.T
    rows, cols = np.nonzero(rng.random((MD, MM)) < 0.35)
    return dict(x=x, y=y, labels=labels, rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                vals=wm[rows, cols].astype(np.float32), md=np.int64(MD), mm=np.int64(MM),
                nw=np.int64(NW))


def _ranks(group, device, data, ref):
    """One worker of the port's runs (module level: run_workers pickles it by
    name)."""
    torch.set_num_threads(1)
    idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], NW, MD, m=MM)
    out = {}
    for name, (kind, kw) in CASES.items():
        if kind == "mc":
            task, x, y = tasks.MatrixCompletion(MD, MM), idx, yw
        elif kind == "mtls":
            task, x, y = tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]
        else:
            task, x, y = tasks.MultinomialLogistic(D, M), data["x"], data["labels"]
        noise = None
        if kw.get("comm") == "int8":
            noise = NoiseStream.from_tables(ref[f"{name}/noise{group.rank}u"],
                                            ref[f"{name}/noise{group.rank}v"])
        piters = []
        res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=V0Stream.from_table(
            ref[f"{name}/v0"]), noise=noise, probe=ref[f"{name}/probe"], group=group,
            device=device, callback=lambda s, aux: piters.extend(aux.piters))
        out[name] = dict(history=res.history, W=low_rank.materialize(res.iterate).numpy(),
                         final_loss=res.final_loss, epochs_run=res.epochs_run, stats=res.stats,
                         piters=np.asarray(piters), probe=res.probe.numpy())
    # port only: int8 across hier groups leaves each cross group its own sums,
    # so the workers vote on :adapt's stop (one all-reduce MAX an iteration)
    piters = []
    res = dfw.fit(tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"], cfg=dfw.DFWConfig(
        mu=1.0, num_epochs=8, schedule="const:6", step_size="linesearch", solver="block:3:adapt",
        comm="int8", topology="hier:2"), key=3, group=group, device=device,
        callback=lambda s, aux: piters.extend(aux.piters))
    out["hier-int8-adapt"] = dict(piters=np.asarray(piters), loss=res.history["loss"],
                                  W=low_rank.materialize(res.iterate).numpy(), stats=res.stats)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("block_multi")
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
    port = dfw.run_workers(NW, _ranks, data, ref, device="cpu")
    return ref, port


def _close(got, want, rtol=1e-4, atol_rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_four_workers_block_match_jax(runs, name):
    ref, port = runs
    got = port[0][name]
    assert got["history"]["k"] == [int(k) for k in ref[f"{name}/k"]]
    assert got["epochs_run"] == len(ref[f"{name}/loss"])
    np.testing.assert_array_equal(got["piters"], ref[f"{name}/piters"])
    for key in ("loss", "gap", "sigma", "gamma"):
        _close(got["history"][key], ref[f"{name}/{key}"])
    _close(got["final_loss"], ref[f"{name}/final_loss"])
    _close(got["W"], ref[f"{name}/W"], atol_rel=1e-4)
    for other in port[1:]:  # iterate, histories and probe replicated, bit for bit
        assert other[name]["history"] == got["history"]
        assert np.array_equal(other[name]["W"], got["W"])
        assert np.array_equal(other[name]["probe"], got["probe"])
    if ":adapt" in CASES[name][1]["solver"]:
        assert min(got["piters"]) < max(got["history"]["k"]), "the adaptive stop never fired"


def test_block_collectives_and_bytes_are_the_analytic_ones(runs):
    """Dense on a flat graph: 2 all-reduces per executed iteration plus the
    epoch's two scalar ones and the final loss's; the exchanges' bytes are
    ``comm_wire_bytes`` exactly (the block iteration's 2K rounds, k times
    wider: ``block_collective_rounds_contract``)."""
    _, port = runs
    kind, kw = CASES["mtls-block4-dense"]
    k = 4
    got = port[0]["mtls-block4-dense"]
    iters = int(np.sum(got["piters"]))
    epochs = got["epochs_run"]
    stats = got["stats"]
    assert stats["all_reduces"] == 2 * iters + 2 * epochs + 1
    assert stats["comm_wire_bytes"] == iters * 2 * 4 * (D + M) * k
    scalar_bytes = (2 * epochs + 1) * 2 * 4 * 2 - 2 * 4  # (loss, inner), line search; final
    assert stats["bytes_all_reduce"] == stats["comm_wire_bytes"] + scalar_bytes


def test_adaptive_stop_is_agreed_where_the_workers_part(runs):
    """hier:2 + int8: the two cross groups round with their own noise, so
    their blocks part; every worker still runs the same iterations (else the
    next collective would hang), stops early somewhere, and returns worker
    0's iterate. Per executed iteration: 2 exchanges (each an intra-group
    sum, a MAX of the scale and an int8 sum) and the stop vote."""
    _, port = runs
    got = [w["hier-int8-adapt"] for w in port]
    for other in got[1:]:
        np.testing.assert_array_equal(other["piters"], got[0]["piters"])
        assert other["loss"] == got[0]["loss"]
        assert np.array_equal(other["W"], got[0]["W"])
    assert min(got[0]["piters"]) < 6
    iters, epochs = int(np.sum(got[0]["piters"])), len(got[0]["piters"])
    assert got[0]["stats"]["all_reduces"] == 7 * iters + 2 * epochs + 1
