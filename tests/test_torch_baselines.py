"""The port's NAIVE-DFW and SVA baselines (``repro_torch.core.baselines``)
against the JAX package's (``repro.core.baselines``), on the CPU.

The same numpy data go through the reference's jitted epochs and the
port's, for 10 epochs, on multi-task least squares (line search),
multinomial logistic regression (2/(t+2)) and matrix completion (line
search); then NAIVE and SVA at 4 workers: the port over 4 gloo processes
(``launch.dfw.run_workers``), the reference under ``shard_map`` on 4 of 8
fake CPU devices in one subprocess (the device count locks at JAX's first
start in a process), its state sharded by rows as ``launch.dfw.fit`` shards
it.

Tolerances. Loss rtol 1e-5, gap, sigma and gamma rtol 1e-4 (gap with an
atol of 1e-5 of its max), W to 1e-4 of max|W| (the multi-worker tests'
tolerances, tests/test_torch_dfw_multi.py, with W at 1e-4 rather than
1e-6). SVA at 4 workers: gap, sigma and gamma rtol 1e-3. Its sigma is
|u^T (sum_j g_j) v| for the average of four local top pairs, far from the
global pair: the dot product cancels (sigma falls an order below its first
value), and the gap and the line search's step carry it; measured on
matrix completion, 1.8e-4, 1.5e-4 and 2.0e-4 relative, loss 7.4e-7, W
1.5e-5 of its max. The exact LMO is a dense SVD, LAPACK's through
``torch.linalg.svd`` in the port and XLA's own in the reference: the two
agree on the top singular pair only to a few ulps of its entries, and each
epoch's W carries them (measured here: W within about 1e-6 of max|W| after
10 epochs). NAIVE's ``u * sign(u^T g v)`` and SVA's ``_sign_fix`` make the
update independent of the sign an SVD picks, which the sign-flip test
checks.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import low_rank as jlr
from repro.core import tasks as jtasks
from repro_torch.core import baselines, low_rank, tasks
from repro_torch.launch import dfw

torch.set_num_threads(2)

SRC = str(Path(__file__).resolve().parent.parent / "src")
N, D, M = 512, 40, 30  # dense tasks
MD, MM = 64, 48  # matrix completion
EPOCHS = 10
NW = 4
MU = {"mtls": 1.0, "logistic": 10.0, "mc": 1.5}
STEP = {"mtls": "linesearch", "logistic": "default", "mc": "linesearch"}


def _data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    labels = np.argmax(x @ w + 0.3 * rng.standard_normal((N, M)), axis=1).astype(np.int32)
    u = np.linalg.qr(rng.standard_normal((MD, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((MM, 5)))[0]
    sv = np.linspace(1.0, 0.2, 5)
    wm = (u * (sv / sv.sum())) @ v.T
    rows, cols = np.nonzero(rng.random((MD, MM)) < 0.35)
    return dict(x=x, y=y, labels=labels, rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                vals=wm[rows, cols].astype(np.float32))


@pytest.fixture(scope="module")
def data():
    return _data()


def _mc_arrays(data, workers=1):
    idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], workers, MD, m=MM)
    return idx.numpy(), yw.numpy()


def _jax_problem(kind, data):
    if kind == "mtls":
        return jtasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]
    if kind == "logistic":
        return jtasks.MultinomialLogistic(D, M), data["x"], data["labels"]
    idx, yw = _mc_arrays(data)
    return jtasks.MatrixCompletion(MD, MM), idx, yw


def _port_problem(kind, data):
    if kind == "mtls":
        return tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]
    if kind == "logistic":
        return tasks.MultinomialLogistic(D, M), data["x"], data["labels"]
    idx, yw = _mc_arrays(data)
    return tasks.MatrixCompletion(MD, MM), idx, yw


def _jax_run(kind, method, data):
    task, x, y = _jax_problem(kind, data)
    make = jbase.make_naive_epoch_step if method == "naive" else jbase.make_sva_epoch_step
    ep = jax.jit(make(task, MU[kind], step_size=STEP[kind]))
    state, it = task.init_state(jnp.asarray(x), jnp.asarray(y)), jlr.init(EPOCHS, task.d, task.m)
    hist = {k: [] for k in ("loss", "gap", "sigma", "gamma")}
    for t in range(EPOCHS):
        state, it, aux = ep(state, it, jnp.float32(t), None)
        for k in hist:
            hist[k].append(float(getattr(aux, k)))
    return hist, np.asarray(jlr.materialize(it))


def _port_run(kind, method, data, group=None, device="cpu", task_state=None):
    task, x, y = _port_problem(kind, data)
    make = baselines.make_naive_epoch_step if method == "naive" else baselines.make_sva_epoch_step
    ep = make(task, MU[kind], step_size=STEP[kind], group=group)
    if task_state is None:
        xt, yt = torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))
        task_state = task.init_state(xt.to(device), yt.to(device))
    it = low_rank.init(EPOCHS, task.d, task.m, device=device)
    hist = {k: [] for k in ("loss", "gap", "sigma", "gamma")}
    state = task_state
    for t in range(EPOCHS):
        state, it, aux = ep(state, it, t, None)
        for k in hist:
            hist[k].append(float(getattr(aux, k)))
    return hist, low_rank.materialize(it).cpu().numpy()


def _assert_close(got, want, W, W_want, rtol=1e-4):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["gap"], want["gap"], rtol=rtol,
                               atol=1e-5 * np.max(np.abs(want["gap"])))
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=rtol)
    np.testing.assert_allclose(got["gamma"], want["gamma"], rtol=rtol, atol=1e-6)
    assert np.max(np.abs(W - W_want)) <= 1e-4 * np.max(np.abs(W_want))


@pytest.mark.parametrize("method", ["naive", "sva"])
@pytest.mark.parametrize("kind", ["mtls", "logistic", "mc"])
def test_serial_epochs_match_jax(data, kind, method):
    want, W_want = _jax_run(kind, method, data)
    got, W = _port_run(kind, method, data)
    _assert_close(got, want, W, W_want)
    assert got["loss"][-1] < got["loss"][0]


@pytest.mark.parametrize("kind", ["mtls", "logistic", "mc"])
def test_local_grad_matches_jax(data, kind):
    """The dense local gradient (the baselines' input): X^T R and X^T (P - H)
    with H subtracted at (i, y_i) (rtol 1e-5, atol 1e-6 of max|g|: sums of
    N products in two orders; MC's residuals after an update differ from the
    reference's in the last bit), at W = 0 and after three updates. MC's sum
    takes the reference scatter-add's order, entry by entry at each
    position, so on the same residual it gives the reference's bits:
    duplicate positions (the padding entries at (0, 0), ratings repeated up
    to four times) included."""
    jtask, x, y = _jax_problem(kind, data)
    ttask, _, _ = _port_problem(kind, data)
    if kind == "mc":  # repeated ratings: up to four entries at one position
        rep = np.random.default_rng(2).integers(0, x.shape[0], 300)
        x = np.concatenate([x, x[rep], x[rep[:80]], x[rep[:20]]])
        y = np.concatenate([y, y[rep] * 1.5, y[rep[:80]] * 0.25, y[rep[:20]] * 3.0])
    js = jtask.init_state(jnp.asarray(x), jnp.asarray(y))
    ts = ttask.init_state(torch.from_numpy(x), torch.from_numpy(y))
    rng = np.random.default_rng(1)
    for step in range(4):
        want, got = np.asarray(jtask.local_grad(js)), ttask.local_grad(ts).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.max(np.abs(want)))
        if kind == "mc":  # the reference's scatter-add of the port's residual: the same bits
            same = np.asarray(jtask.local_grad(js._replace(resid=jnp.asarray(ts.resid.numpy()))))
            np.testing.assert_array_equal(got.view(np.int32), same.view(np.int32))
        u = rng.standard_normal(jtask.d).astype(np.float32)
        v = rng.standard_normal(jtask.m).astype(np.float32)
        u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
        js = jtask.update(js, jnp.asarray(u), jnp.asarray(v), 0.3, MU[kind])
        ts = ttask.update(ts, torch.from_numpy(u), torch.from_numpy(v), torch.tensor(0.3),
                          MU[kind])
    if kind == "mc":  # the accumulating scatter sums in another order: to 1e-6
        g = ttask.local_grad(ts)
        plain = torch.zeros(MD, MM).index_put_((ts.rows.long(), ts.cols.long()), ts.resid,
                                               accumulate=True)
        np.testing.assert_allclose(g.numpy(), plain.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(plain.abs().max()))


def test_sign_of_the_svd_does_not_change_the_update(data, monkeypatch):
    """LAPACK and cuSOLVER may return -u, -v: NAIVE's u * sign(u^T g v)
    and SVA's _sign_fix make the epoch the same."""
    runs = {}
    for flip in (False, True):
        exact = baselines._exact_top_pair
        if flip:
            monkeypatch.setattr(baselines, "_exact_top_pair",
                                lambda g: tuple(-a if a.dim() else a for a in exact(g)))
        runs[flip] = [_port_run("mtls", method, data) for method in ("naive", "sva")]
        monkeypatch.undo()
    for (h0, w0), (h1, w1) in zip(runs[False], runs[True]):
        assert h0 == h1 and np.array_equal(w0, w1)


def test_sva_local_weight_default_is_d(data):
    """The reference weighs each worker's vectors by g_local.shape[0], which
    is d, not the worker's rows: the port keeps that. An explicit weight
    gives the same serial run (one worker: any weight normalizes away)."""
    task, x, y = _port_problem("mtls", data)
    got = []
    for weight in (None, float(D), 7.0):
        ep = baselines.make_sva_epoch_step(task, 1.0, step_size="linesearch", local_weight=weight)
        state = task.init_state(torch.from_numpy(x), torch.from_numpy(y))
        it = low_rank.init(3, D, M, device="cpu")
        for t in range(3):
            state, it, aux = ep(state, it, t, None)
        got.append(low_rank.materialize(it).numpy())
    assert np.array_equal(got[0], got[1])
    np.testing.assert_allclose(got[2], got[0], rtol=1e-5, atol=1e-7)


def test_naive_is_a_per_epoch_oracle(data):
    """The reference's own check (tests/test_frank_wolfe.py): NAIVE's loss at
    every epoch is at most 1.10 x DFW-Trace's (const:1, line search)."""
    task, x, y = _port_problem("mtls", data)
    res = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(mu=1.0, num_epochs=EPOCHS,
                                                       schedule="const:1",
                                                       step_size="linesearch"),
                         key=7, device="cpu")
    naive, _ = _port_run("mtls", "naive", data)
    assert all(a <= 1.10 * b for a, b in zip(naive["loss"], res.history["loss"]))


# ---------------------------------------------------------------------------
# Four workers: the port over gloo against the reference under shard_map
# ---------------------------------------------------------------------------

_JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_compat
from repro.core import baselines, low_rank, tasks
from repro.core.frank_wolfe import EpochAux
from repro.launch import dfw

data = dict(np.load(sys.argv[1]))
nw, epochs = int(data["nw"]), int(data["epochs"])
D, M, MD, MM = (int(data[k]) for k in ("d", "m", "md", "mm"))
mesh = dfw.data_mesh(nw)
out = {}
idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], nw, MD, m=MM)
for kind, mu, step in (("mtls", 1.0, "linesearch"), ("logistic", 10.0, "default"),
                       ("mc", 1.5, "linesearch")):
    if kind == "mtls":
        task, x, y = tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]
    elif kind == "logistic":
        task, x, y = tasks.MultinomialLogistic(D, M), data["x"], data["labels"]
    else:
        task, x, y = tasks.MatrixCompletion(MD, MM), idx, yw
    for method in ("naive", "sva"):
        make = (baselines.make_naive_epoch_step if method == "naive"
                else baselines.make_sva_epoch_step)
        ep = make(task, mu, step_size=step, axis_name="data")
        xs, ys = dfw.shard_rowwise(mesh, (jnp.asarray(x), jnp.asarray(y)))
        state = task.init_state(xs, ys)
        it = low_rank.init(epochs, task.d, task.m)
        sspec = dfw.row_specs(state, "data")
        ispec = jax.tree.map(lambda _: P(), it)
        f = jax.jit(shard_map_compat(lambda s, i, t: ep(s, i, t, None), mesh,
                                     in_specs=(sspec, ispec, P()),
                                     out_specs=(sspec, ispec, EpochAux(*[P()] * 5))))
        hist = {k: [] for k in ("loss", "gap", "sigma", "gamma")}
        for t in range(epochs):
            state, it, aux = f(state, it, jnp.float32(t))
            for k in hist:
                hist[k].append(float(getattr(aux, k)))
        for k, v in hist.items():
            out[f"{kind}/{method}/{k}"] = np.asarray(v)
        out[f"{kind}/{method}/W"] = np.asarray(low_rank.materialize(it))
np.savez(sys.argv[2], **out)
print("OK")
"""


def _workers(group, device, data):
    """One worker of the port's 4-worker baselines (module level:
    run_workers pickles it by name). Each takes its row block."""
    torch.set_num_threads(1)
    idx, yw = _mc_arrays(data, NW)
    out = {}
    for kind in ("mtls", "logistic", "mc"):
        task, x, y = _port_problem(kind, data)
        if kind == "mc":
            x, y = idx, yw
        rows = x.shape[0] // NW
        lo = group.rank * rows
        xt = torch.from_numpy(np.ascontiguousarray(x[lo:lo + rows]))
        yt = torch.from_numpy(np.ascontiguousarray(y[lo:lo + rows]))
        for method in ("naive", "sva"):
            before = group.tally.snapshot()
            hist, W = _port_run(kind, method, data, group=group,
                                task_state=task.init_state(xt, yt))
            after = group.tally.snapshot()
            out[f"{kind}/{method}"] = dict(hist=hist, W=W, bytes={
                k: after["bytes"][k] - before["bytes"][k] for k in after["bytes"]})
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("baselines")
    np.savez(tmp / "data.npz", **data, nw=NW, epochs=EPOCHS, d=D, m=M, md=MD, mm=MM)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT),
                          str(tmp / "data.npz"), str(tmp / "ref.npz")],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr[-4000:]}"
    ref = dict(np.load(tmp / "ref.npz"))
    return ref, dfw.run_workers(NW, _workers, data, device="cpu")


@pytest.mark.parametrize("method", ["naive", "sva"])
@pytest.mark.parametrize("kind", ["mtls", "logistic", "mc"])
def test_four_workers_match_jax(four, kind, method):
    ref, port = four
    got = port[0][f"{kind}/{method}"]
    want = {k: ref[f"{kind}/{method}/{k}"] for k in ("loss", "gap", "sigma", "gamma")}
    _assert_close(got["hist"], want, got["W"], ref[f"{kind}/{method}/W"],
                  rtol=1e-3 if method == "sva" else 1e-4)
    for other in port[1:]:  # every worker forms the same epoch from the same sums
        assert other[f"{kind}/{method}"]["hist"] == got["hist"]
        assert np.array_equal(other[f"{kind}/{method}"]["W"], got["W"])


@pytest.mark.parametrize("kind", ["mtls", "logistic", "mc"])
def test_four_workers_count_the_baselines_bytes(four, kind):
    """NAIVE's d x m all-reduce is its cost: 2 x 4 dm bytes an epoch, plus
    the scalar sums (2 x 2 x 4 bytes each); SVA sums two singular vectors
    and one matvec, 2 x 4 (2d + m) bytes."""
    _, port = four
    d, m = (MD, MM) if kind == "mc" else (D, M)
    scalars = (2 if STEP[kind] == "linesearch" else 1) * 2 * 2 * 4
    naive = port[0][f"{kind}/naive"]["bytes"]
    sva = port[0][f"{kind}/sva"]["bytes"]
    assert naive["all_reduce"] == EPOCHS * (2 * 4 * d * m + scalars)
    assert sva["all_reduce"] == EPOCHS * (2 * 4 * (2 * d + m) + scalars)
    assert naive["all_gather"] == sva["all_gather"] == naive["send"] == 0
