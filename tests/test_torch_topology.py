"""The port's exchange graphs (``repro_torch.comm.topology``) and the top-k
reducer over workers against the JAX package, on the CPU.

Serial: the graph arithmetic (``gossip_lambda2``, ``default_gossip_rounds``,
``hop_wire_bytes``, ``collective_counts``, the worker-count errors) equals
the reference's, and ``fit_serial`` with ``hier:2`` + int8 and with
``ring`` matches the JAX ``fit_serial`` with the JAX run's start vectors
and noise injected.

Four workers: one JAX subprocess on 8 fake CPU devices runs the reference's
``fit`` at ``num_workers=4`` for each case (least squares with the line
search on ``ring`` (R = 5 at N = 4), ``gossip:2`` with ``gossip_rounds=3``,
``hier:2`` dense and int8, ``topk:16``, matrix completion on ``topk:16``,
and ``ring`` with a ``gap_tol`` that stops it early), saving the histories,
W, the start vectors and every worker's int8 noise; the port runs the same
cases in 4 gloo processes (``run_workers``) with those injected. The
workers also hold the hier exchange to the flat one on an integer grid,
count one epoch's bytes, and write checkpoints of a top-k and a gossip run.

Tolerances. Dense sums (hier dense, gossip, top-k) are held to the
sharded-vs-serial tolerances of tests/test_torch_dfw_multi.py: loss rtol
1e-5, gap and sigma rtol 1e-4 (gap atol 1e-5 of its max), W to 1e-5 of its
max; the int8 run to the int8 tolerance there: rtol 1e-4 on every history
(atol 1e-6 of its max) and W to 1e-4 of its max. The reference returns
worker 0's aux and iterate where the workers' part (gossip's per-node
estimates, int8 across hier groups): the port's worker 0 is compared.
"""
import json
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

from repro import comm as jcomm
from repro.comm import topology as jtopo
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.launch import dfw as jdfw
from repro_torch import NoiseStream, V0Stream, comm, specs
from repro_torch.core import low_rank, tasks
from repro_torch.launch import dfw

torch.set_num_threads(2)

SRC = str(Path(__file__).resolve().parent.parent / "src")
ROOT = str(Path(__file__).resolve().parent.parent)
NW = 4
N, D, M = 1600, 40, 30
MD, MM = 64, 48
KEY = jax.random.PRNGKey(1)

# ---------------------------------------------------------------------------
# Serial: the graph arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [2, 4, 6, 8])
def test_gossip_rounds_match_jax(degree):
    for nw in range(1, 17):
        if nw > 1 and degree >= nw:
            continue
        assert comm.gossip_lambda2(nw, degree) == jtopo.gossip_lambda2(nw, degree)
        assert comm.default_gossip_rounds(nw, degree) == jtopo.default_gossip_rounds(nw, degree)
    assert comm.default_gossip_rounds(4, 2) == 5 and comm.default_gossip_rounds(5, 4) == 1
    assert comm.CONSENSUS_TARGET == jtopo.CONSENSUS_TARGET


@pytest.mark.parametrize("spec,cm", [("flat", "dense"), ("flat", "int8"), ("flat", "topk:16"),
                                     ("ring", "dense"), ("gossip:4", "dense"),
                                     ("hier:2", "dense"), ("hier:2", "int8"),
                                     ("hier:4", "topk:16"), ("hier:8", "int8")])
def test_hop_wire_bytes_and_collectives_match_jax(spec, cm):
    tt = comm.make_topology(spec, num_workers=8, comm=cm)
    jt = jcomm.make_topology(spec, num_workers=8, comm=cm)
    assert tt.spec == jt.spec and tt.per_node == jt.per_node
    assert tt.rounds_per_exchange == jt.rounds_per_exchange
    assert tt.collective_counts(6) == jt.collective_counts(6)
    for dim in (1, 30, 256, 480_189):
        assert tt.hop_wire_bytes(dim) == jt.hop_wire_bytes(dim)
        assert tt.wire_bytes(dim, 8) == jt.wire_bytes(dim, 8)


@pytest.mark.parametrize("spec,kw", [("gossip:4", dict(num_workers=4)),
                                     ("hier:3", dict(num_workers=8)),
                                     ("ring", dict(num_workers=8, comm="int8")),
                                     ("ring", dict(num_workers=8, rounds=0))])
def test_worker_count_rules_fail_like_jax(spec, kw):
    with pytest.raises(jcomm.topology.SpecError) as want:
        jcomm.make_topology(spec, **kw)
    with pytest.raises(specs.SpecError) as got:
        comm.make_topology(spec, **kw)
    assert str(got.value) == str(want.value)


def test_serial_graphs_are_the_reference_identities():
    """One process: gossip is the identity, hier encodes at group width
    (int8's budget 127 // g), flat is its reducer."""
    x = torch.randn(33, generator=torch.Generator().manual_seed(0))
    ring = comm.make_topology("ring", num_workers=1)
    y, st = ring.exchange(x, (), slot="u")
    assert torch.equal(y, x) and st == ()
    hier = comm.make_topology("hier:4", num_workers=1, comm="int8")
    assert isinstance(hier.reducer, comm.Int8Reducer) and hier.reducer.budget == 31
    noise = torch.rand(33, generator=torch.Generator().manual_seed(1))
    y_t, _ = hier.exchange(x, (), slot="u", noise=lambda n, dev: noise)
    y_r, _ = comm.Int8Reducer(num_workers=4).exchange(x, (), slot="u",
                                                       noise=lambda n, dev: noise)
    assert torch.equal(y_t, y_r)
    assert isinstance(comm.make_topology("flat", comm="topk:3").reducer, comm.TopKReducer)


def _jax_tables(key, epochs, iters, d, m, worker=None):
    """The JAX run's start vectors and int8 noise (worker j's: folded with
    j, as fold_axis_index does)."""
    v0, nu, nv = [], [], []
    for t in range(epochs):
        ekey = jax.random.fold_in(key, t)
        v0.append(np.asarray(sphere_vector(ekey, m)))
        ckey = jax.random.fold_in(ekey, 0xC033)
        ki = [jax.random.fold_in(ckey, i) for i in range(iters)]

        def draw(k, slot, dim):
            k = jax.random.fold_in(k, slot)
            return np.asarray(jax.random.uniform(
                k if worker is None else jax.random.fold_in(k, worker), (dim,)))

        nu.append([draw(k, 0, d) for k in ki])
        nv.append([draw(k, 1, m) for k in ki])
    return np.stack(v0), np.array(nu), np.array(nv)


@pytest.fixture(scope="module")
def mtls():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


@pytest.mark.parametrize("spec,cm", [("hier:2", "int8"), ("ring", "dense"), ("hier:2", "topk:8")])
def test_fit_serial_graph_matches_jax(mtls, spec, cm):
    x, y = mtls
    kw = dict(mu=1.0, num_epochs=10, schedule="const:2", step_size="linesearch", comm=cm,
              topology=spec)
    jr = jdfw.fit_serial(jtasks.MultiTaskLeastSquares(D, M), x, y, key=KEY,
                         cfg=jdfw.DFWConfig(use_pallas=False, **kw))
    v0, nu, nv = _jax_tables(KEY, 10, 2, D, M)
    tr = dfw.fit_serial(tasks.MultiTaskLeastSquares(D, M), x, y, cfg=dfw.DFWConfig(**kw),
                        key=V0Stream.from_table(v0), noise=NoiseStream.from_tables(nu, nv),
                        device="cpu")
    assert tr.history["k"] == jr.history["k"]
    for name in ("loss", "gap", "sigma", "gamma"):
        np.testing.assert_allclose(tr.history[name], jr.history[name], rtol=1e-4,
                                   atol=1e-6 * np.max(np.abs(jr.history[name])))
    from repro.core import low_rank as jlr

    W, W_ref = low_rank.materialize(tr.iterate).numpy(), np.asarray(jlr.materialize(jr.iterate))
    assert np.max(np.abs(W - W_ref)) <= 1e-4 * np.max(np.abs(W_ref))
    if spec == "ring":  # one node is its own consensus: flat dense, bit for bit
        flat = dfw.fit_serial(tasks.MultiTaskLeastSquares(D, M), x, y,
                              cfg=dfw.DFWConfig(**dict(kw, topology="flat")),
                              key=V0Stream.from_table(v0), device="cpu")
        assert flat.history == tr.history
    # one process: hier's intra hop is gone, one round an exchange
    assert tr.stats["comm_rounds"] == 2 * 2 * 10


# ---------------------------------------------------------------------------
# Four workers against the reference's fit at num_workers=4
# ---------------------------------------------------------------------------

LS = dict(mu=1.0, num_epochs=8, schedule="const:2", step_size="linesearch")
CASES = {
    "ring": ("mtls", dict(LS, topology="ring")),
    "gossip": ("mtls", dict(LS, topology="gossip:2", gossip_rounds=3)),
    "hier-dense": ("mtls", dict(LS, topology="hier:2")),
    "hier-int8": ("mtls", dict(LS, topology="hier:2", comm="int8")),
    "topk": ("mtls", dict(LS, comm="topk:16")),
    "mc-topk": ("mc", dict(mu=1.5, num_epochs=10, schedule="const:2", step_size="linesearch",
                           comm="topk:16")),
    "ring-gap-tol": ("mtls", dict(LS, num_epochs=30, topology="ring", gap_tol=40.0)),
}

_JAX_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import tasks, low_rank
from repro.launch import dfw

data = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
key = jax.random.PRNGKey(1)
nw = int(data["nw"])
idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], nw, int(data["md"]),
                                 m=int(data["mm"]))
out = {}
for name, (kind, kw) in cases.items():
    if kind == "mc":
        task, x, y = tasks.MatrixCompletion(int(data["md"]), int(data["mm"])), idx, yw
    else:
        task, x, y = tasks.MultiTaskLeastSquares(data["x"].shape[1], data["y"].shape[1]), \\
            data["x"], data["y"]
    res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw), key=key, num_workers=nw)
    for h in ("loss", "gap", "sigma", "gamma", "k"):
        out[f"{name}/{h}"] = np.asarray(res.history[h])
    out[f"{name}/W"] = np.asarray(low_rank.materialize(res.iterate))
    out[f"{name}/final_loss"] = np.asarray(res.final_loss)
    out[f"{name}/epochs_run"] = np.asarray(res.epochs_run)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, M))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    u = np.linalg.qr(rng.standard_normal((MD, 5)))[0]
    v = np.linalg.qr(rng.standard_normal((MM, 5)))[0]
    sv = np.linspace(1.0, 0.2, 5)
    wm = (u * (sv / sv.sum())) @ v.T
    rows, cols = np.nonzero(rng.random((MD, MM)) < 0.35)
    return dict(x=x, y=y, rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                vals=wm[rows, cols].astype(np.float32), md=np.int64(MD), mm=np.int64(MM),
                nw=np.int64(NW))


def _tables(cases):
    """Every case's start vectors, and hier-int8's noise of each worker."""
    out = {}
    for name, (kind, kw) in cases.items():
        d, m = (MD, MM) if kind == "mc" else (D, M)
        out[f"{name}/v0"], _, _ = _jax_tables(KEY, kw["num_epochs"], 2, d, m)
        if kw.get("comm") == "int8":
            for j in range(NW):
                _, out[f"{name}/noise{j}u"], out[f"{name}/noise{j}v"] = _jax_tables(
                    KEY, kw["num_epochs"], 2, d, m, worker=j)
    return out


def _summary(res):
    return dict(history=res.history, W=low_rank.materialize(res.iterate).numpy(),
                final_loss=res.final_loss, epochs_run=res.epochs_run, stats=res.stats,
                comm_state={k: v.numpy() for k, v in (res.comm_state or {}).items()})


def _problem(kind, data, idx, yw):
    if kind == "mc":
        return tasks.MatrixCompletion(MD, MM), idx, yw
    return tasks.MultiTaskLeastSquares(D, M), data["x"], data["y"]


def _ranks(group, device, data, tables, ckdir):
    """One worker of the port's runs (module level: run_workers pickles it
    by name)."""
    torch.set_num_threads(1)
    idx, yw = dfw.shard_observations(data["rows"], data["cols"], data["vals"], NW, MD, m=MM)
    out = {}
    for name, (kind, kw) in CASES.items():
        task, x, y = _problem(kind, data, idx, yw)
        noise = None
        if kw.get("comm") == "int8":
            noise = NoiseStream.from_tables(tables[f"{name}/noise{group.rank}u"],
                                            tables[f"{name}/noise{group.rank}v"])
        res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw),
                      key=V0Stream.from_table(tables[f"{name}/v0"]), noise=noise, group=group,
                      device=device)
        out[name] = _summary(res)
    # checkpoints of a top-k run and of a gossip run
    for name in ("topk", "ring"):
        kind, kw = CASES[name]
        task, x, y = _problem(kind, data, idx, yw)
        res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**kw, checkpoint_dir=f"{ckdir}/{name}",
                                                     checkpoint_keep=None),
                      key=V0Stream.from_table(tables[f"{name}/v0"]), group=group, device=device)
        out[f"ckpt/{name}"] = _summary(res)
    # int8 across hier groups with gap_tol: the cross groups' gaps part, and
    # every worker must still stop at the same epoch
    kind, kw = CASES["hier-int8"]
    task, x, y = _problem(kind, data, idx, yw)
    res = dfw.fit(task, x, y, cfg=dfw.DFWConfig(**dict(kw, num_epochs=30, gap_tol=40.0)),
                  key=V0Stream.from_table(tables["ring-gap-tol/v0"]), group=group, device=device)
    out["hier-int8-gap-tol"] = _summary(res)
    # a group of one worker (every worker makes it; worker 0 runs in it):
    # gossip and hier are the serial graphs there, so fit = fit_serial, bits
    import torch.distributed as dist

    from repro_torch.comm import WorkerGroup

    one = dist.new_group([0])
    if group.rank == 0:
        for name in ("ring", "hier-int8"):
            kind, kw = CASES[name]
            task, x, y = _problem(kind, data, idx, yw)
            key = V0Stream.from_table(tables[f"{name}/v0"])
            out[f"one/{name}"] = [_summary(run(task, x, y, cfg=dfw.DFWConfig(**kw), key=key,
                                               noise=NoiseStream(3), device=device, **extra))
                                  for run, extra in ((dfw.fit, dict(group=WorkerGroup(one))),
                                                     (dfw.fit_serial, {}))]
    # hier against flat on an integer grid: every partial sum exact
    x = torch.from_numpy(np.random.default_rng(11 + group.rank).integers(
        -1000, 1000, 128).astype(np.float32))
    flat = comm.make_topology("flat", num_workers=NW, group=group)
    want, _ = flat.reducer.exchange(x.clone(), (), slot="u")
    for g in (2, 4):
        got, _ = comm.make_topology(f"hier:{g}", num_workers=NW, group=group).exchange(
            x.clone(), (), slot="u")
        out[f"hier{g}_exact"] = bool(torch.equal(got, want))
    # top-k over the workers on tied integer inputs, against the sum of the
    # serial exchanges of every worker's input
    ties = torch.from_numpy(np.random.default_rng(group.rank).integers(-3, 4, 40)
                            .astype(np.float32))
    r = comm.make_reducer("topk:8", num_workers=NW, group=group)
    got, st = r.exchange(ties, r.init_state(40, 5), slot="u")
    out["topk_ties"] = dict(total=got.numpy(), residual=st["u"].numpy())
    # one epoch's counted bytes at d = 256, m = 128, K = 2, line search
    rng = np.random.default_rng(5 + group.rank)
    xb = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    yb = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    btask = dfw.kernelize(tasks.MultiTaskLeastSquares(256, 128))
    from repro_torch.core import frank_wolfe

    for cm in ("dense", "int8", "topk:16"):
        reducer = comm.make_reducer(cm, num_workers=NW, group=group)
        ep = frank_wolfe.make_epoch_step(btask, 1.0, 2, step_size="linesearch", reducer=reducer,
                                         group=group, noise=NoiseStream(0, worker=group.rank))
        carry = frank_wolfe.init_carry(btask.init_state(xb, yb),
                                       low_rank.init(1, 256, 128, device="cpu"), 3,
                                       comm_state=reducer.init_state(256, 128))
        before = group.tally.snapshot()["bytes"]
        ep(carry)
        after = group.tally.snapshot()["bytes"]
        out[f"bytes/{cm}"] = {k: after[k] - before[k] for k in after}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("topology")
    data = _data()
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(tmp / "data.npz"),
         str(tmp / "ref.npz"), json.dumps(CASES)],
        capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr[-4000:]}"
    ref = dict(np.load(tmp / "ref.npz"))
    tables = _tables(CASES)
    port = dfw.run_workers(NW, _ranks, data, tables, str(tmp / "ckpt"), device="cpu")
    return data, ref, port, tmp / "ckpt"


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_four_workers_match_jax(runs, name):
    _, ref, port, _ = runs
    kind, kw = CASES[name]
    got = port[0][name]
    h = got["history"]
    assert h["k"] == [int(k) for k in ref[f"{name}/k"]]
    assert got["epochs_run"] == int(ref[f"{name}/epochs_run"])
    W, W_ref = got["W"], ref[f"{name}/W"]
    if kw.get("comm") == "int8":
        for key in ("loss", "gap", "sigma", "gamma"):
            _close(h[key], ref[f"{name}/{key}"], 1e-4, 1e-6 * np.max(np.abs(ref[f"{name}/{key}"])))
        assert np.max(np.abs(W - W_ref)) <= 1e-4 * np.max(np.abs(W_ref))
    else:
        _close(h["loss"], ref[f"{name}/loss"], 1e-5)
        _close(h["gap"], ref[f"{name}/gap"], 1e-4, 1e-5 * np.max(np.abs(ref[f"{name}/gap"])))
        _close(h["sigma"], ref[f"{name}/sigma"], 1e-4)
        assert np.max(np.abs(W - W_ref)) <= 1e-5 * np.max(np.abs(W_ref))
    _close(got["final_loss"], ref[f"{name}/final_loss"], 1e-5)
    for j, other in enumerate(port[1:], 1):
        # the returned iterate is worker 0's everywhere; the aux is the same
        # on every worker except across hier groups under int8, where each
        # cross group rounds with its own noise (worker 2 pairs with 0)
        assert np.array_equal(other[name]["W"], W)
        if name != "hier-int8" or j == 2:
            assert other[name]["history"] == h


def test_gossip_certifies_with_the_largest_gap_and_stops_together(runs):
    """The per-node gap is the workers' largest (as in the reference) and
    every worker stops at the epoch the reference stops at, before the last."""
    _, ref, port, _ = runs
    got = [p["ring-gap-tol"] for p in port]
    assert all(g["epochs_run"] == got[0]["epochs_run"] for g in got)
    assert got[0]["epochs_run"] < CASES["ring-gap-tol"][1]["num_epochs"]
    gaps = got[0]["history"]["gap"]
    assert gaps[-1] <= 40.0 < min(gaps[:-1])


@pytest.mark.parametrize("name", ["ring", "hier-int8"])
def test_world_size_one_graph_is_fit_serial_bit_for_bit(runs, name):
    _, _, port, _ = runs
    one, serial = port[0][f"one/{name}"]
    assert one["history"] == serial["history"] and one["final_loss"] == serial["final_loss"]
    assert np.array_equal(one["W"], serial["W"])


def test_parted_gaps_stop_every_worker_at_once(runs):
    """int8 across hier groups: the two cross groups round with their own
    noise, so their gaps part; the gap_tol verdict is their max, so all four
    workers stop at the same epoch, before the last, with worker 0's
    iterate."""
    _, _, port, _ = runs
    got = [p["hier-int8-gap-tol"] for p in port]
    assert len({g["epochs_run"] for g in got}) == 1 and got[0]["epochs_run"] < 30
    assert got[0]["history"]["gap"] != got[1]["history"]["gap"]
    assert max(g["history"]["gap"][-1] for g in got) <= 40.0
    assert all(np.array_equal(g["W"], got[0]["W"]) for g in got)


def test_gossip_iterates_part_before_the_broadcast(runs):
    """Each gossip worker ends with its own iterate: the final states'
    losses differ (R = 3 rounds leave consensus inexact), while the
    returned iterate is worker 0's on every worker."""
    _, _, port, _ = runs
    stats = [p["gossip"]["stats"] for p in port]
    assert all(s["bytes_send"] == stats[0]["bytes_send"] > 0 for s in stats)
    kw = CASES["gossip"][1]
    rounds, degree = kw["gossip_rounds"], 2
    # K = 2: 2K exchanges an epoch, each R rounds of `degree` sends of a d- or m-vector
    want = kw["num_epochs"] * 2 * rounds * degree * 4 * (D + M)
    assert stats[0]["bytes_send"] == want == stats[0]["comm_hop_bytes_neighbor"]
    assert stats[0]["comm_rounds"] == kw["num_epochs"] * 2 * 2 * rounds


def test_hier_exchange_is_exact_on_an_integer_grid(runs):
    _, _, port, _ = runs
    for p in port:
        assert p["hier2_exact"] and p["hier4_exact"]


def test_topk_over_workers_matches_the_reference_reassembly(runs):
    """The all-gathered top-k of tied integer inputs, added rank by rank,
    is the sum of the workers' serial exchanges, the reference's
    scatter-add on the flattened set, on every worker."""
    _, _, port, _ = runs
    want = np.zeros(40, np.float32)
    for j in range(NW):
        x = np.random.default_rng(j).integers(-3, 4, 40).astype(np.float32)
        sent, st = jcomm.TopKReducer(k=8).exchange(
            jnp.asarray(x), {"u": jnp.zeros(40), "v": jnp.zeros(5)}, slot="u", key=KEY)
        want = want + np.asarray(sent)
        np.testing.assert_array_equal(port[j]["topk_ties"]["residual"], np.asarray(st["u"]))
    for p in port:
        np.testing.assert_array_equal(p["topk_ties"]["total"], want)


@pytest.mark.parametrize("cm", ["dense", "int8", "topk:16"])
def test_one_epoch_counts_the_benchmarks_bytes(runs, cm):
    """One epoch's counted wire bytes (d = 256, m = 128, K = 2, line search,
    4 workers) equal benchmarks.comm_cost.expect_epoch_bytes: the 2K vector
    exchanges plus the four exact scalar sums."""
    sys.path.insert(0, ROOT)
    from benchmarks.comm_cost import expect_epoch_bytes

    _, _, port, _ = runs
    for p in port:
        got = p[f"bytes/{cm}"]
        assert got["all_reduce"] + got["all_gather"] + got["send"] == \
            expect_epoch_bytes(cm, 256, 128, 2, NW)
        assert (got["all_gather"] > 0) == cm.startswith("topk")


def test_checkpoints_restore_in_the_reference(runs):
    """A top-k run's steps hold every worker's residuals with a leading
    worker axis, and a gossip run's hold node 0's iterate; the reference's
    restore_run reads both."""
    from repro.checkpoint import restore_run
    from repro.core import low_rank as jlr

    data, _, port, ckdir = runs
    state_like = jtasks.MultiTaskLeastSquares(D, M).init_state(data["x"], data["y"])
    snap = restore_run(ckdir / "topk", state_like=state_like)
    assert snap.extra["comm"] == "topk:16" and snap.extra["num_workers"] == NW
    for slot, dim in (("u", D), ("v", M)):
        got = np.asarray(snap.carry.comm_state[slot])
        assert got.shape == (NW, dim)
        np.testing.assert_array_equal(
            got, np.stack([p["ckpt/topk"]["comm_state"][slot] for p in port]))
    assert np.any(np.asarray(snap.carry.comm_state["u"]) != 0)
    snap = restore_run(ckdir / "ring", state_like=state_like)
    assert snap.extra["topology"] == "ring" and snap.carry.comm_state == ()
    W = np.asarray(jlr.materialize(snap.unpack_iterate(CASES["ring"][1]["num_epochs"])))
    np.testing.assert_array_equal(W, port[0]["ckpt/ring"]["W"])


def test_multihost_host_topology_and_dfw_subcommand(capsys):
    """host_topology maps the host count as the reference does; the dfw
    subcommand fits its synthetic problem in one process on the CPU; the
    dry run is not ported (train and serve are: tests/test_torch_mesh_train.py)."""
    from repro.launch import multihost as jmh
    from repro_torch.launch import multihost

    for hosts in (1, 2, 8):
        assert multihost.host_topology(hosts) == jmh.host_topology(hosts)
    multihost.main(["--device", "cpu", "dfw", "--epochs", "3", "--samples", "256", "--dim",
                    "16", "--tasks", "12", "--comm", "topk:4"])
    out = capsys.readouterr().out
    assert "topology=flat comm=topk:4 epochs_run=3" in out
    with pytest.raises(specs.NotYetPorted):
        multihost.main(["--device", "cpu", "dryrun"])
