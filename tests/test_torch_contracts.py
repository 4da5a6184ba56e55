"""The port's contracts (``repro_torch.analysis.contracts``) and its op
recorder (``analysis.recorder``) on the CPU, against the JAX package's
``repro.analysis.contracts``.

The declarations are the reference's: the same names and the same declared
counts. The reference checks its collective clauses against compiled HLO on
8 fake devices; the port checks the same clauses against the op log of
four gloo worker processes: K power iterations are exactly 2K all-reduces
(rank-1 and block), int8 two a exchange, top-k two all-gathers, the ring's
neighbour sends and hier's intra sum each their ``collective_counts``, and
the recorder's all-reduces agree with the group's own tally and with the
fit's per-epoch reckoning of tests/test_torch_dfw_multi.py. A scan-mode fit
makes no implicit device read and exactly ``stats["host_syncs"]`` explicit
fetches; serving's never-materialize clause passes the real scorer and
names the op of a densifying one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.comm import make_topology as jmake_topology
from repro.core import engine as jengine
from repro.core import power_method as jpm
from repro.obs import noop_contract as jnoop_contract
from repro_torch import NoiseStream
from repro_torch.analysis import contracts, recorder
from repro_torch.checkpoint import RunCheckpointer
from repro_torch.checkpoint.dfw import run_extra
from repro_torch.comm import make_topology
from repro_torch.core import engine, frank_wolfe, low_rank, power_method, tasks
from repro_torch.launch import dfw
from repro_torch.obs import Telemetry, noop_contract
from repro_torch.serve import ServeConfig, ServingEngine

torch.set_num_threads(2)

WORKERS, K, KB, N, M, D = 4, 3, 4, 256, 24, 32


def _fields(c) -> dict:
    out = dataclasses.asdict(c)
    if out.get("collective_counts") is not None:
        out["collective_counts"] = {k: float(v) for k, v in out["collective_counts"].items()}
    out["forbid_shapes"] = tuple(tuple(s) for s in out["forbid_shapes"])
    return out


CONTRACTS = {
    "rank1-K1": (lambda m: m.collective_rounds_contract(1), "pm"),
    "rank1-K3": (lambda m: m.collective_rounds_contract(3), "pm"),
    "block-K3-k4": (lambda m: m.block_collective_rounds_contract(3, 4), "pm"),
    "dispatch": (lambda m: m.dispatch_contract(), "engine"),
    "dispatch-log": (lambda m: m.dispatch_contract(segments=5, max_compilations=None), "engine"),
    "dispatch-named": (lambda m: m.dispatch_contract(name="engine.dispatch[solver=block:4:adapt]"),
                       "engine"),
    "noop": (lambda f: f(), "noop"),
}


@pytest.mark.parametrize("case", list(CONTRACTS))
def test_declared_contracts_equal_the_reference(case):
    build, owner = CONTRACTS[case]
    ref, port = {"pm": (jpm, power_method), "engine": (jengine, engine),
                 "noop": (jnoop_contract, noop_contract)}[owner]
    want, got = build(ref), build(port)
    assert {f.name for f in dataclasses.fields(got)} == {
        f.name for f in dataclasses.fields(want)}
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("spec,comm", [("flat", "dense"), ("flat", "int8"), ("ring", "dense"),
                                       ("gossip:2", "dense"), ("hier:2", "dense"),
                                       ("hier:2", "int8"), ("flat", "topk:8")])
def test_topology_contracts_equal_the_reference(spec, comm):
    want = jmake_topology(spec, num_workers=WORKERS, comm=comm).collective_contract(2 * K)
    got = make_topology(spec, num_workers=WORKERS, comm=comm).collective_contract(2 * K)
    assert _fields(got) == _fields(want)
    want = jpm.collective_rounds_contract(K, topology=jmake_topology(
        spec, num_workers=WORKERS, comm=comm))
    got = power_method.collective_rounds_contract(K, topology=make_topology(
        spec, num_workers=WORKERS, comm=comm))
    assert _fields(got) == _fields(want)


def test_serving_contract_equals_the_reference():
    from repro import serve as jserve

    want = jserve.ServingEngine(48, 36, jserve.ServeConfig(verify_kernels=False)).contract(
        max_compilations=1)
    got = ServingEngine(48, 36, ServeConfig(verify_kernels=False), device="cpu").contract(
        max_compilations=1)
    assert _fields(got) == _fields(want)
    assert got.forbid_shapes == ((48, 36), (36, 48))


# ---------------------------------------------------------------------------
# The recorder over four gloo workers
# ---------------------------------------------------------------------------

GRAPHS = [("flat", "dense"), ("flat", "int8"), ("flat", "topk:8"), ("ring", "dense"),
          ("hier:2", "dense"), ("hier:2", "int8")]
# verify_kernels off: the start-up checks' reads are not the fit's
FITS = {
    "mtls-linesearch": dict(mu=1.0, num_epochs=6, schedule="const:2", step_size="linesearch",
                            verify_kernels=False),
    "mtls-int8": dict(mu=1.0, num_epochs=5, schedule="const:3", comm="int8",
                      verify_kernels=False),
}


def _matrix(rank):
    """Worker ``rank``'s (D, M) share of the operator."""
    return torch.randn((D, M), generator=torch.Generator().manual_seed(11 + rank))


def _workers(group, device):
    """One worker: the op log of K power iterations over each graph (rank-1
    and block), with the group's tally before and after; the op log of two
    fits with telemetry on, beside their stats and comm.executable events."""
    a = _matrix(group.rank)
    out = {}
    for spec, comm in GRAPHS:
        topo = make_topology(spec, num_workers=group.size, comm=comm, group=group)
        noise = NoiseStream(5, worker=group.rank)
        for form in ("rank1", "block"):
            state = topo.init_state(D if form == "rank1" else D * KB,
                                    M if form == "rank1" else M * KB)
            before = group.tally.snapshot()["calls"]
            with recorder.OpRecorder() as rec:
                if form == "rank1":
                    power_method.power_iterations(
                        lambda v: a @ v, lambda u: a.T @ u, torch.ones(M) / M ** 0.5, K,
                        reducer=topo, comm_state=state, noise=noise)
                else:
                    power_method.block_power_iterations(
                        lambda v: a @ v, lambda u: a.T @ u,
                        torch.linalg.qr(torch.ones((M, KB)) + torch.eye(M, KB))[0], K,
                        reducer=topo, comm_state=state, noise=noise)
            after = group.tally.snapshot()["calls"]
            out[spec, comm, form] = dict(
                log=rec.analyze(), tally={k: after[k] - before[k] for k in after})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ rng.standard_normal((D, M)) / 30).astype(np.float32)
    for name, kw in FITS.items():
        tel = Telemetry()
        with recorder.OpRecorder() as rec:
            res = dfw.fit(tasks.MultiTaskLeastSquares(D, M), x, y,
                          cfg=dfw.DFWConfig(telemetry=tel, **kw), key=3, group=group,
                          device=device)
        out[name] = dict(log=rec.analyze(), stats=res.stats, ks=res.history["k"],
                         executables=[e["args"] for e in tel.events()
                                      if e["name"] == "comm.executable"])
    return out


@pytest.fixture(scope="module")
def workers():
    return dfw.run_workers(WORKERS, _workers, device="cpu")


@pytest.mark.parametrize("form", ["rank1", "block"])
@pytest.mark.parametrize("spec,comm", GRAPHS)
def test_recorder_counts_each_graphs_2k_profile(workers, spec, comm, form):
    """The op log of K iterations holds exactly the graph's collectives over
    2K exchanges (flat dense: 2K all-reduces), on every worker."""
    topo = make_topology(spec, num_workers=WORKERS, comm=comm)
    c = (power_method.collective_rounds_contract(K, topology=topo) if form == "rank1" else
         power_method.block_collective_rounds_contract(K, KB, topology=topo))
    for worker in workers:
        seen = c.check_ops(worker[spec, comm, form]["log"])
        assert seen["implicit_syncs"] == 0
    if (spec, comm) == ("flat", "dense"):
        assert c.collective_counts == {"all-reduce": 2.0 * K}


@pytest.mark.parametrize("spec,comm", GRAPHS)
def test_recorder_agrees_with_the_tally(workers, spec, comm):
    """What the dispatcher ran is what the group counted: all-reduces and
    all-gathers one for one, a neighbour send per collective-permute."""
    for worker in workers:
        got = worker[spec, comm, "rank1"]
        counts, tally = got["log"]["collective_count"], got["tally"]
        assert counts.get("all-reduce", 0.0) == tally["all_reduce"]
        assert counts.get("all-gather", 0.0) == tally["all_gather"]
        assert counts.get("collective-permute", 0.0) == tally["send"]


@pytest.mark.parametrize("name", list(FITS))
def test_recorder_counts_a_fits_all_reduces(workers, name):
    """Over a whole fit the log's all-reduces are the group's tally
    (``stats["all_reduces"]``) and tests/test_torch_dfw_multi.py's
    reckoning (per epoch one of (loss, <W, grad>), 2K exchanges of one
    all-reduce, int8 of two, one of the line-search terms; one for the final
    loss); each program's ``comm.executable`` holds its epochs' share; no
    implicit device read, and of the ``host_syncs`` counted fetches the one
    that reads on the CPU (``CPU_READING_FETCHES``)."""
    kw = FITS[name]
    per_exchange = 2 if kw.get("comm") == "int8" else 1
    linesearch = kw.get("step_size") == "linesearch"
    for worker in workers:
        got = worker[name]
        want = sum(1 + 2 * k * per_exchange + linesearch for k in got["ks"]) + 1
        assert got["log"]["collective_count"]["all-reduce"] == want == got["stats"]["all_reduces"]
        assert got["log"]["implicit_syncs"] == 0
        assert got["log"]["explicit_syncs"] == CPU_READING_FETCHES
        assert got["stats"]["host_syncs"] == 2
        k = got["ks"][0]
        assert got["executables"], "no comm.executable event"
        for ev in got["executables"]:
            assert ev["k"] == k and not ev["captured"]
            assert ev["hlo_collective_count"]["all-reduce"] == ev["length"] * (
                1 + 2 * k * per_exchange + linesearch)


# ---------------------------------------------------------------------------
# Device reads of a fit, in one process
# ---------------------------------------------------------------------------

#: Of a CPU fit's counted fetches, those the dispatcher sees read: the
#: final loss's ``float()``. A fetch of rows, flags or the carry copies
#: nothing on the CPU (they are host memory already); on the card each is
#: a copy to the host, so there every counted fetch reads (chip_smoke.py
#: phase 28 (b), (c) hold them to ``stats["host_syncs"]``).
CPU_READING_FETCHES = 1


@pytest.fixture(scope="module")
def mtls():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((400, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((D, M)).astype(np.float32))
    return x, x @ (w / torch.linalg.matrix_norm(w, "nuc"))


RUNS = {
    "const2": dict(num_epochs=30),
    "log-callback": dict(num_epochs=12, schedule="log", callback=True),
    "gap_tol": dict(num_epochs=20, schedule="const:2", gap_tol=0.0, block_epochs=4),
    "block-adapt": dict(num_epochs=12, solver="block:4:adapt"),
    "checkpoint": dict(num_epochs=12, schedule="log", checkpoint=True),
    "legacy": dict(num_epochs=6, mode="legacy"),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_scan_fit_reads_only_its_counted_fetches(mtls, case, tmp_path):
    """Under the recorder a scan-mode fit makes no implicit device read, and
    its reads all sit in its counted fetches: on the CPU the final loss's
    (a host branch's predicate, the CPU's form of an IF node, is a branch
    read), and each checkpoint's (its payload reads the carry's scalars);
    legacy's four pulls an epoch are its implicit reads."""
    kw = dict(RUNS[case])
    task = tasks.MultiTaskLeastSquares(D, M)
    if kw.pop("callback", False):
        kw["callback"] = lambda start, aux: None
    if kw.pop("checkpoint", False):
        kw["checkpointer"] = RunCheckpointer(
            tmp_path, keep_last=None, extra=run_extra(task, num_workers=1, comm="dense", num_epochs=12,
                                      schedule="log", mu=1.0, step_size="linesearch"))
    with recorder.OpRecorder() as rec:
        res = frank_wolfe.fit(task, task.init_state(*mtls), mu=1.0, key=1,
                              step_size="linesearch", device="cpu", **kw)
    if "checkpointer" in kw:
        kw["checkpointer"].wait()
    seen = rec.analyze()
    if case == "legacy":
        assert seen["implicit_syncs"] == 4 * res.epochs_run
        return
    assert seen["implicit_syncs"] == 0
    saves = len(kw["checkpointer"].store.steps()) if "checkpointer" in kw else 0
    assert case != "checkpoint" or saves > 1
    assert seen["explicit_syncs"] == CPU_READING_FETCHES + saves < res.stats["host_syncs"]
    if case in ("gap_tol", "block-adapt"):
        assert seen["branch_reads"] > 0
    else:
        assert seen["branch_reads"] == 0


def test_an_explicit_block_counts_only_if_it_reads():
    """``explicit_syncs`` counts the outermost counted blocks in which the
    dispatcher saw a device read, once however many reads or nested blocks;
    an uncounted block and a block that reads nothing add nothing."""
    t = torch.ones(3)
    with recorder.OpRecorder() as rec:
        with contracts.explicit_sync():
            t + 1  # no read
        with contracts.explicit_sync():
            float(t.sum())
            with contracts.explicit_sync():
                float(t.max())
        with contracts.explicit_sync(counted=False):
            float(t.min())
        float(t[0])  # outside any block: implicit
    seen = rec.analyze()
    assert seen["explicit_syncs"] == 1 and seen["implicit_syncs"] == 1
    assert [r.explicit for r in rec.log if r.read] == [True, True, True, False]


def test_a_recorder_does_not_import_dynamo():
    """PyTorch wraps a dispatch mode's ``__torch_dispatch__`` so that its
    first call imports ``torch._dynamo`` (seconds, once a process); the
    recorder opts out, so an enabled handle's first capture does not pay
    for it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, torch\n"
            "from repro_torch.analysis.recorder import OpRecorder\n"
            "before = 'torch._dynamo' in sys.modules\n"
            "with OpRecorder() as rec:\n"
            "    torch.ones(3) + 1\n"
            "assert len(rec.log) == 2, rec.log\n"
            "print(before, 'torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=env).stdout.split()
    assert out[0] == out[1], out


def test_scopes_are_a_shared_no_op_with_no_recorder_open():
    assert recorder.ACTIVE == []
    assert recorder.explicit() is recorder.conditional() is recorder.branch()
    with recorder.OpRecorder():
        assert isinstance(recorder.branch(), recorder._Scope)
    assert recorder.ACTIVE == []


def test_host_branch_body_is_conditional():
    flag = torch.tensor(True)
    with recorder.OpRecorder() as rec:
        torch.zeros(2)
        power_method.host_when(flag, lambda: torch.ones(3))
    assert [(r.name, r.conditional, r.branch) for r in rec.log] == [
        ("aten.zeros.default", False, False),
        ("aten._local_scalar_dense.default", False, True),
        ("aten.ones.default", True, False),
    ]


def test_dispatch_contract_holds_on_the_log(mtls):
    c = engine.dispatch_contract()
    task = tasks.MultiTaskLeastSquares(D, M)
    with recorder.OpRecorder() as rec, c.guard():
        res = frank_wolfe.fit(task, task.init_state(*mtls), mu=1.0, num_epochs=30, key=1,
                              step_size="linesearch", device="cpu")
    c.check_stats(res.stats)
    seen = c.check_ops(rec)
    assert seen["explicit_syncs"] == CPU_READING_FETCHES and res.stats["host_syncs"] == 2
    with pytest.raises(contracts.ContractViolation, match="no_host_transfers"):
        c.check_ops(lambda: float(torch.ones(2).sum()))


def test_op_clauses_name_what_broke():
    c = contracts.Contract(name="t", collective_counts={"all-reduce": 2.0},
                           max_collective_rounds=1, forbid_shapes=((3, 4),))
    log = {"collective_count": {"all-reduce": 2.0}, "shapes": {}, "implicit_syncs": 0,
           "explicit_syncs": 0}
    with pytest.raises(contracts.ContractViolation, match="max_collective_rounds"):
        c.check_ops(log)
    with pytest.raises(contracts.ContractViolation, match="collective_counts"):
        dataclasses.replace(c, max_collective_rounds=None).check_ops(
            dict(log, collective_count={"all-reduce": 3.0}))
    with pytest.raises(contracts.ContractViolation, match=r"\(3, 4\) made by aten.mm.default"):
        contracts.Contract(name="t", forbid_shapes=((3, 4),)).check_ops(
            lambda: torch.ones(3, 2) @ torch.ones(2, 4))
    with pytest.raises(TypeError, match="op log"):
        contracts.measure(3)


# ---------------------------------------------------------------------------
# Serving never materializes W
# ---------------------------------------------------------------------------


def _iterate(d, m, rank=5):
    g = torch.Generator().manual_seed(7)
    return low_rank.FactoredIterate(
        u=torch.randn((rank, d), generator=g), s=torch.randn(rank, generator=g),
        v=torch.randn((rank, m), generator=g), alpha=torch.tensor(0.9),
        count=torch.tensor(rank, dtype=torch.int32))


@pytest.mark.parametrize("transpose", [False, True])
def test_serving_scorer_passes_never_materialize(transpose):
    d, m = 48, 36
    eng = ServingEngine(d, m, ServeConfig(max_batch=8, rank_block=4, transpose=transpose,
                                          verify_kernels=False), device="cpu")
    eng.load(_iterate(d, m))
    eng.load(_iterate(d, m, rank=9))  # a second bucket
    eng.score(np.ones((3, m if transpose else d), np.float32))
    c = eng.check_contract(eng.contract(max_compilations=2))
    assert c.forbid_shapes == ((d, m), (m, d))


def test_densifying_scorer_is_caught(monkeypatch):
    from repro_torch.serve import engine as serve_engine

    def dense(x, a, s, b, alpha=1.0):
        w = (a.T * s) @ b  # the (n_in, n_out) matrix the contract forbids
        return x @ w

    monkeypatch.setattr(serve_engine.fm_ops, "factor_matvec", dense)
    eng = ServingEngine(48, 36, ServeConfig(max_batch=8, rank_block=8, verify_kernels=False),
                        device="cpu")
    eng.load(_iterate(48, 36))
    with pytest.raises(contracts.ContractViolation, match=r"\(48, 36\) made by aten.mm.default"):
        eng.check_contract()


def test_verify_declared_runs_on_the_card_unless_asked(monkeypatch):
    """With no device the engine and serving probes go to the card, as every
    entry point of the port: without CUDA the check stops before it starts
    a worker, and so does the tool run with no arguments."""
    import importlib.util
    from pathlib import Path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dfw, "run_workers", lambda *a, **k: pytest.fail("workers started"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        contracts.verify_declared(verbose=False)
    path = Path(__file__).resolve().parents[1] / "tools" / "torch_contracts.py"
    spec = importlib.util.spec_from_file_location("torch_contracts_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


def test_verify_declared_passes(capsys):
    assert contracts.verify_declared(verbose=True, device="cpu") == 0
    out = capsys.readouterr().out
    assert "all declared contracts OK" in out
    for name in ("power_method.collective_rounds[K=3]", "engine.dispatch[segments=1]",
                 "engine.dispatch[solver=block:4:adapt]", "serve.never_materialize[48x36]",
                 "obs.noop_overhead"):
        assert f"contract {name}: OK" in out

