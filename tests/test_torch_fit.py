"""The whole slice: ``repro_torch.launch.dfw.fit_serial`` on the CPU against
``repro.launch.dfw.fit_serial`` (plain jnp path), with the JAX run's
per-epoch start vectors injected into the port.

Both packages get the same numpy data. Per-epoch loss, gap, sigma and gamma
and ``final_loss`` agree to rtol 1e-4, and the materialized iterate to 1e-4
of max|W|: the power method amplifies f32 rounding differences (sums in
another order, the fused rank-1 update's order) over the epochs, and 1e-4
is about five times what these runs show (<= 2e-5).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import low_rank as jlr
from repro.core import tasks as jtasks
from repro.core.power_method import sphere_vector
from repro.launch import dfw as jdfw
from repro_torch import V0Stream, convert
from repro_torch.core import frank_wolfe, low_rank, tasks
from repro_torch.launch import dfw

torch.set_num_threads(2)

N, D, M, RANK = 512, 48, 40, 5
KEY = jax.random.PRNGKey(1)
RTOL = 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    u = np.linalg.qr(rng.standard_normal((D, RANK)))[0]
    v = np.linalg.qr(rng.standard_normal((M, RANK)))[0]
    s = np.linspace(1.0, 0.2, RANK)
    w = (u * (s / s.sum())) @ v.T  # rank 5, trace norm 1
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ w + 0.01 * rng.standard_normal((N, M))).astype(np.float32)
    wl = rng.standard_normal((D, RANK)) @ rng.standard_normal((RANK, M))
    labels = np.argmax(x @ wl, axis=1)
    flip = rng.random(N) < 0.05
    labels[flip] = rng.integers(0, M, int(flip.sum()))
    return dict(x=x, y=y, labels=labels.astype(np.int32))


def _v0_table(epochs):
    """The JAX run's start vectors: sphere_vector(fold_in(key, t), m)."""
    return np.stack([
        np.asarray(sphere_vector(jax.random.fold_in(KEY, t), M)) for t in range(epochs)
    ])


def _close(got, want, rtol=RTOL, atol_rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.max(np.abs(want)))


def _assert_same_run(jr, tr, start=0):
    assert tr.epochs_run == jr.epochs_run
    for name in ("loss", "gap", "sigma", "gamma"):
        assert len(tr.history[name]) == len(jr.history[name]) == jr.epochs_run
        _close(tr.history[name][start:], jr.history[name][start:])
    assert tr.history["k"] == jr.history["k"]
    _close(tr.final_loss, jr.final_loss)
    # The factors are unit vectors that agree to ~1e-5 in norm, not entry by
    # entry, so W's entries are compared on W's own scale.
    _close(low_rank.materialize(tr.iterate).numpy(), jlr.materialize(jr.iterate),
           atol_rel=RTOL)


CASES = {
    "mtls-const2-linesearch": ("mtls", dict(mu=1.0, num_epochs=15, schedule="const:2",
                                            step_size="linesearch")),
    "mtls-log-default": ("mtls", dict(mu=1.0, num_epochs=15, schedule="log")),
    "mtls-log-gap_tol": ("mtls", dict(mu=1.0, num_epochs=15, schedule="log",
                                      gap_tol=85.0, block_epochs=3)),
    "logistic-log_half": ("logistic", dict(mu=10.0, num_epochs=15, schedule="log_half")),
}


def _tasks(kind):
    if kind == "mtls":
        return jtasks.MultiTaskLeastSquares(D, M), tasks.MultiTaskLeastSquares(D, M), "y"
    return jtasks.MultinomialLogistic(D, M), tasks.MultinomialLogistic(D, M), "labels"


@pytest.mark.parametrize("case", list(CASES))
def test_fit_serial_matches_jax(case, data):
    kind, kw = CASES[case]
    jtask, ttask, target = _tasks(kind)
    jcalls, tcalls = [], []
    jr = jdfw.fit_serial(
        jtask, data["x"], data[target], cfg=jdfw.DFWConfig(use_pallas=False, **kw), key=KEY,
        callback=lambda s, aux: jcalls.append((s, np.asarray(aux.gap))),
    )
    tr = dfw.fit_serial(
        ttask, data["x"], data[target], cfg=dfw.DFWConfig(**kw),
        key=V0Stream.from_table(_v0_table(kw["num_epochs"])), device="cpu",
        callback=lambda s, aux: tcalls.append((s, np.asarray(aux.gap))),
    )
    _assert_same_run(jr, tr)
    # one callback per segment, NaN rows past an early stop in both
    assert [s for s, _ in tcalls] == [s for s, _ in jcalls]
    for (_, tg), (_, jg) in zip(tcalls, jcalls):
        np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
    if "gap_tol" in kw:
        assert jr.epochs_run < kw["num_epochs"]  # the certificate did stop the run
        assert tr.history["gap"][-1] <= kw["gap_tol"] < tr.history["gap"][-2]


def test_resume_from_converted_jax_state(data):
    """JAX runs 6 epochs; the port continues from its state, iterate and
    counter (repro_torch.convert) and matches the uninterrupted JAX run."""
    kw = dict(mu=1.0, schedule="log", step_size="linesearch")
    jtask, ttask, _ = _tasks("mtls")
    full = jdfw.fit_serial(jtask, data["x"], data["y"], key=KEY,
                           cfg=jdfw.DFWConfig(num_epochs=14, use_pallas=False, **kw))
    head = jdfw.fit_serial(jtask, data["x"], data["y"], key=KEY,
                           cfg=jdfw.DFWConfig(num_epochs=6, use_pallas=False, **kw))
    tr = frank_wolfe.fit(
        dfw.kernelize(ttask),
        convert.task_state(head.state, device="cpu"),
        iterate=convert.iterate(jlr.pack_live(head.iterate), 14, device="cpu"),
        start_t=convert.epoch_counter(head.iterate.count),
        initial_history=head.history,
        num_epochs=14, key=V0Stream.from_table(_v0_table(14)), device="cpu", **kw,
    )
    _assert_same_run(full, tr, start=6)


def test_stats_count_host_syncs(data):
    """The reference engine's contract: one dispatch a segment plus the final
    loss, one program a (K, length) signature; without gap_tol or a callback
    the run waits for the device twice (the one history fetch and the final
    loss); gap_tol adds one read of its flag a segment boundary. On the CPU
    no segment is a graph replay."""
    ttask = tasks.MultiTaskLeastSquares(D, M)
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=12, schedule="log", verify_kernels=False)
    res = dfw.fit_serial(ttask, data["x"], data["y"], cfg=cfg, key=3, device="cpu")
    # the analytic comm cost of the epochs run: K(t) sums to 27 over 12 epochs
    ksum = sum(res.history["k"])
    assert ksum == 27
    assert res.stats == {"segments_planned": 3, "segments_run": 3, "dispatches": 4,
                         "compilations": 3, "graph_replays": 0,
                         "host_syncs": 2, "comm_rounds": 2 * ksum,
                         "comm_logical_bytes": 8 * (D + M) * ksum,
                         "comm_wire_bytes": 8 * (D + M) * ksum}
    cfg = dfw.DFWConfig(mu=1.0, num_epochs=12, schedule="log", gap_tol=1e-9)
    res = dfw.fit_serial(ttask, data["x"], data["y"], cfg=cfg, key=3, device="cpu")
    assert res.epochs_run == 12 and res.stats["host_syncs"] == 3 + 2
    assert all(np.isfinite(res.history["loss"]))


@pytest.mark.parametrize("kind", ["mtls", "logistic"])
def test_fit_serial_routes_through_kernel_ops(data, kind, monkeypatch):
    """Every power iteration, update matvec and task update of ``fit_serial``
    goes through the kernel wrappers (plain versions on the CPU): per power
    iteration MTLS calls 2 matvec + 2 rmatvec and logistic 1 + 1; each epoch
    adds the update's X.u (MTLS: and the line search's) and one rank-1
    update. These are the launch counts the path gives on the card."""
    from repro_torch.kernels.power_matvec import ops as pm_ops
    from repro_torch.kernels.rank1_update import ops as r1_ops

    calls = dict.fromkeys(["matvec", "rmatvec", "rank1_update", "rank1_update_axpy"], 0)

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    for mod, names in ((pm_ops, ("matvec", "rmatvec")),
                       (r1_ops, ("rank1_update", "rank1_update_axpy"))):
        for name in names:
            counted(mod, name)
    mtls = kind == "mtls"
    ttask = (tasks.MultiTaskLeastSquares if mtls else tasks.MultinomialLogistic)(D, M)
    cfg = (dfw.DFWConfig(mu=1.0, num_epochs=6, schedule="log", step_size="linesearch",
                         verify_kernels=False) if mtls else
           dfw.DFWConfig(mu=5.0, num_epochs=6, schedule="log_half", verify_kernels=False))
    res = dfw.fit_serial(ttask, data["x"], data["y" if mtls else "labels"], cfg=cfg,
                         key=3, device="cpu")
    iters, e = int(sum(res.history["k"])), res.epochs_run
    assert calls == {
        "matvec": (2 * iters + 2 * e) if mtls else (iters + e),
        "rmatvec": 2 * iters if mtls else iters,
        "rank1_update": 0 if mtls else e,
        "rank1_update_axpy": e if mtls else 0,
    }
