"""The port's serving path (``repro_torch.serve``, ``launch.serve``) on the
CPU against the JAX package's ``repro.serve``.

The same ``pack_live`` dict (numpy, from a seed) goes into
``repro.serve.ServingEngine`` and the port's engine; scores agree to rtol
1e-5 with an atol of 1e-6 times max|JAX score| (f32 sums in another order),
and to rtol 1e-4 / atol 1e-5 with the dense product, as tests/test_serve.py
holds the JAX engine. The tests mirror tests/test_serve.py: hot-swap pins,
bucket crossing, the micro-batcher, input validation, verify-once, the
dimension guard, ``serve_factored --follow``. A ``TorchDispatchMode``
recorder checks that no op of ``score_async`` makes a (d, m) or (m, d)
tensor.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import serve as jserve
from repro_torch import checkpoint, convert
from repro_torch import serve as pserve
from repro_torch.core.frank_wolfe import init_carry
from repro_torch.core.tasks import MTLSState
from repro_torch.kernels.factor_matvec import ops as fm_ops
from repro_torch.launch import serve as pserve_launch

torch.set_num_threads(2)

D, M = 40, 28


def _packed(k, d=D, m=M, seed=0, alpha=0.8):
    """A pack_live dict of live rank k (numpy)."""
    rng = np.random.default_rng(seed)
    return {
        "u": rng.standard_normal((k, d)).astype(np.float32),
        "s": rng.standard_normal(k).astype(np.float32),
        "v": rng.standard_normal((k, m)).astype(np.float32),
        "alpha": np.asarray(alpha, np.float32),
        "count": np.asarray(k, np.int32),
    }


def _dense(p):
    return float(p["alpha"]) * (p["u"].T * p["s"]) @ p["v"]


def _engines(max_batch=8, rank_block=8, **kw):
    """(port engine on the CPU, JAX engine) with the same config."""
    return (
        pserve.ServingEngine(D, M, pserve.ServeConfig(max_batch=max_batch,
                                                      rank_block=rank_block, **kw),
                             device="cpu"),
        jserve.ServingEngine(D, M, jserve.ServeConfig(max_batch=max_batch,
                                                      rank_block=rank_block, **kw)),
    )


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30))


def _dense_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _requests(n, dim, seed):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _checkpointer(tmpdir, d=D, m=M):
    return checkpoint.RunCheckpointer(
        tmpdir, keep_last=None,
        extra=dict(task="MultiTaskLeastSquares", d=d, m=m, num_workers=1, comm="dense"),
    )


def _save_step(ckpt, t, packed):
    it = convert.iterate(packed, max(1, int(packed["count"])), device="cpu")
    state = MTLSState(x=torch.zeros(3, 1), y=torch.zeros(3, 1), r=torch.zeros(3, 1))
    carry = init_carry(state, it, 0, t=t)
    ckpt.save_segment(t=t, carry=carry, history={k: [] for k in checkpoint.dfw.HISTORY_KEYS},
                      masks=None, done=False)
    ckpt.wait()


# ---------------------------------------------------------------------------
# Scoring: port engine = JAX engine = dense product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("live", [0, 1, 5])
def test_scores_match_jax_engine(batch, live, transpose):
    port, ref = _engines(transpose=transpose)
    p = _packed(live, seed=live)
    port.load(p)
    ref.load(p)
    x = _requests(batch, M if transpose else D, seed=7)
    got = port.score(x)
    assert got.shape == (batch, D if transpose else M) and got.dtype == np.float32
    _close(got, ref.score(x))
    w = _dense(p)
    _dense_close(got, x @ (w.T if transpose else w))


def test_single_request_vector_and_transpose():
    p = _packed(4, seed=1)
    x = _requests(1, M, seed=8)[0]
    eng = pserve.ServingEngine(D, M, pserve.ServeConfig(max_batch=4, transpose=True),
                               device="cpu")
    eng.load(p)
    got = eng.score(x)
    assert got.shape == (1, D)
    _dense_close(got[0], _dense(p) @ x)


def test_convert_packed_iterate_serves_a_jax_model():
    """The JAX package's pack_live output (device_get) loads into the port's
    engine through convert.packed_iterate and scores as the JAX engine."""
    from repro.core import low_rank as jlr

    it = jlr.unpack_live(_packed(6, seed=2), 10)
    jpacked = {k: np.asarray(v) for k, v in jlr.pack_live(it).items()}
    port, ref = _engines()
    port.load(convert.packed_iterate(jpacked))
    ref.load(jpacked)
    x = _requests(5, D, seed=9)
    _close(port.score(x), ref.score(x))
    with pytest.raises(TypeError, match="packed iterate"):
        convert.packed_iterate({"u": jpacked["u"]})


# ---------------------------------------------------------------------------
# Hot-swap pins
# ---------------------------------------------------------------------------


def test_hot_swap_keeps_in_flight_batch_on_the_old_model():
    """Swap inside one bucket while a batch is in flight: that batch scores
    the old model, later traffic the new one, one bucket prepared; the
    stats equal the JAX engine's over the same sequence."""
    old, new = _packed(3, seed=1), _packed(7, seed=2)
    x = _requests(5, D, seed=9)
    stats = []
    for eng in _engines(rank_block=8, verify_kernels=False):
        eng.load(old)
        in_flight = eng.score_async(x)
        model = eng.load(new)
        after = eng.score_async(x)
        old_scores, new_scores = in_flight.block(), after.block()
        _dense_close(old_scores, x @ _dense(old))
        _dense_close(new_scores, x @ _dense(new))
        assert in_flight.version == 0 and after.version == model.version == 1
        stats.append(eng.stats)
    assert stats[0] == stats[1] == {"compilations": 1, "dispatches": 2, "loads": 2,
                                    "requests": 10}


def test_pending_scores_holds_its_model_until_block():
    port, _ = _engines(verify_kernels=False)
    port.load(_packed(2, seed=3))
    pending = port.score_async(_requests(2, D, seed=1))
    first = port.model
    port.load(_packed(4, seed=4))
    assert pending._model is first and port.model is not first
    pending.block()
    assert pending._model is None
    assert pending.block() is pending.block()  # cached: one copy


def test_bucket_crossing_prepares_once_per_bucket():
    port, ref = _engines(rank_block=4, verify_kernels=False)
    for live, want in ((0, 1), (2, 1), (4, 1), (5, 2), (8, 2), (3, 2)):
        for eng in (port, ref):
            eng.load(_packed(live, seed=live))
            assert eng.stats["compilations"] == want, (live, eng.stats)
    assert port.stats == ref.stats and port.stats["loads"] == 6


def test_contract_pins_compilations_as_the_reference_does():
    """``contract()``/``check_contract()`` against the reference's on the same
    load sequence: both engines prepare the same buckets, hold a cap at that
    count and break one below it; the port's contract declares no host
    transfers, and a dispatch under its guard runs (a no-op off the card)."""
    port, ref = _engines(rank_block=4, verify_kernels=False)
    x = _requests(3, D, seed=5)
    for live in (0, 2, 5, 8, 3, 9):
        for eng in (port, ref):
            eng.load(_packed(live, seed=live))
            eng.score(x)
    n = ref.stats["compilations"]
    assert n == 3 and port.stats == ref.stats
    for eng in (port, ref):
        c = eng.check_contract(eng.contract(max_compilations=n))
        assert c.name == f"serve.never_materialize[{D}x{M}]"
        assert c.max_compilations == n and c.no_host_transfers
        with pytest.raises(AssertionError, match="compilations"):
            eng.check_contract(eng.contract(max_compilations=n - 1))
    assert port.check_contract().max_compilations is None
    with port.contract().guard():
        _dense_close(port.score_async(x).block(), x @ _dense(_packed(9, seed=9)))


@pytest.mark.parametrize("rank_block", [1, 3, 8, 32])
def test_rank_bucket_matches_jax(rank_block):
    for live in range(0, 70):
        assert pserve.rank_bucket(live, rank_block) == jserve.rank_bucket(live, rank_block)
    assert pserve.rank_bucket(0, 8) == 8 and pserve.rank_bucket(9, 8) == 16


class _ShapeRecorder(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("transpose", [False, True])
def test_score_async_never_materializes_dxm(transpose):
    """No op of score_async, in either direction and across two rank
    buckets, returns a (d, m) or (m, d) tensor: scoring is O(t (d + m))."""
    port, _ = _engines(max_batch=5, rank_block=4, verify_kernels=False, transpose=transpose)
    x = _requests(5, M if transpose else D, seed=4)
    for live in (3, 7):
        port.load(_packed(live, seed=live))
        with _ShapeRecorder() as rec:
            port.score_async(x)
        assert rec.shapes, "the recorder saw no op"
        assert not {(D, M), (M, D)} & set(rec.shapes), rec.shapes
    assert port.stats["compilations"] == 2


# ---------------------------------------------------------------------------
# Checkpoint restore path
# ---------------------------------------------------------------------------


def test_from_checkpoint_scores_and_follows_steps(tmp_path):
    p5, p9 = _packed(5, seed=3), _packed(9, seed=4)
    x = _requests(4, D, seed=10)
    ckpt = _checkpointer(tmp_path)
    _save_step(ckpt, 5, p5)
    eng = pserve.ServingEngine.from_checkpoint(
        tmp_path, pserve.ServeConfig(max_batch=4, rank_block=12, verify_kernels=False),
        device="cpu")
    assert (eng.d, eng.m) == (D, M)
    assert eng.model.step == 5 and eng.model.live_rank == 5
    _dense_close(eng.score(x), x @ _dense(p5))
    _save_step(ckpt, 9, p9)
    model = eng.load(tmp_path)
    assert model.step == 9 and eng.stats["compilations"] == 1
    _dense_close(eng.score(x), x @ _dense(p9))
    model = eng.load(str(tmp_path), step=5)
    assert model.step == 5 and model.version == 2


def test_engine_rejects_mismatched_checkpoint_dims(tmp_path):
    _save_step(_checkpointer(tmp_path), 3, _packed(3))
    eng = pserve.ServingEngine(D + 1, M, pserve.ServeConfig(verify_kernels=False),
                               device="cpu")
    with pytest.raises(ValueError, match="serves"):
        eng.load(tmp_path)
    eng = pserve.ServingEngine(D, M + 2, pserve.ServeConfig(verify_kernels=False),
                               device="cpu")
    with pytest.raises(ValueError, match="serves"):
        eng.load(_packed(2))


def test_serve_factored_follows_new_steps(tmp_path, monkeypatch):
    """--follow: a step written while the server sleeps is hot-swapped in."""
    ckpt = _checkpointer(tmp_path)
    _save_step(ckpt, 2, _packed(2, seed=5))
    polls = []

    def sleep(_):
        if not polls:
            _save_step(ckpt, 6, _packed(6, seed=6))
        polls.append(1)

    monkeypatch.setattr(pserve_launch.time, "sleep", sleep)
    out = pserve_launch.serve_factored(checkpoint=str(tmp_path), max_batch=4, rank_block=4,
                                       batches=2, follow=2, device="cpu")
    assert out["step"] == 6 and out["live_rank"] == 6 and out["version"] == 1
    assert out["stats"] == {"compilations": 2, "dispatches": 6, "loads": 2, "requests": 24}
    assert len(polls) == 2


def test_serve_cli_factor_and_lm(tmp_path, capsys):
    _save_step(_checkpointer(tmp_path), 3, _packed(3, seed=7))
    pserve_launch.main(["factor", "--checkpoint", str(tmp_path), "--device", "cpu",
                        "--batches", "1", "--max-batch", "2", "--transpose"])
    assert "scored 2 requests" in capsys.readouterr().out
    # the lm subcommand decodes the dense family, and the moe family since it
    # was ported (arctic: 8 experts, top-2, a dense residual MLP)
    new = pserve_launch.main(["lm", "--arch", "qwen2-1.5b", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "3", "--max-new-tokens", "2"])
    assert new.shape == (2, 2) and "generated (2, 2)" in capsys.readouterr().out
    new = pserve_launch.main(["lm", "--arch", "arctic_480b", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "3", "--max-new-tokens", "2"])
    assert new.shape == (2, 2) and "arctic_480b: generated (2, 2)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Micro-batcher
# ---------------------------------------------------------------------------


def test_microbatcher_accumulates_and_auto_flushes():
    eng, _ = _engines(verify_kernels=False)
    p = _packed(4, seed=6)
    eng.load(p)
    w = _dense(p)
    b = pserve.MicroBatcher(eng, flush_at=4)
    qs = _requests(6, D, seed=11)
    tickets = [b.submit(q) for q in qs]
    assert eng.stats["dispatches"] == 1 and b.pending_count == 2
    assert tickets[3].dispatched and not tickets[4].dispatched
    _dense_close(tickets[5].result(), qs[5] @ w)
    assert eng.stats["dispatches"] == 2 and b.pending_count == 0
    for i, t in enumerate(tickets):
        _dense_close(t.result(), qs[i] @ w)
    assert eng.stats["dispatches"] == 2


def test_microbatcher_stamps_versions_across_swap():
    eng, _ = _engines(verify_kernels=False)
    p0, p1 = _packed(2, seed=7), _packed(6, seed=8)
    eng.load(p0)
    b = pserve.MicroBatcher(eng, flush_at=8)
    q = _requests(1, D, seed=12)[0]
    before = b.submit(q)
    b.flush()
    queued = b.submit(q)
    eng.load(p1)
    with pytest.raises(RuntimeError, match="not dispatched"):
        queued.version
    b.flush()
    assert before.version == 0 and queued.version == 1
    _dense_close(before.result(), q @ _dense(p0))
    _dense_close(queued.result(), q @ _dense(p1))


# ---------------------------------------------------------------------------
# Guardrails
# ---------------------------------------------------------------------------


def test_engine_input_validation():
    eng, _ = _engines(max_batch=4, verify_kernels=False)
    with pytest.raises(RuntimeError, match="no model"):
        eng.score(np.zeros((1, D), np.float32))
    eng.load(_packed(2))
    with pytest.raises(ValueError, match="max_batch"):
        eng.score(np.zeros((5, D), np.float32))
    with pytest.raises(ValueError, match="scores"):
        eng.score(np.zeros((2, D + 1), np.float32))
    with pytest.raises(ValueError, match="missing"):
        eng.load({"u": np.zeros((1, D))})
    with pytest.raises(TypeError, match="cannot load"):
        eng.load(42)
    with pytest.raises(ValueError, match="max_batch"):
        pserve.ServeConfig(max_batch=0)
    with pytest.raises(ValueError, match="rank_block"):
        pserve.ServeConfig(rank_block=0)
    b = pserve.MicroBatcher(eng)
    with pytest.raises(ValueError, match="one"):
        b.submit(np.zeros((2, D), np.float32))
    with pytest.raises(ValueError, match="flush_at"):
        pserve.MicroBatcher(eng, flush_at=9)


def test_serve_config_rejects_unported_telemetry():
    """ServeConfig.telemetry raised NotYetPorted until the port had its
    ``obs``; it now takes a handle, which the engine records into
    (tests/test_torch_obs.py holds what it records)."""
    from repro_torch.obs import Telemetry

    tel = Telemetry()
    eng = pserve.ServingEngine(D, M, pserve.ServeConfig(max_batch=4, verify_kernels=False,
                                                        telemetry=tel), device="cpu")
    assert eng.telemetry is tel
    assert "serve.compilations" in tel.registry.snapshot()["counters"]


def test_engine_needs_cuda_unless_cpu_is_given():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pserve.ServingEngine(D, M)


def test_verify_factor_kernels_runs_on_first_load_only(monkeypatch):
    calls = []
    real = pserve.engine.verify_factor_kernels

    def counted(**kw):
        calls.append(kw)
        return real(**kw)

    monkeypatch.setattr(pserve.engine, "verify_factor_kernels", counted)
    eng, _ = _engines()
    eng.load(_packed(2, seed=9))
    eng.load(_packed(3, seed=10))
    assert eng._verified and len(calls) == 1
    assert calls[0]["d"] == D and calls[0]["m"] == M
    assert real(d=D, m=M, device="cpu") < 1e-4


def test_verify_factor_kernels_raises_on_a_wrong_route(monkeypatch):
    monkeypatch.setattr(fm_ops, "factor_matvec",
                        lambda x, a, s, b, alpha=1.0: 1.01 * fm_ops.ref.factor_matvec(x, a, s, b))
    with pytest.raises(AssertionError, match="diverges"):
        pserve.verify_factor_kernels(d=D, m=M, device="cpu")

