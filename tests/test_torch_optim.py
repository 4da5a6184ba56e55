"""PowerSGD compression in the port (``repro_torch.optim.compression``)
against the JAX package's ``repro.optim.compression``, on the CPU.

- The twins of the three PowerSGD tests of tests/test_substrates.py, on the
  port alone.
- ``compress_and_sync`` against the JAX package's serial one over three
  steps, each package from the same start factors q (carried across by
  ``convert.powersgd_state``): the synced gradients and the new q and error
  within rtol 1e-5 and an atol of 1e-5 of max|reference| (f32 products in
  another order).
- Over four gloo workers (``run_workers``), the synced gradient equals the
  JAX package's serial compression of the mean gradient within the
  reference test's own rtol 1e-3 and atol 1e-4
  (tests/test_distributed.py::test_sharded_head_training_and_powersgd's
  oracle; that test stops before its comparison, at an index into a sharded
  JAX result, which this one never takes). The same spawn holds
  ``power_method_dense`` over the workers' parts A_j to the serial run on
  their sum (rtol 1e-5).
- ``wire_bytes`` equals the reference's dict; ``adamw``, ``schedule`` and
  ``hybrid`` are importable from ``repro_torch.optim`` (their parity tests
  are tests/test_torch_train.py and tests/test_torch_hybrid.py).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert, optim
from repro_torch.core import power_method
from repro_torch.launch import dfw
from repro_torch.optim import compression

torch.set_num_threads(2)

NW = 4


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# The port alone (tests/test_substrates.py's twins)
# ---------------------------------------------------------------------------


def test_powersgd_rank_improves_approximation():
    g = _normal(0, (64, 48))
    errs = []
    for rank in (1, 4, 16):
        st = compression.init({"g": g}, rank=rank, min_size=16)
        approx, _ = compression.compress_and_sync({"g": g}, st, min_size=16)
        errs.append(float(torch.linalg.norm(approx["g"] - g) / torch.linalg.norm(g)))
    assert errs[0] > errs[1] > errs[2]


def test_powersgd_error_feedback_recovers_signal():
    """The time average of the compressed updates converges to the true
    (constant) gradient, and the error-feedback buffer plateaus."""
    g = _normal(1, (32, 24))
    st = compression.init({"g": g}, rank=4, min_size=16)
    sent = torch.zeros_like(g)
    rels, errs = [], []
    for i in range(80):
        out, st = compression.compress_and_sync({"g": g}, st, min_size=16)
        sent = sent + out["g"]
        rels.append(float(torch.linalg.norm(sent / (i + 1) - g) / torch.linalg.norm(g)))
        errs.append(float(torch.linalg.norm(st.error["g"])))
    assert rels[-1] < 0.35, rels[-1]
    assert rels[-1] < rels[20] < rels[5]
    assert errs[-1] < errs[40] * 1.5


def test_powersgd_wire_bytes_table():
    params = {"big": torch.zeros((512, 256)), "small": torch.zeros((8,))}
    wb = compression.wire_bytes(params, rank=4, min_size=4096)
    assert wb["compressed"] < wb["dense"] / 10


def test_init_keeps_the_tree_and_draws_from_the_generator():
    params = {"b": torch.zeros(8), "w": [torch.zeros(64, 48), torch.zeros(4, 2, 3)]}
    gen = torch.Generator()
    gen.manual_seed(5)
    st = compression.init(params, rank=3, min_size=16, gen=gen)
    assert st.q["b"] is None and st.error["b"] is None
    assert tuple(st.q["w"][0].shape) == (48, 3) and tuple(st.error["w"][0].shape) == (64, 48)
    assert tuple(st.q["w"][1].shape) == (6, 3)  # a 3-D leaf is compressed as (4, 6)
    gen.manual_seed(5)
    assert torch.equal(st.q["w"][0], torch.randn((48, 3), generator=gen))
    out, new = compression.compress_and_sync(params, st, min_size=16)
    assert tuple(out["w"][1].shape) == (4, 2, 3) and out["b"] is params["b"]


def test_unported_optimizers_raise():
    """adamw, schedule and hybrid raised NotYetPorted until LM training was
    ported; now every optimizer of the reference's package is there, and a
    name it does not have is an AttributeError."""
    from repro_torch.optim import adamw, hybrid, schedule

    assert optim.PowerSGDState is compression.PowerSGDState
    assert (optim.adamw, optim.schedule, optim.hybrid) == (adamw, schedule, hybrid)
    assert optim.AdamWState is adamw.AdamWState
    with pytest.raises(AttributeError):
        optim.lion  # noqa: B018


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _grads(seed):
    return {"w": np.random.default_rng(seed).standard_normal((64, 48)).astype(np.float32),
            "b": np.random.default_rng(seed + 1).standard_normal(8).astype(np.float32)}


@pytest.fixture(scope="module")
def jc():
    import jax

    from repro.optim import compression as jcomp

    return jax, jcomp


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_compress_and_sync_matches_jax(jc):
    jax, jcomp = jc
    params = {"w": np.zeros((64, 48), np.float32), "b": np.zeros(8, np.float32)}
    jst = jcomp.init({k: jax.numpy.asarray(v) for k, v in params.items()}, rank=8, min_size=16)
    pst = convert.powersgd_state(jax.device_get(jst), device="cpu")
    assert pst.q["b"] is None and pst.error["b"] is None
    for step in range(3):
        g = _grads(10 + step)
        jout, jst = jcomp.compress_and_sync({k: jax.numpy.asarray(v) for k, v in g.items()}, jst,
                                            min_size=16)
        pout, pst = compression.compress_and_sync(_torch_tree(g), pst, min_size=16)
        for k in ("w", "b"):
            _close(pout[k], jout[k])
        _close(pst.q["w"], jst.q["w"])
        _close(pst.error["w"], jst.error["w"])


def test_wire_bytes_equal_the_reference(jc):
    jax, jcomp = jc
    shapes = {"big": (512, 256), "small": (8,), "mid": (64, 72), "cube": (16, 8, 40)}
    for rank, min_size in ((4, 4096), (8, 16)):
        want = jcomp.wire_bytes({k: jax.numpy.zeros(s) for k, s in shapes.items()}, rank=rank,
                                min_size=min_size)
        got = compression.wire_bytes({k: torch.zeros(s) for k, s in shapes.items()}, rank=rank,
                                     min_size=min_size)
        assert got == want


def _workers(group, device, shards, small, q, a):
    """One worker (module level: run_workers starts it by name): its shard of
    the gradients compressed and synced over the group from the reference's
    start q, and the power method on the sum of the workers' parts a[j]."""
    torch.set_num_threads(1)
    j = group.rank
    st = compression.PowerSGDState(q={"b": None, "w": torch.from_numpy(q)},
                                   error={"b": None, "w": torch.zeros(shards.shape[1:])})
    out, new = compression.compress_and_sync(
        {"w": torch.from_numpy(shards[j]), "b": torch.from_numpy(small[j])}, st, min_size=16,
        group=group)
    v0 = torch.ones(a.shape[2]) / a.shape[2] ** 0.5
    pm = power_method.power_method_dense(torch.from_numpy(a[j]), v0, 20, group=group)
    return dict(w=out["w"].numpy(), b=out["b"].numpy(), q=new.q["w"].numpy(),
                pm=[t.numpy() for t in pm])


@pytest.fixture(scope="module")
def multi(jc):
    jax, jcomp = jc
    rng = np.random.default_rng(20)
    shards = rng.standard_normal((NW, 64, 48)).astype(np.float32)
    small = rng.standard_normal((NW, 8)).astype(np.float32)
    a = rng.standard_normal((NW, 30, 24)).astype(np.float32)
    jst = jcomp.init({"w": jax.numpy.zeros((64, 48))}, rank=8, min_size=16)
    q = np.array(jst.q["w"])
    out = dfw.run_workers(NW, _workers, shards, small, q, a, device="cpu")
    serial, _ = jcomp.compress_and_sync({"w": jax.numpy.asarray(shards.mean(axis=0))}, jst,
                                        min_size=16)
    return dict(out=out, serial=np.asarray(serial["w"]), small=small, a=a)


def test_distributed_compression_equals_the_mean_gradient_s(multi):
    """Four workers' synced gradient = the JAX serial compression of the mean
    gradient (rtol 1e-3, atol 1e-4, the reference test's oracle); the small
    leaf is the exact mean; every worker holds the same bits."""
    first = multi["out"][0]
    np.testing.assert_allclose(first["w"], multi["serial"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(first["b"], multi["small"].mean(axis=0), rtol=1e-6, atol=1e-7)
    for worker in multi["out"][1:]:
        for k in ("w", "b", "q"):
            np.testing.assert_array_equal(worker[k], first[k])


def test_power_method_dense_over_workers(multi):
    """Each worker's part A_j summed over the group: the serial run on sum A_j."""
    a = torch.from_numpy(multi["a"].sum(axis=0))
    want = power_method.power_method_dense(a, torch.ones(a.shape[1]) / a.shape[1] ** 0.5, 20)
    for worker in multi["out"]:
        for got, w in zip(worker["pm"], want):
            _close(got, w.numpy())
