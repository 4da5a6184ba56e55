"""The port's LM training path against the JAX package, on the CPU: the data
stream, the schedules, AdamW, ``lm.loss_fn`` and its gradients,
``launch.steps.make_train_step`` and ``launch.train`` (history, resume,
checkpoints read across packages), and ``top_k_error``'s ties.

The smoke configs run in f32; parameters come from the JAX package's
``lm.init_params`` through ``convert.lm_params``, batches from each
package's own stream (which must agree bit for bit). Tolerances (f32 sums
taken in other orders by XLA, jitted or not, and by PyTorch's CPU kernels;
XLA also contracts multiply-adds under jit):

- the data stream: bit for bit;
- schedules: rtol 2e-6 (the f32 cosine of two libraries, a few ulps);
- AdamW: f32 trees rtol 1e-6 with an atol of 1e-6 of the leaf's max over 5
  steps; bf16 trees within one bf16 ulp (the same f32 value rounded);
- loss: rtol 1e-5; gradients 1e-4 of each leaf's largest |gradient|;
- train steps and ``train`` histories over 3-8 steps: loss rtol 1e-5,
  parameters 1e-4 of each leaf's max plus 1% of the learning rates summed
  over the steps: AdamW divides m by sqrt(v), so a gradient at the level of
  f32 rounding noise (a bias leaf near zero) still moves its parameter by
  up to lr a step, and its rounding shows there at that scale;
- within the port (remat, resume, checkpoints): bit for bit.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLMStream as JStream
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models.config import ShapeSpec as JShape
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import configs, convert
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models import lm as plm
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw, schedule
from repro_torch.optim.compression import tree_leaves
from repro_torch.specs import NotYetPorted

torch.set_num_threads(2)

ARCHS = ["qwen2_1_5b", "codeqwen1_5_7b", "starcoder2_7b", "rwkv6_7b"]


def _leaves_close(got, want, rel=1e-4, lr_sum=0.0):
    """Each leaf of ``got`` (port tree) within ``rel`` of its own max|want|,
    plus 1% of ``lr_sum``, the learning rates of the AdamW steps taken."""
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        g, w = g.detach().float().numpy(), w.detach().float().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), 1e-30) + 1e-2 * lr_sum)


def _model(arch, seed=0):
    cfg = jax_get_config(arch, smoke=True)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(seed))
    pcfg = configs.get_config(arch, smoke=True)
    return cfg, jp, pcfg, convert.lm_params(jax.device_get(jp), pcfg, device="cpu")


def _jax_as_port(tree, pcfg):
    return convert.lm_params(jax.device_get(tree), pcfg, device="cpu")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "rwkv6_7b", "hubert_xlarge", "qwen2_vl_72b"])
@pytest.mark.parametrize("host", [0, 1, 2, 3])
def test_stream_equals_reference_bit_for_bit(arch, host):
    """Every family branch (dense, ssm, audio, vlm), hosts 0-3 of 4."""
    cfg, pcfg = jax_get_config(arch, smoke=True), configs.get_config(arch, smoke=True)
    seq = 64 if cfg.family != "vlm" else 64 + cfg.vision_tokens
    js = JStream(cfg, JShape("t", "train", seq, 8), host_id=host, num_hosts=4)
    ps = SyntheticLMStream(pcfg, ShapeSpec("t", "train", seq, 8), host_id=host, num_hosts=4)
    for step in (0, 1, 7, 1000):
        want, got = js.batch_for_step(step), ps.batch_for_step(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (k, step)
    tensors = device_put_batch(got, "cpu")
    assert all(torch.equal(tensors[k], torch.from_numpy(got[k])) for k in got)


def test_stream_refuses_a_batch_that_does_not_split():
    pcfg = configs.get_config("qwen2_1_5b", smoke=True)
    with pytest.raises(ValueError):
        SyntheticLMStream(pcfg, ShapeSpec("t", "train", 16, 6), num_hosts=4)


# ---------------------------------------------------------------------------
# Schedules and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(100, 300), (0, 250), (10, 5)])
def test_schedules_match_reference(warmup, total):
    steps = np.arange(0, 301, dtype=np.int32)
    want = np.asarray(jschedule.cosine_with_warmup(jnp.asarray(steps), peak_lr=3e-4,
                                                   warmup=warmup, total=total))
    got = schedule.cosine_with_warmup(torch.from_numpy(steps), peak_lr=3e-4, warmup=warmup,
                                      total=total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
    one = schedule.cosine_with_warmup(torch.tensor(57, dtype=torch.int32), peak_lr=3e-4,
                                      warmup=warmup, total=total)
    assert one.dim() == 0 and float(one) == float(got[57])
    const = schedule.constant(torch.from_numpy(steps), peak_lr=3e-4)
    np.testing.assert_array_equal(const.numpy(), np.asarray(jschedule.constant(
        jnp.asarray(steps), peak_lr=3e-4)))


def _opt_tree(rng, dtype):
    shapes = {"w": (33, 17), "b": (17,), "layers": [{"x": (5, 3)}, {"x": (5, 3)}]}

    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return jax.tree.map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_five_steps(dtype, monkeypatch):
    """Also with a slice smaller than a leaf: the bits do not depend on it."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng, dtype)
    grads = [_opt_tree(rng, dtype) for _ in range(5)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def port(tree):
        return jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), tree)

    def back(tree):
        return jax.tree.map(lambda t: t.float().numpy(), tree)

    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    js = jadamw.init(jp)
    pp = port(params)
    ps = adamw.init(pp)
    for g in grads:
        lr = jschedule.cosine_with_warmup(js.step, peak_lr=1e-2, warmup=2, total=5)
        jp, js = jadamw.update(jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js, jp, lr=lr)
        plr = schedule.cosine_with_warmup(ps.step, peak_lr=1e-2, warmup=2, total=5)
        pp, ps = adamw.update(port(g), ps, pp, lr=plr)
    assert int(ps.step) == int(js.step) == 5 and ps.step.dtype == torch.int32
    for got, want in zip(jax.tree.leaves(back(pp)), jax.tree.leaves(jp)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        else:  # one bf16 ulp: 2^-7 of the value's binade
            np.testing.assert_array_less(np.abs(got - want), np.abs(want) * 2.0**-7 + 1e-30)
    for got, want in zip(jax.tree.leaves(back(ps.m)) + jax.tree.leaves(back(ps.v)),
                         jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    # the same run in slices of 7 elements gives the same bits
    monkeypatch.setattr(adamw, "SLICE", 7)
    pp2 = port(params)
    ps2 = adamw.init(pp2)
    for g in grads:
        plr = schedule.cosine_with_warmup(ps2.step, peak_lr=1e-2, warmup=2, total=5)
        pp2, ps2 = adamw.update(port(g), ps2, pp2, lr=plr)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pp2), tree_leaves(pp)))


def test_adamw_none_gradient_leaves_leaf_alone():
    params = {"a": torch.ones(3), "b": torch.ones(2)}
    st = adamw.init(params)
    params, st = adamw.update({"a": torch.ones(3), "b": None}, st, params, lr=0.1)
    assert torch.equal(params["b"], torch.ones(2)) and not st.m["b"].any() and not st.v["b"].any()
    assert not torch.equal(params["a"], torch.ones(3)) and int(st.step) == 1


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loss_chunk", [16, 24])
def test_loss_and_gradients_match_reference(arch, loss_chunk):
    """loss_chunk 16 divides S = 64, 24 does not (one chunk)."""
    cfg, jp, pcfg, pp = _model(arch)
    batch = _batch(cfg, 2, 64, seed=3)
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, cfg, loss_chunk=loss_chunk)
    (pl, pm), pg = plm.value_and_grad(pp, device_put_batch(batch, "cpu"), pcfg,
                                      loss_chunk=loss_chunk)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pm["ce"]), float(jm["ce"]), rtol=1e-5)
    assert float(pm["aux"]) == float(jm["aux"]) == 0.0
    _leaves_close(pg, _jax_as_port(jg, pcfg), rel=1e-4)
    assert all(not p.requires_grad for p in tree_leaves(pp))
    # loss_fn alone gives value_and_grad's loss
    loss, _ = plm.loss_fn(pp, device_put_batch(batch, "cpu"), pcfg, loss_chunk=loss_chunk)
    assert float(loss) == float(pl)


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "rwkv6_7b"])
def test_full_remat_gives_the_same_result(arch):
    """remat="full" (each layer checkpointed) against "none", and a
    sequence longer than seq_chunk (the chunked attention, checkpointed a
    chunk under autograd): the same loss and gradients, bit for bit."""
    _, _, pcfg, pp = _model(arch)
    batch = device_put_batch(_batch(pcfg, 2, 128, seed=4), "cpu")
    (l0, _), g0 = plm.value_and_grad(pp, batch, pcfg, loss_chunk=32)
    (l1, _), g1 = plm.value_and_grad(pp, batch, dataclasses.replace(pcfg, remat="full"),
                                     loss_chunk=32)
    assert float(l0) == float(l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    with pytest.raises(NotYetPorted):
        plm.value_and_grad(pp, batch, dataclasses.replace(pcfg, remat="dots"))


def test_chunked_attention_training_matches_reference():
    """S = 128 past seq_chunk = 64: the reference's checkpointed chunk scan."""
    cfg, jp, pcfg, pp = _model("qwen2_1_5b")
    batch = _batch(cfg, 2, 128, seed=5)
    (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, cfg, loss_chunk=64)
    (pl, _), pg = plm.value_and_grad(pp, device_put_batch(batch, "cpu"), pcfg, loss_chunk=64)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _leaves_close(pg, _jax_as_port(jg, pcfg), rel=1e-4)


# ---------------------------------------------------------------------------
# Train step and launch.train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "rwkv6_7b"])
def test_train_step_matches_reference_over_three_steps(arch):
    cfg, jp, pcfg, pp = _model(arch)
    jstep = jax.jit(jsteps.make_train_step(cfg, peak_lr=1e-3, warmup=2))
    pstep = psteps.make_train_step(pcfg, peak_lr=1e-3, warmup=2)
    jst, pst = jadamw.init(jp), adamw.init(pp)
    stream = SyntheticLMStream(pcfg, ShapeSpec("t", "train", 64, 4))
    for t in range(3):
        b = stream.batch_for_step(t)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        pp, pst, pm = pstep(pp, pst, device_put_batch(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=2e-6)
    _leaves_close(pp, _jax_as_port(jp, pcfg), rel=1e-4, lr_sum=1.5e-3)
    _leaves_close(pst.m, _jax_as_port(jst.m, pcfg), rel=1e-4)
    # the optimizer state carried across: 2 more steps from the JAX state
    got = convert.adamw_state(jax.device_get(jst), pcfg, device="cpu")
    assert int(got.step) == 3 and got.step.dtype == torch.int32
    _leaves_close(got.v, _jax_as_port(jst.v, pcfg), rel=0)


TRAIN_LR_SUM = 3e-4 * sum(range(8)) / 100  # train()'s warmup over its first 8 steps


def _train_kw(**kw):
    return dict(arch="qwen2_1_5b", steps=8, seq_len=64, global_batch=4, log_every=1,
                ckpt_every=4, **kw)


def test_train_history_and_checkpoints_match_reference(tmp_path):
    """``train`` against the reference's ``train`` from the same weights;
    the checkpoints hold the same leaf paths, and each package reads the
    other's."""
    cfg = jax_get_config("qwen2_1_5b", smoke=True)
    pcfg = configs.get_config("qwen2_1_5b", smoke=True)
    jparams, jopt, jh = jtrain.train(**_train_kw(ckpt_dir=str(tmp_path / "j")))
    p0 = _jax_as_port(jlm.init_params(cfg, jax.random.PRNGKey(0)), pcfg)
    pparams, popt, ph = ptrain.train(**_train_kw(ckpt_dir=str(tmp_path / "p")), params=p0,
                                     device="cpu")
    assert [s for s, _ in ph] == [s for s, _ in jh] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in ph], [v for _, v in jh], rtol=1e-5)
    _leaves_close(pparams, _jax_as_port(jparams, pcfg), rel=1e-4, lr_sum=TRAIN_LR_SUM)
    import json

    def paths(d):
        return [r["path"] for r in json.loads((d / "step_00000008" / "manifest.json").read_text())[
            "leaves"]]

    assert paths(tmp_path / "p") == paths(tmp_path / "j")
    # the JAX package restores the port's checkpoint
    from repro.checkpoint import CheckpointStore as JStore

    aparams = jax.eval_shape(lambda k: jlm.init_params(cfg, k), jax.random.PRNGKey(0))
    like = {"params": aparams, "opt": jax.eval_shape(jadamw.init, aparams)}
    step, tree, _ = JStore(tmp_path / "p").restore(like=like)
    assert step == 8
    _leaves_close(_jax_as_port(tree["params"], pcfg), pparams, rel=0)
    assert int(tree["opt"].step) == 8


@pytest.mark.parametrize("source", ["port", "jax"])
def test_resume_gives_the_uninterrupted_run(tmp_path, source):
    """A run resumed at step 4 from its own checkpoint gives the
    uninterrupted port run's bits; from the JAX package's step-4 checkpoint
    it continues the JAX run (its history within the tolerances)."""
    cfg = jax_get_config("qwen2_1_5b", smoke=True)
    pcfg = configs.get_config("qwen2_1_5b", smoke=True)
    p0 = _jax_as_port(jlm.init_params(cfg, jax.random.PRNGKey(0)), pcfg)
    full_p, full_o, full_h = ptrain.train(**_train_kw(ckpt_dir=str(tmp_path / "full")),
                                          params=p0, device="cpu")
    if source == "port":
        shutil.copytree(tmp_path / "full" / "step_00000004", tmp_path / "r" / "step_00000004")
    else:
        jtrain.train(**dict(_train_kw(ckpt_dir=str(tmp_path / "j")), steps=4))
        shutil.copytree(tmp_path / "j" / "step_00000004", tmp_path / "r" / "step_00000004")
    p, o, h = ptrain.train(**_train_kw(ckpt_dir=str(tmp_path / "r")), device="cpu")
    assert [s for s, _ in h] == [5, 6, 7, 8]
    if source == "port":
        assert h == full_h[4:]
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(full_p)))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o), tree_leaves(full_o)))
    else:
        np.testing.assert_allclose([v for _, v in h], [v for _, v in full_h[4:]], rtol=1e-5)
        _leaves_close(p, full_p, rel=1e-4, lr_sum=TRAIN_LR_SUM)


def test_bf16_checkpoint_from_the_reference(tmp_path):
    """A bf16 model's JAX train checkpoint (2-byte records, manifest dtype
    bfloat16) restores into bf16 tensors with the same bits, and the port's
    own bf16 checkpoint reads back the same way."""
    from repro.checkpoint import CheckpointStore as JStore

    cfg = dataclasses.replace(jax_get_config("codeqwen1_5_7b", smoke=True), dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_config("codeqwen1_5_7b", smoke=True), dtype="bfloat16")
    jp = jlm.init_params(cfg, jax.random.PRNGKey(1))
    jo = jadamw.init(jp)
    JStore(tmp_path / "j").save(3, {"params": jp, "opt": jo})
    step, params, opt = ptrain.restore(ptrain.CheckpointStore(tmp_path / "j"), pcfg,
                                       device="cpu")
    want = _jax_as_port(jp, pcfg)
    assert step == 3 and params["embed"].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(want)))
    store = ptrain.CheckpointStore(tmp_path / "p")
    store.save(3, ptrain.train_leaves(params, opt))
    import json
    man = json.loads((tmp_path / "p" / "step_00000003" / "manifest.json").read_text())
    assert {r["dtype"] for r in man["leaves"] if r["path"].startswith("params/")} == {"bfloat16"}
    _, again, _ = ptrain.restore(store, pcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(want)))


def test_a_zero_d_leaf_stays_zero_d_on_another_device():
    """AdamW's step comes back 0-d from a checkpoint on any device (the
    transfer path to a non-CPU device once made a 0-d array 1-d)."""
    from repro_torch.convert import _as

    for dev in ("cpu", "meta"):
        assert _as(np.asarray(3, np.int32), torch.int32, torch.device(dev)).shape == ()


def test_train_refuses_a_mesh_and_the_cli_runs(capsys):
    # a mesh of 8 workers needs a process group of 8 (tests/test_torch_mesh_train.py runs one)
    with pytest.raises(RuntimeError, match="not initialized"):
        ptrain.train(arch="qwen2_1_5b", steps=1, mesh_shape=(2, 4), device="cpu")
    with pytest.raises(NotYetPorted):  # a remat policy the port does not train
        ptrain.train(arch="zamba2_2_7b", steps=1, mesh_shape=(1, 1), device="cpu",
                     cfg=dataclasses.replace(configs.get_config("zamba2_2_7b", smoke=True),
                                             remat="dots"))
    ptrain.main(["--arch", "rwkv6-7b", "--steps", "2", "--seq-len", "32", "--global-batch", "2",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=    1" in out and "[train] step=    2" not in out


# ---------------------------------------------------------------------------
# top_k_error's ties
# ---------------------------------------------------------------------------


def _tie_cases():
    """(x, u, v, labels) of factored heads whose logits tie."""
    rng = np.random.default_rng(11)
    cases = []
    # ROADMAP section 3's probe: a rank-1 head whose only nonzero logit is
    # column 7, x >= 0, every label 0: column 0 is among the top 5
    d, m = 8, 40
    x = np.abs(rng.standard_normal((64, d))).astype(np.float32)
    v = np.zeros((1, m), np.float32)
    v[0, 7] = 1.0
    cases.append((x, np.ones((1, d), np.float32), v, np.zeros(64, np.int32)))
    # ties at the k-th place across rows: logits from a few integer levels
    u = rng.integers(-2, 3, (2, d)).astype(np.float32)
    v = rng.integers(-2, 3, (2, m)).astype(np.float32)
    xs = rng.integers(-1, 2, (200, d)).astype(np.float32)
    cases.append((xs, u, v, rng.integers(0, m, 200).astype(np.int32)))
    # all-zero feature rows (every logit ties at 0)
    xz = xs.copy()
    xz[::3] = 0.0
    cases.append((xz, u, v, rng.integers(0, m, 200).astype(np.int32)))
    return cases


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("k", [1, 5])
def test_top_k_error_breaks_ties_as_the_reference(case, k):
    from repro.core import dfw_head as jhead
    from repro.core import low_rank as jlr
    from repro_torch.core import dfw_head, low_rank

    x, u, v, y = _tie_cases()[case]
    r = u.shape[0]
    jit = jlr.FactoredIterate(u=jnp.asarray(u), s=jnp.ones(r), v=jnp.asarray(v),
                              alpha=jnp.float32(1.0), count=jnp.int32(r))
    want = jhead.top_k_error(jit, jnp.asarray(x), jnp.asarray(y), k=k)
    pit = low_rank.FactoredIterate(u=torch.from_numpy(u), s=torch.ones(r),
                                   v=torch.from_numpy(v), alpha=torch.tensor(1.0),
                                   count=torch.tensor(r, dtype=torch.int32))
    got = dfw_head.top_k_error(pit, torch.from_numpy(x), torch.from_numpy(y), k=k)
    assert got == want
    if case == 0:  # column 7 first, then the ties from column 0: label 0 is in the top 5
        assert want == (0.0 if k == 5 else 1.0)
    # row by row against jax.lax.top_k on the same logits
    logits = x @ (u.T @ v)
    jhit = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1] == y[:, None]).any(axis=1)
    phit = dfw_head.top_k_hits(torch.from_numpy(logits), torch.from_numpy(y), k)
    np.testing.assert_array_equal(phit.numpy(), jhit)
