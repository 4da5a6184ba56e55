"""The port's LM training of the moe, hybrid, vlm and audio families against
the JAX package, on the CPU: ``lm.loss_fn`` and its gradients,
``remat="full"``, ``launch.steps.make_train_step``, ``launch.train`` (its
history, checkpoints and resume both ways), ``optim.hybrid``'s DFW-Trace
head, and the two properties the card relies on: the Mamba-2 chunk scan's
backward stays finite at a decay past -80, and the moe dispatch and combine
differentiate without a scatter-add.

The smoke configs of arctic-480b (moe: 8 experts, top-2, a dense residual
MLP), llama4-scout (moe: 4 experts, top-1), zamba2-2.7b (hybrid: 4 Mamba-2
layers and a shared attention block applied twice), qwen2-vl-72b (vlm: 16
vision embeddings ahead of the text, M-RoPE) and hubert-xlarge (audio: one
label a frame, bidirectional) run in f32. Parameters come from the JAX
package's ``lm.init_params`` through ``convert.lm_params``, batches from a
seed with numpy (or the ports' stream, which equals the reference's bit for
bit). At 2 x 64 tokens the moe capacities (40 slots an expert) bind, so
tokens are dropped in the forward and in the backward.

Tolerances (f32 sums taken in other orders by XLA, jitted or not, and by
PyTorch's CPU kernels), as tests/test_torch_train.py states them:

- loss rtol 1e-5; gradients 1e-4 of each leaf's largest |gradient|;
- train steps and ``train`` histories over 3-4 steps: loss rtol 1e-5,
  parameters 1e-4 of each leaf's max plus 1% of the learning rates summed
  over the steps (AdamW's normalized step moves a parameter whose gradient
  sits at the rounding noise by up to lr);
- the hybrid head over 8 steps as tests/test_torch_hybrid.py: loss rtol
  1e-5 at step 1 and 1e-4 after, fw_sigma rtol 1e-4, parameters 1e-3 of
  each leaf's max plus 1% of the learning rates summed;
- within the port (remat, resume): bit for bit.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.power_method import sphere_vector
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import hybrid as jhybrid
from repro_torch import V0Stream, configs, convert
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models import lm as plm
from repro_torch.models import mamba2 as pmamba
from repro_torch.models import moe as pmoe
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw, hybrid
from repro_torch.optim.compression import tree_leaves, tree_map
from repro_torch.specs import NotYetPorted

torch.set_num_threads(2)

ARCHS = ["arctic_480b", "llama4_scout_17b_a16e", "zamba2_2_7b", "qwen2_vl_72b",
         "hubert_xlarge"]
MOE = ["arctic_480b", "llama4_scout_17b_a16e"]


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


def _batch(cfg, b, s, seed):
    """A train batch of ``b`` sequences of ``s`` positions from a seed:
    tokens and labels; audio frames and labels; vlm ``vision_tokens``
    embeddings ahead of s - vision_tokens tokens, with Qwen2-VL's positions
    (the patches at (0, row, column) of a square grid, the text from the
    grid's side on in all three streams), labels for all s positions."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
                "labels": labels}
    if cfg.family != "vlm":
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                "labels": labels}
    sv = cfg.vision_tokens
    side = int(round(sv**0.5))
    grid = np.stack([np.zeros(sv, np.int64), np.arange(sv) // side, np.arange(sv) % side])
    text = np.broadcast_to(side + np.arange(s - sv), (3, s - sv))
    pos = np.broadcast_to(np.concatenate([grid, text], 1), (b, 3, s))
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - sv)).astype(np.int32),
            "vision_embeds": rng.standard_normal((b, sv, cfg.d_model)).astype(np.float32),
            "positions": np.ascontiguousarray(pos, np.int32), "labels": labels}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loss_chunk", [16, 40])
def test_loss_and_gradients_match_reference(arch, loss_chunk):
    """loss_chunk 16 divides the 64 positions (vlm: its 48 text positions),
    40 does not (one chunk, as hubert's 1,500 frames at 512). The moe
    families' aux loss is their layers' Switch losses, through autograd."""
    cfg, jp, pcfg, pp = _model(arch)
    batch = _batch(cfg, 2, 64, seed=3)
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, _jnp(batch), cfg, loss_chunk=loss_chunk)
    (pl, pm), pg = plm.value_and_grad(pp, device_put_batch(batch, "cpu"), pcfg,
                                      loss_chunk=loss_chunk)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pm["ce"]), float(jm["ce"]), rtol=1e-5)
    if cfg.family == "moe":
        assert float(jm["aux"]) > 0
        np.testing.assert_allclose(float(pm["aux"]), float(jm["aux"]), rtol=1e-5)
    else:
        assert float(pm["aux"]) == float(jm["aux"]) == 0.0
    _leaves_close(pg, _jax_as_port(jg, pcfg), rel=1e-4)
    if cfg.family == "audio":  # the token embedding is not read: zeros, as the reference's
        assert not pg["embed"].any() and not np.asarray(jg["embed"]).any()
        pg = {k: v for k, v in pg.items() if k != "embed"}
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(pg))
    assert all(not p.requires_grad for p in tree_leaves(pp))
    loss, _ = plm.loss_fn(pp, device_put_batch(batch, "cpu"), pcfg, loss_chunk=loss_chunk)
    assert float(loss) == float(pl)


def test_vlm_loss_counts_the_text_positions_only():
    """qwen2-vl's cross entropy is the mean over the text positions: labels
    at the vision positions do not move it, and it equals the plain mean of
    the text positions' -log p."""
    _, _, pcfg, pp = _model("qwen2_vl_72b")
    batch = device_put_batch(_batch(pcfg, 2, 64, seed=4), "cpu")
    sv = pcfg.vision_tokens
    loss, m = plm.loss_fn(pp, batch, pcfg)
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :sv] = (other["labels"][:, :sv] + 1) % pcfg.vocab_size
    assert float(plm.loss_fn(pp, other, pcfg)[1]["ce"]) == float(m["ce"])
    logits = plm.forward(pp, batch, pcfg)["logits"][:, sv:].double()
    nll = -torch.log_softmax(logits, -1).gather(-1, batch["labels"][:, sv:, None].long())
    np.testing.assert_allclose(float(m["ce"]), float(nll.mean()), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_remat_gives_the_same_result(arch):
    """remat="full" (each layer, and each application of zamba2's shared
    block, checkpointed) against "none", at 128 positions (past seq_chunk
    64: the chunked attention; four Mamba-2 chunks of 32): the same loss
    and gradients, bit for bit; the recomputed moe routing is the forward's."""
    cfg, _, pcfg, pp = _model(arch)
    batch = device_put_batch(_batch(cfg, 2, 128, seed=4), "cpu")
    (l0, m0), g0 = plm.value_and_grad(pp, batch, pcfg, loss_chunk=32)
    (l1, m1), g1 = plm.value_and_grad(pp, batch, dataclasses.replace(pcfg, remat="full"),
                                      loss_chunk=32)
    assert float(l0) == float(l1) and float(m0["aux"]) == float(m1["aux"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    with pytest.raises(NotYetPorted, match="dots"):
        plm.value_and_grad(pp, batch, dataclasses.replace(pcfg, remat="dots"))


def test_shared_block_gradient_sums_its_applications():
    """zamba2's shared block is one set of weights applied after every
    hybrid_block Mamba-2 layers: its gradient equals the sum of the
    gradients of untied copies, one an application."""
    _, _, pcfg, pp = _model("zamba2_2_7b")
    batch = device_put_batch(_batch(pcfg, 2, 64, seed=6), "cpu")
    _, g = plm.value_and_grad(pp, batch, pcfg)
    nb = pcfg.num_layers // pcfg.hybrid_block
    copies = [tree_map(torch.clone, pp["shared"]) for _ in range(nb)]
    calls = iter(copies)
    orig = plm._attn_mlp_block

    def untied(hh, lp, angles, cfg, **kw):
        return orig(hh, next(calls) if lp is pp["shared"] else lp, angles, cfg, **kw)

    leaves = [t for c in copies for t in tree_leaves(c)]
    for t in leaves:
        t.requires_grad_(True)
    plm._attn_mlp_block = untied
    try:
        loss, _ = plm.loss_fn(pp, batch, pcfg)
    finally:
        plm._attn_mlp_block = orig
    parts = torch.autograd.grad(loss, leaves)
    n = len(tree_leaves(pp["shared"]))
    for i, want in enumerate(tree_leaves(g["shared"])):
        per = [parts[j * n + i] for j in range(nb)]
        assert all(float(p.abs().max()) > 0 for p in per)
        torch.testing.assert_close(sum(per), want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# The two properties the card relies on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_log", [2.0, 6.0])
def test_mamba2_scan_gradient_is_finite_past_decay_minus_80(a_log):
    """Decay rates exp(a_log) of about 7 and 400 a position put the
    chunk's cumulative log decay past -80 (exp reaches f32's subnormals
    near -88 and 0 near -104), within the 32-position chunk or at its
    first positions: the mask before the exponent keeps every gradient
    finite, a_log's and dt_bias's included, and they match the
    reference's (a_log's within 1e-3 of its max, below)."""
    from repro.models import mamba2 as jmamba

    cfg = jax_get_config("zamba2_2_7b", smoke=True)
    pcfg = configs.get_config("zamba2_2_7b", smoke=True)
    p = jmamba.init_mamba(jax.random.PRNGKey(3), cfg, jnp.float32)
    p = dict(p, a_log=jnp.full_like(p["a_log"], a_log), dt_bias=jnp.full_like(p["dt_bias"], 1.0))
    x = np.random.default_rng(7).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    pp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}
    for t in pp.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        nh = pmamba.dims(pcfg)[1]
        dt = torch.nn.functional.softplus((xt @ pp["w_in"])[..., -nh:] + pp["dt_bias"])
        cum = torch.cumsum((-dt * torch.exp(pp["a_log"])).view(2, -1, pcfg.ssm_chunk, nh), 2)
    assert float(cum.min()) < -80
    out = pmamba.mamba_block(pp, xt, pcfg)
    grads = torch.autograd.grad((out * out).sum(), [xt, *pp.values()])
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    def jloss(p, x):
        o = jmamba.mamba_block(p, x, cfg)
        return jnp.sum(o * o)

    jg = jax.grad(jloss, argnums=(1, 0))(p, jnp.asarray(x))
    want = [np.asarray(jg[0])] + [np.asarray(jg[1][k]) for k in pp]
    names = ["x", *pp]
    g_alog, w_alog = grads[names.index("a_log")], want[names.index("a_log")]
    if a_log > 4:  # every decay past a position's own is exp(-400 dt): 0 in both packages
        assert not g_alog.any() and not w_alog.any()
    else:
        assert float(g_alog.abs().min()) > 0
    # a_log's gradient takes each decay as a difference of two cumulative sums
    # near -160, whose f32 ulp (1.5e-5) both packages carry into it (measured
    # 1.3e-4 of its max at a_log 2); every other leaf 1e-4
    for name, g, w in zip(names, grads, want, strict=True):
        rel = 1e-3 if name == "a_log" else 1e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30))


ACCUMULATING = ("index_add", "scatter_add", "scatter_reduce", "index_put", "_unsafe_index_put",
                "embedding_dense_backward")


@pytest.mark.parametrize("arch", MOE)
def test_moe_backward_takes_no_scatter_add(arch):
    """The backward of ``moe.moe_block`` (the dispatch and the combine, the
    router, the selection, the expert products) runs no op that adds into
    a shared place (``index_add_``, ``scatter_add``, an accumulating
    ``index_put``): on the card those are float atomics. The op log of the
    backward alone, from a ``TorchDispatchMode``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func.overloadpacket.__name__))
            if "index_put" in self.names[-1] and (kwargs or {}).get("accumulate", False):
                self.names[-1] += "(accumulate)"
            return func(*args, **(kwargs or {}))

    _, _, pcfg, pp = _model(arch)
    lp = pp["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 64, pcfg.d_model))
                         .astype(np.float32)).requires_grad_(True)
    for t in lp.values():
        t.requires_grad_(True)
    out, aux = pmoe.moe_block(lp, x, pcfg)
    loss = (out * out).sum() + aux
    ops = Ops()
    with ops:
        grads = torch.autograd.grad(loss, [x, *lp.values()])
    assert all(float(g.abs().max()) > 0 for g in grads)
    assert "index_select" in ops.names  # the gathers ran
    bad = [n for n in ops.names if any(a in n for a in ACCUMULATING)]
    assert not bad, bad
    # and it is the bits of the same backward through index_select's own
    # (an index_add_ on the CPU, in slot order)
    saved = pmoe._Dispatch.apply, pmoe._Combine.apply
    pmoe._Dispatch.apply = staticmethod(lambda x_, sel, at: x_.index_select(0, sel))
    pmoe._Combine.apply = staticmethod(
        lambda ye, at, sel, valid: torch.zeros((at.shape[0], ye.shape[1]), dtype=ye.dtype)
        .index_add(0, sel, ye))
    try:
        out2, aux2 = pmoe.moe_block(lp, x, pcfg)
        plain = torch.autograd.grad((out2 * out2).sum() + aux2, [x, *lp.values()])
    finally:
        pmoe._Dispatch.apply, pmoe._Combine.apply = saved
    for g, w in zip(grads, plain, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# Train step, launch.train, checkpoints
# ---------------------------------------------------------------------------


def _shape(cfg, s=64, b=4):
    return ShapeSpec("t", "train", s, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_over_three_steps(arch):
    cfg, jp, pcfg, pp = _model(arch)
    jstep = jax.jit(jsteps.make_train_step(cfg, peak_lr=1e-3, warmup=2))
    pstep = psteps.make_train_step(pcfg, peak_lr=1e-3, warmup=2)
    jst, pst = jadamw.init(jp), adamw.init(pp)
    stream = SyntheticLMStream(pcfg, _shape(pcfg))
    for t in range(3):
        b = stream.batch_for_step(t)
        jp, jst, jm = jstep(jp, jst, _jnp(b))
        pp, pst, pm = pstep(pp, pst, device_put_batch(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["aux"]), float(jm["aux"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=2e-6)
    _leaves_close(pp, _jax_as_port(jp, pcfg), rel=1e-4, lr_sum=1.5e-3)
    _leaves_close(pst.m, _jax_as_port(jst.m, pcfg), rel=1e-4)
    got = convert.adamw_state(jax.device_get(jst), pcfg, device="cpu")
    assert int(got.step) == 3
    _leaves_close(got.v, _jax_as_port(jst.v, pcfg), rel=0)


TRAIN_LR_SUM = 3e-4 * sum(range(4)) / 100  # train()'s warmup over its first 4 steps


def _train_kw(arch, **kw):
    return dict(arch=arch, steps=4, seq_len=64, global_batch=4, log_every=1, ckpt_every=2, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_history_and_checkpoints_match_reference(tmp_path, arch):
    """``train`` against the reference's ``train`` from the same weights;
    the checkpoints hold the same leaf paths (the expert leaves, arctic's
    residual ``mlp``, the Mamba-2 layers and the ``shared`` block,
    ``frame_proj``), and the JAX package reads the port's."""
    import json

    from repro.checkpoint import CheckpointStore as JStore

    cfg = jax_get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    jparams, _, jh = jtrain.train(**_train_kw(arch, ckpt_dir=str(tmp_path / "j")))
    p0 = _jax_as_port(jlm.init_params(cfg, jax.random.PRNGKey(0)), pcfg)
    pparams, _, ph = ptrain.train(**_train_kw(arch, ckpt_dir=str(tmp_path / "p")), params=p0,
                                  device="cpu")
    assert [s for s, _ in ph] == [s for s, _ in jh] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in ph], [v for _, v in jh], rtol=1e-5)
    _leaves_close(pparams, _jax_as_port(jparams, pcfg), rel=1e-4, lr_sum=TRAIN_LR_SUM)

    def paths(d):
        return [r["path"] for r in json.loads((d / "step_00000004" / "manifest.json").read_text())[
            "leaves"]]

    assert paths(tmp_path / "p") == paths(tmp_path / "j")
    aparams = jax.eval_shape(lambda k: jlm.init_params(cfg, k), jax.random.PRNGKey(0))
    like = {"params": aparams, "opt": jax.eval_shape(jadamw.init, aparams)}
    step, tree, _ = JStore(tmp_path / "p").restore(like=like)
    assert step == 4 and int(tree["opt"].step) == 4
    _leaves_close(_jax_as_port(tree["params"], pcfg), pparams, rel=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_gives_the_uninterrupted_run(tmp_path, arch):
    """A run resumed at step 2 from its own checkpoint gives the
    uninterrupted port run's bits (the moe backward's gathers included)."""
    cfg = jax_get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    p0 = _jax_as_port(jlm.init_params(cfg, jax.random.PRNGKey(0)), pcfg)
    full_p, full_o, full_h = ptrain.train(**_train_kw(arch, ckpt_dir=str(tmp_path / "full")),
                                          params=p0, device="cpu")
    shutil.copytree(tmp_path / "full" / "step_00000002", tmp_path / "r" / "step_00000002")
    p, o, h = ptrain.train(**_train_kw(arch, ckpt_dir=str(tmp_path / "r")), device="cpu")
    assert [s for s, _ in h] == [3, 4] and h == full_h[2:]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(full_p)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o), tree_leaves(full_o)))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, arch):
    """The JAX package's step-2 ``train`` checkpoint, resumed by the port's
    ``train``, continues the JAX run: its steps 3-4 within the tolerances."""
    _, _, jh = jtrain.train(**_train_kw(arch, ckpt_dir=str(tmp_path / "j")))
    shutil.copytree(tmp_path / "j" / "step_00000002", tmp_path / "r" / "step_00000002")
    pcfg = configs.get_config(arch, smoke=True)
    at, params, opt = ptrain.restore(ptrain.CheckpointStore(tmp_path / "r"), pcfg, device="cpu")
    assert at == 2 and int(opt.step) == 2
    assert sorted(params) == sorted(opt.m) == sorted(opt.v)
    p, o, h = ptrain.train(**_train_kw(arch, ckpt_dir=str(tmp_path / "r")), device="cpu")
    assert [s for s, _ in h] == [3, 4]
    np.testing.assert_allclose([v for _, v in h], [v for _, v in jh[2:]], rtol=1e-5)
    _, jp, jo = ptrain.restore(ptrain.CheckpointStore(tmp_path / "j"), pcfg, device="cpu")
    assert int(jo.step) == 4
    _leaves_close(p, jp, rel=1e-4, lr_sum=TRAIN_LR_SUM)
    _leaves_close(o.m, jo.m, rel=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_every_family(arch, capsys):
    ptrain.main(["--arch", arch, "--steps", "1", "--seq-len", "64", "--global-batch", "2",
                 "--device", "cpu"])
    assert "[train] step=    1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The hybrid optimizer: DFW-Trace on the head
# ---------------------------------------------------------------------------


def _v0_table(key, steps, v):
    return np.stack([np.asarray(sphere_vector(jax.random.fold_in(key, t), v))
                     for t in range(steps)])


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "qwen2_vl_72b"])
def test_hybrid_step_matches_reference_over_eight_steps(arch):
    mu, peak_lr, steps = 5.0, 1e-3, 8
    cfg, jp, pcfg, pp = _model(arch)
    key = jax.random.PRNGKey(5)
    jstep = jax.jit(jhybrid.make_hybrid_train_step(cfg, mu=mu, peak_lr=peak_lr))
    pstep = hybrid.make_hybrid_train_step(pcfg, mu=mu, peak_lr=peak_lr)
    jst, pst = jhybrid.init(jp), hybrid.init(pp)
    v0 = V0Stream.from_table(_v0_table(key, steps, cfg.vocab_size))
    stream = SyntheticLMStream(pcfg, _shape(pcfg))
    for t in range(steps):
        b = stream.batch_for_step(t)
        jp, jst, jm = jstep(jp, jst, _jnp(b), key)
        pp, pst, pm = pstep(pp, pst, device_put_batch(b, "cpu"), v0)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if t == 0 else 1e-4)
        assert float(pm["fw_gamma"]) == float(jm["fw_gamma"]) == np.float32(2) / np.float32(t + 2)
        np.testing.assert_allclose(float(pm["fw_sigma"]), float(jm["fw_sigma"]), rtol=1e-4)
        if t == 0:
            assert float(torch.linalg.svdvals(pp["unembed"]).sum()) <= mu * (1 + 1e-3)
        if t == 3:  # the hybrid state carried across: the JAX state now, the port's tree
            got = convert.hybrid_state(jax.device_get(jst), pcfg, device="cpu")
            assert got.fw_step == 4 and int(got.adam.step) == 4
            _leaves_close(got.adam.v, _jax_as_port(jst.adam.v, pcfg), rel=0)
    lr_sum = peak_lr * sum(range(steps)) / 100
    _leaves_close(pp, _jax_as_port(jp, pcfg), rel=1e-3, lr_sum=lr_sum)
    assert not pst.adam.m["unembed"].any() and not pst.adam.v["unembed"].any()
