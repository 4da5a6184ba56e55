"""The port's dense-LM serving slice against the JAX package, on the CPU.

The four dense smoke configs (qwen2-1.5b, qwen2.5-14b, codeqwen1.5-7b,
starcoder2-7b) run in f32. Parameters come from the JAX package's
``lm.init_params`` and are carried across by ``convert.lm_params``; inputs
are numpy arrays from a seed (or the JAX run's own token draws). On the CPU
the port's attention takes the reference's own off-TPU branches (dense, or
chunked past ``seq_chunk``), so both packages run the same arithmetic.

Tolerances (f32 sums taken in another order by XLA and by PyTorch's CPU
kernels): single layers rtol 1e-5 with an atol of 1e-5 times
max|reference|; whole forwards, decode sequences and caches 1e-4 of
max|reference| (two layers, rounding compounds). Greedy tokens must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import config as jconfig
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs, convert, kernels
from repro_torch.launch import serve as pserve
from repro_torch.launch import steps as psteps
from repro_torch.models import config as pconfig
from repro_torch.models import layers as PL
from repro_torch.models import lm as plm
from repro_torch.specs import NotYetPorted

torch.set_num_threads(2)

DENSE = ["qwen2_1_5b", "qwen2_5_14b", "codeqwen1_5_7b", "starcoder2_7b"]
MOE = ["arctic_480b", "llama4_scout_17b_a16e"]
SERVED = ["qwen2_vl_72b", "hubert_xlarge", "zamba2_2_7b"]  # served before they trained


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _model(arch, seed=0):
    """(cfg, JAX params, the port's params from them, port cfg)."""
    cfg = jax_get_config(arch, smoke=True)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(seed))
    pcfg = configs.get_config(arch, smoke=True)
    return cfg, jp, convert.lm_params(jax.device_get(jp), pcfg, device="cpu"), pcfg


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_config_registry_matches_jax(smoke):
    from repro.configs import ARCH_IDS, ALIASES

    assert configs.ARCH_IDS == ARCH_IDS and configs.ALIASES == ALIASES
    for arch in ARCH_IDS:
        want, got = jax_get_config(arch, smoke), configs.get_config(arch, smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert got.head_dim_ == want.head_dim_ and got.encoder_only == want.encoder_only
        assert set(pconfig.applicable_shapes(got)) == set(jconfig.applicable_shapes(want))
    assert {k: dataclasses.asdict(v) for k, v in pconfig.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.LM_SHAPES.items()}
    assert configs.get_config("qwen2-1.5b").torch_dtype == torch.bfloat16
    with pytest.raises(KeyError):
        configs.get_config("nope")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    _close(PL.rms_norm(_t(x), _t(scale), 1e-5), JL.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                                           1e-5))
    pos = np.tile(np.arange(9, dtype=np.int32)[None] * 37, (2, 1))
    for theta in (1e4, 1e5, 1e6):
        ang_p = PL.rope_angles(_t(pos), 16, theta)
        ang_j = JL.rope_angles(jnp.asarray(pos), 16, theta)
        _close(ang_p, ang_j)
        h = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
        _close(PL.apply_rope(_t(h), ang_p), JL.apply_rope(jnp.asarray(h), ang_j))


@pytest.mark.parametrize("sq,causal", [(40, True), (40, False), (128, True), (128, False)])
def test_attention_branches_match_jax(sq, causal):
    """sq 40: the dense branch; sq 128 > chunk 64: the chunked branch."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, 4, sq, 12)).astype(np.float32)
    k = rng.standard_normal((2, 2, sq, 12)).astype(np.float32)
    v = rng.standard_normal((2, 2, sq, 12)).astype(np.float32)
    got = PL.attention(_t(q), _t(k), _t(v), scale=0.3, causal=causal, chunk=64)
    want = JL.attention(*map(jnp.asarray, (q, k, v)), scale=0.3, causal=causal, chunk=64,
                        use_pallas=False)
    _close(got, want)
    dense = PL._dense_attention(_t(q), _t(k), _t(v), scale=0.3, causal=causal)
    if sq == 128:
        chunked = PL._chunked_attention(_t(q), _t(k), _t(v), scale=0.3, causal=causal, chunk=64)
        _close(chunked, dense)


@pytest.mark.parametrize("arch", DENSE)
def test_attention_block_matches_jax(arch):
    cfg, jp, pp, pcfg = _model(arch, seed=2)
    rng = np.random.default_rng(3)
    b, s = 2, 10
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s)[None], (b, 1))
    ang_j = JL.rope_angles(jnp.asarray(pos), cfg.head_dim_, cfg.rope_theta)
    ang_p = PL.rope_angles(_t(pos), cfg.head_dim_, cfg.rope_theta)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    pattn = pp["layers"][0]["attn"]
    # no cache (prefill: the layer's k, v come back as the cache)
    jout, jkv = jax.jit(lambda p_, x_, a_: JL.attention_block(p_, x_, cfg, angles=a_,
                                                                return_kv=True))(
        jattn, jnp.asarray(x), ang_j)
    pout, pkv = PL.attention_block(pattn, _t(x), pcfg, angles=ang_p, return_kv=True)
    _close(pout, jout)
    _close(pkv[0], jkv[0])
    _close(pkv[1], jkv[1])
    # one token against a cache of 12 slots holding positions 0..s-1
    smax = 12
    jcache = tuple(jnp.pad(a, ((0, 0), (0, 0), (0, smax - s), (0, 0))) for a in jkv)
    pcache = tuple(torch.nn.functional.pad(a, (0, 0, 0, smax - s)).contiguous() for a in pkv)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    a1j = JL.rope_angles(jnp.full((b, 1), s), cfg.head_dim_, cfg.rope_theta)
    a1p = PL.rope_angles(torch.full((b, 1), s), cfg.head_dim_, cfg.rope_theta)
    jout1, (jk, jv) = jax.jit(lambda p_, x_, a_, c_: JL.attention_block(
        p_, x_, cfg, angles=a_, cache=c_, cache_pos=jnp.int32(s)))(jattn, jnp.asarray(x1), a1j,
                                                                   jcache)
    pout1, (pk, pv) = PL.attention_block(pattn, _t(x1), pcfg, angles=a1p, cache=pcache,
                                         cache_pos=s)
    _close(pout1, jout1)
    _close(pk, jk)
    _close(pv, jv)
    assert pk is pcache[0]  # written in place


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_block_matches_jax(kind):
    arch = "qwen2_1_5b" if kind == "swiglu" else "starcoder2_7b"
    cfg, jp, pp, _ = _model(arch, seed=4)
    assert cfg.mlp_type == kind
    x = np.random.default_rng(5).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jmlp = jax.tree.map(lambda a: a[1], jp["layers"]["mlp"])
    _close(PL.mlp_block(pp["layers"][1]["mlp"], _t(x), kind),
           JL.mlp_block(jmlp, jnp.asarray(x), kind))


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("mode", ["train", "prefill", "hidden"])
def test_forward_matches_jax(arch, mode):
    cfg, jp, pp, pcfg = _model(arch, seed=6)
    toks = _tokens(cfg, 2, 24, seed=7)
    jout = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, mode=mode)
    pout = plm.forward(pp, {"tokens": _t(toks)}, pcfg, mode=mode)
    assert set(pout) == set(jout)
    _close(pout["hidden"], jout["hidden"], atol_rel=1e-4)
    if mode != "hidden":
        _close(pout["logits"], jout["logits"], atol_rel=1e-4)
    if mode == "prefill":
        for name in ("k", "v"):
            assert tuple(pout["cache"][name].shape) == jout["cache"][name].shape
            _close(pout["cache"][name], jout["cache"][name], atol_rel=1e-4)


def test_forward_chunked_prefill_matches_jax():
    """s = 128 > seq_chunk 64: both packages take the chunked branch."""
    cfg, jp, pp, pcfg = _model("qwen2_5_14b", seed=8)
    toks = _tokens(cfg, 1, 128, seed=9)
    jout = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, mode="prefill")
    pout = plm.forward(pp, {"tokens": _t(toks)}, pcfg, mode="prefill")
    _close(pout["logits"], jout["logits"], atol_rel=1e-4)
    _close(pout["cache"]["k"], jout["cache"]["k"], atol_rel=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_sequence_matches_jax(arch):
    cfg, jp, pp, pcfg = _model(arch, seed=10)
    b, s = 2, 12
    toks = _tokens(cfg, b, s, seed=11)
    jcache = jlm.init_cache(cfg, b, s)
    pcache = plm.init_cache(pcfg, b, s, device="cpu")
    assert {k: tuple(v.shape) for k, v in pcache.items()} == {
        k: v.shape for k, v in jcache.items()}
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    pstep = psteps.make_serve_step(pcfg)
    for t in range(s):
        jl, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
        pl, pcache2 = pstep(pp, pcache, {"tokens": _t(toks[:, t:t + 1]), "cache_pos": t})
        assert pcache2 is pcache  # updated in place
        _close(pl, jl, atol_rel=1e-4)
    _close(pcache["k"], jcache["k"], atol_rel=1e-4)
    _close(pcache["v"], jcache["v"], atol_rel=1e-4)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "starcoder2_7b"])
def test_decode_step_with_a_tensor_position_matches_jax(arch):
    """``cache_pos`` as a 0-d int64 tensor, as the reference's traced
    ``jnp.int32(t)``: at every position the logits and the caches against
    the JAX ``decode_step``; the int form gives the same bits, and the step
    leaves the position as it was."""
    cfg, jp, pp, pcfg = _model(arch, seed=12)
    b, s = 2, 10
    toks = _tokens(cfg, b, s, seed=13)
    jcache = jlm.init_cache(cfg, b, s)
    pcache = plm.init_cache(pcfg, b, s, device="cpu")
    icache = plm.init_cache(pcfg, b, s, device="cpu")
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    for t in range(s):
        jl, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
        pos = torch.tensor(t)
        pl, _ = plm.decode_step(pp, pcache, {"tokens": _t(toks[:, t:t + 1]), "cache_pos": pos},
                                pcfg)
        il, _ = plm.decode_step(pp, icache, {"tokens": _t(toks[:, t:t + 1]), "cache_pos": t},
                                pcfg)
        assert pos.dim() == 0 and int(pos) == t
        _close(pl, jl, atol_rel=1e-4)
        assert torch.equal(pl, il)
        for name in ("k", "v"):
            _close(pcache[name], jcache[name], atol_rel=1e-4)
            assert torch.equal(pcache[name], icache[name])
    for bad in (torch.tensor([1]), torch.tensor(1.0), 1.5):
        with pytest.raises(TypeError, match="cache_pos"):
            plm.decode_step(pp, pcache, {"tokens": _t(toks[:, :1]), "cache_pos": bad}, pcfg)


def test_generate_fills_the_given_cache_as_the_step_loop_does():
    """On the CPU ``generate`` runs its step uncaptured: its tokens and the
    cache it was given equal a plain loop of the serve step's, bit for bit
    (the loop the card's captured run is held to); no capture, no replay."""
    arch, batch, plen, new = "qwen2_1_5b", 2, 4, 5
    pcfg = configs.get_config(arch, smoke=True)
    params = plm.init_params(pcfg, 3, device="cpu")
    prompt = _tokens(pcfg, batch, plen, seed=14).astype(np.int64)
    cache = plm.init_cache(pcfg, batch, plen + new, device="cpu")
    stats = {}
    got = pserve.generate(arch=arch, batch=batch, prompt_len=plen, max_new_tokens=new,
                          device="cpu", params=params, prompt=prompt, cache=cache, stats=stats)
    want_cache = plm.init_cache(pcfg, batch, plen + new, device="cpu")
    step, toks = psteps.make_serve_step(pcfg), []
    for t in range(plen + new - 1):
        cur = _t(prompt[:, t:t + 1]) if t < plen else toks[-1]
        logits, _ = step(params, want_cache, {"tokens": cur, "cache_pos": t})
        if t >= plen - 1:
            toks.append(torch.argmax(logits[:, 0, :].float(), dim=-1, keepdim=True))
    np.testing.assert_array_equal(got, torch.cat(toks, dim=1).numpy())
    for name in ("k", "v"):
        assert torch.equal(cache[name], want_cache[name])
    assert stats["captures"] == stats["graph_replays"] == stats["pool_bytes"] == 0
    with pytest.raises(ValueError, match="cache"):
        pserve.generate(arch=arch, batch=batch, prompt_len=plen, max_new_tokens=new + 1,
                        device="cpu", params=params, prompt=prompt, cache=cache)


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "starcoder2_7b"])
def test_prefill_then_decode_matches_forward(arch):
    """Prefill s tokens, grow the cache by one slot, decode token s: the
    last-position logits equal the full forward's (the reference's
    tests/test_models.py test, here against the JAX forward as well)."""
    cfg, jp, pp, pcfg = _model(arch, seed=7)
    b, s = 2, 24
    toks = _tokens(cfg, b, s + 1, seed=2)
    full = np.asarray(jlm.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, mode="train")["logits"])
    last, cache = psteps.make_prefill_step(pcfg)(pp, {"tokens": _t(toks[:, :s])})
    _close(last, full[:, s - 1], atol_rel=1e-4)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1)).contiguous() for k, v in cache.items()}
    logits, _ = plm.decode_step(pp, cache, {"tokens": _t(toks[:, s:s + 1]), "cache_pos": s}, pcfg)
    _close(logits[:, 0], full[:, s], atol_rel=1e-4)
    jlast, _ = jsteps.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(toks[:, :s])})
    _close(last, jlast, atol_rel=1e-4)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "starcoder2_7b"])
def test_generate_greedy_matches_jax(arch, capsys):
    """The JAX run's parameters and prompt (both from PRNGKey(seed), as its
    ``generate`` draws them) injected into the port: the same tokens."""
    cfg = jax_get_config(arch, smoke=True)
    seed, batch, plen, new = 3, 2, 5, 6
    want = jserve.generate(arch=arch, batch=batch, prompt_len=plen, max_new_tokens=new,
                           seed=seed)
    key = jax.random.PRNGKey(seed)
    params = convert.lm_params(jax.device_get(jlm.init_params(cfg, key)),
                               configs.get_config(arch, smoke=True), device="cpu")
    prompt = np.asarray(jax.random.randint(key, (batch, plen), 0, cfg.vocab_size))
    kernels.reset_launches()
    stats = {}
    got = pserve.generate(arch=arch, batch=batch, prompt_len=plen, max_new_tokens=new,
                          seed=seed, device="cpu", params=params, prompt=prompt, stats=stats)
    assert got.shape == (batch, new)
    np.testing.assert_array_equal(got, want)
    assert stats["steps"] == plen + new - 1 and stats["new_tokens"] == new
    assert kernels.launches()["flash_attention"] == 0
    assert "generated (2, 6)" in capsys.readouterr().out


def test_generate_free_runs():
    """Free runs draw from the seed: repeatable, in range; temperature
    sampling too (its parity with JAX is in distribution only)."""
    kw = dict(arch="codeqwen1.5-7b", batch=3, prompt_len=4, max_new_tokens=5, device="cpu")
    a, b = pserve.generate(seed=1, **kw), pserve.generate(seed=1, **kw)
    np.testing.assert_array_equal(a, b)
    hot = pserve.generate(seed=1, temperature=1.0, **kw)
    assert hot.shape == (3, 5) and hot.min() >= 0 and hot.max() < 256
    np.testing.assert_array_equal(hot, pserve.generate(seed=1, temperature=1.0, **kw))
    with pytest.raises(ValueError, match="prompt"):
        pserve.generate(prompt=np.zeros((2, 4)), seed=1, **kw)


def test_lm_cli_on_cpu(capsys):
    new = pserve.main(["lm", "--arch", "starcoder2-7b", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "3", "--max-new-tokens", "4"])
    assert new.shape == (2, 4)
    assert "starcoder2-7b: generated (2, 4)" in capsys.readouterr().out


def _every_training_entry_steps(arch):
    """Every training entry on ``arch``'s smoke config for one step of 2 x
    32 positions from the port's stream: ``loss_fn`` and ``value_and_grad``
    (the same loss, a gradient for every leaf), ``make_train_step`` (the
    same loss, AdamW's first moment from that gradient) and
    ``make_hybrid_train_step`` (a finite loss, the FW step's gamma 1), and
    ``launch.train`` (one logged step). Returns the params."""
    from repro_torch.data import SyntheticLMStream, device_put_batch
    from repro_torch.launch import train as ptrain
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, hybrid
    from repro_torch.optim.compression import tree_leaves

    cfg = configs.get_config(arch, smoke=True)
    assert cfg.family in plm.TRAINED_FAMILIES
    params = plm.init_params(cfg, 0, device="cpu")
    batch = device_put_batch(SyntheticLMStream(cfg, ShapeSpec("t", "train", 32, 2))
                             .batch_for_step(0), "cpu")
    loss, metrics = plm.loss_fn(params, batch, cfg)
    (vloss, _), grads = plm.value_and_grad(params, batch, cfg)
    assert float(vloss) == float(loss) and np.isfinite(float(loss))
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")
    assert [tuple(g.shape) for g in tree_leaves(grads)] == [
        tuple(p.shape) for p in tree_leaves(params)]
    params, opt, m = psteps.make_train_step(cfg)(params, adamw.init(params), batch)
    assert float(m["loss"]) == float(loss) and int(opt.step) == 1
    assert torch.equal(opt.m["unembed"], 0.1 * grads["unembed"])  # step 0's lr is 0
    params, _, m = hybrid.make_hybrid_train_step(cfg)(params, hybrid.init(params), batch, 0)
    assert np.isfinite(float(m["loss"])) and float(m["fw_gamma"]) == 1.0
    _, _, hist = ptrain.train(arch=arch, steps=1, seq_len=32, global_batch=2, device="cpu")
    assert [s for s, _ in hist] == [1] and np.isfinite(hist[0][1])
    assert not any(t.requires_grad for t in jax.tree.leaves(params))
    return params


@pytest.mark.parametrize("arch", MOE)
def test_other_families_not_yet_ported(arch):
    """The moe family serves (its parity is in tests/test_torch_moe.py and
    tests/test_torch_lm_families.py) and now trains too: every training
    entry runs a step (the parity with the reference is in
    tests/test_torch_train_families.py); prefill and generate still run."""
    cfg = configs.get_config(arch, smoke=True)
    assert cfg.family == "moe" and "moe" in plm.PORTED_FAMILIES
    params = _every_training_entry_steps(arch)
    assert set(params["layers"][0]) >= {"ln1", "attn", "ln2", "moe"}
    assert ("mlp" in params["layers"][0]) == cfg.moe_dense_residual
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=1))
    last, cache = psteps.make_prefill_step(cfg)(params, {"tokens": toks})
    assert tuple(last.shape) == (2, cfg.vocab_size) and bool(torch.isfinite(last).all())
    assert set(cache) == set(plm.cache_specs(cfg, 1, 8)) == {"k", "v"}
    new = pserve.generate(arch=arch, batch=2, prompt_len=3, max_new_tokens=2, device="cpu")
    assert new.shape == (2, 2)


@pytest.mark.parametrize("arch", SERVED)
def test_served_families_do_not_train_yet(arch):
    """audio, vlm and hybrid serve (tests/test_torch_lm_families.py) and now
    train too: every training entry runs a step on them; hubert,
    encoder-only, still has no decode."""
    cfg = configs.get_config(arch, smoke=True)
    assert cfg.family in plm.PORTED_FAMILIES
    _every_training_entry_steps(arch)
    psteps.make_prefill_step(cfg)
    if cfg.encoder_only:
        with pytest.raises(ValueError, match="encoder-only"):
            pserve.generate(arch=arch, device="cpu")
        with pytest.raises(ValueError, match="encoder-only"):
            plm.cache_specs(cfg, 1, 8)
    else:
        assert set(plm.cache_specs(cfg, 1, 8)) >= {"k", "v"}


def test_encoder_only_prefill_not_yet_ported():
    """The reference's encoder-only step, refused here until the audio
    family was served, now runs for any family: the dense config with
    causal=False gives every position's logits and no cache, as the JAX
    package's ``make_prefill_step`` does (1e-4 of max)."""
    cfg = dataclasses.replace(jax_get_config("qwen2_1_5b", smoke=True), causal=False)
    pcfg = dataclasses.replace(configs.get_config("qwen2_1_5b", smoke=True), causal=False)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(5))
    pp = convert.lm_params(jax.device_get(jp), pcfg, device="cpu")
    toks = _tokens(cfg, 2, 24, seed=6)
    want, wcache = jsteps.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(toks)})
    got, cache = psteps.make_prefill_step(pcfg)(pp, {"tokens": _t(toks)})
    assert cache is None and wcache is None and tuple(got.shape) == (2, 24, cfg.vocab_size)
    _close(got, want, atol_rel=1e-4)
    causal = plm.forward(pp, {"tokens": _t(toks)}, configs.get_config("qwen2_1_5b", smoke=True),
                         mode="train")["logits"]
    assert not torch.allclose(got[:, 0], causal[:, 0], atol=1e-3)  # position 0 sees them all


def test_lm_params_carries_bf16_bit_for_bit():
    cfg = dataclasses.replace(jax_get_config("qwen2_1_5b", smoke=True), dtype="bfloat16")
    jp = jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(3)))
    pcfg = dataclasses.replace(configs.get_config("qwen2_1_5b", smoke=True), dtype="bfloat16")
    pp = convert.lm_params(jp, pcfg, device="cpu")
    assert pp["embed"].dtype == torch.bfloat16 and "unembed" not in pp

    def bits(t):
        return t.view(torch.int16).numpy().view(np.uint16)

    np.testing.assert_array_equal(bits(pp["embed"]), np.asarray(jp["embed"]).view(np.uint16))
    for i in range(cfg.num_layers):
        for name in ("wq", "bq", "wo"):
            np.testing.assert_array_equal(
                bits(pp["layers"][i]["attn"][name]),
                np.asarray(jp["layers"]["attn"][name][i]).view(np.uint16))
        np.testing.assert_array_equal(bits(pp["layers"][i]["mlp"]["wd"]),
                                      np.asarray(jp["layers"]["mlp"]["wd"][i]).view(np.uint16))
    # the port's own draw has the same names, shapes and dtypes
    own = plm.init_params(pcfg, 0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), own) == jax.tree.map(
        lambda t: (tuple(t.shape), t.dtype), pp)
    assert plm.param_count(own) == sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    with pytest.raises(ValueError, match="layers"):
        convert.lm_params(dict(jp, layers=jax.tree.map(lambda a: a[:1], jp["layers"])), pcfg,
                          device="cpu")
