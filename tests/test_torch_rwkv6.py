"""The port's ssm family (RWKV-6, rwkv6-7b) against the JAX package, on the CPU.

The smoke config (2 layers, d 128, two heads of 64, d_ff 256, vocabulary
256, f32, ssm_chunk 32) runs as published and with ssm_chunk 256 over 512
tokens, where about a quarter of the in-chunk (position, channel) pairs
pass the -80 clamp (ROADMAP, caveat (e)). Parameters come from the JAX
package's ``init_params`` with ``u_bonus`` redrawn nonzero (the reference
inits it to zeros, which would hide the bonus term) and are carried across
by ``convert.lm_params``; inputs are numpy draws from a seed. On the CPU the
port's time mix runs ``ops.wkv6_chunk``'s plain chunk form, the same
function as the reference's own chunk scan.

Tolerances (f32 sums in another order in XLA and in PyTorch's CPU
kernels): single blocks rtol 1e-5 with an atol of 1e-5 of max|reference|;
whole forwards, decode sequences and caches 1e-4 of max|reference|; at
ssm_chunk 256, where the JAX package's prefix sums to about -110 are off by
up to 2.2e-5 (see tests/test_torch_wkv6.py), 1e-3 of max. Greedy tokens
must be identical.
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
from repro.models import lm as jlm
from repro.models import rwkv6 as jrwkv
from repro_torch import configs, convert, kernels
from repro_torch.launch import serve as pserve
from repro_torch.launch import steps as psteps
from repro_torch.models import lm as plm
from repro_torch.models import rwkv6 as prwkv

torch.set_num_threads(2)

ARCH = "rwkv6_7b"


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _nonzero_u(jp, seed=9):
    """u_bonus (L, H, 64) redrawn N(0, 0.5^2)."""
    u = jp["layers"]["tm_cm"]["u_bonus"]
    layers = dict(jp["layers"], tm_cm=dict(
        jp["layers"]["tm_cm"], u_bonus=jax.random.normal(jax.random.PRNGKey(seed), u.shape) * 0.5))
    return dict(jp, layers=layers)


def _model(chunk=None, seed=0):
    """(JAX cfg, JAX params with a nonzero u, the port's params, port cfg)."""
    cfg = jax_get_config(ARCH, smoke=True)
    pcfg = configs.get_config(ARCH, smoke=True)
    if chunk is not None:
        cfg = dataclasses.replace(cfg, ssm_chunk=chunk)
        pcfg = dataclasses.replace(pcfg, ssm_chunk=chunk)
    jp = _nonzero_u(jlm.init_params(cfg, jax.random.PRNGKey(seed)))
    return cfg, jp, convert.lm_params(jax.device_get(jp), pcfg, device="cpu"), pcfg


def _block(jp, pp, i=0):
    """Layer i's RWKV parameters in both packages."""
    return jax.tree.map(lambda a: a[i], jp["layers"]["tm_cm"]), pp["layers"][i]["tm_cm"]


def _unit_rms(rng, shape):
    """Inputs as ``ln1`` leaves them: unit RMS per position."""
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,s,atol_rel", [(32, 64, 1e-5), (32, 24, 1e-5), (256, 512, 1e-3)])
def test_time_mix_matches_jax(chunk, s, atol_rel):
    """s 64: two chunks of 32; s 24: one chunk of 24 (q = min(chunk, s));
    256 over 512: two chunks with the clamps binding."""
    cfg, jp, pp, pcfg = _model(chunk, seed=1)
    jb, pb = _block(jp, pp)
    rng = np.random.default_rng(2)
    x = _unit_rms(rng, (2, s, cfg.d_model))
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((2, cfg.d_model // 64, 64, 64)) * 0.3).astype(np.float32)
    yj, sj, lj = jrwkv.time_mix(jb, jnp.asarray(x), cfg, jnp.asarray(x_prev), jnp.asarray(s0))
    yp, sp, lp = prwkv.time_mix(pb, _t(x), pcfg, _t(x_prev), _t(s0))
    _close(yp, yj, atol_rel=atol_rel)
    _close(sp, sj, atol_rel=max(atol_rel, 1e-4))
    _close(lp, lj, rtol=0, atol_rel=0)
    assert sp.dtype == torch.float32


def test_time_mix_refuses_a_ragged_chunk():
    """S % q != 0: the reference asserts, the port raises ValueError."""
    cfg, jp, pp, pcfg = _model(32)
    jb, pb = _block(jp, pp)
    x = np.zeros((1, 40, cfg.d_model), np.float32)
    xp = np.zeros((1, cfg.d_model), np.float32)
    s0 = np.zeros((1, 2, 64, 64), np.float32)
    with pytest.raises(AssertionError):
        jrwkv.time_mix(jb, jnp.asarray(x), cfg, jnp.asarray(xp), jnp.asarray(s0))
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        prwkv.time_mix(pb, _t(x), pcfg, _t(xp), _t(s0))


def test_decode_blocks_match_jax():
    cfg, jp, pp, pcfg = _model(seed=3)
    jb, pb = _block(jp, pp, 1)
    rng = np.random.default_rng(4)
    x = _unit_rms(rng, (3, cfg.d_model))
    x_prev = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((3, 2, 64, 64)) * 0.3).astype(np.float32)
    outs_j = jrwkv.time_mix_decode(jb, jnp.asarray(x), cfg, jnp.asarray(x_prev),
                                   jnp.asarray(s0))
    outs_p = prwkv.time_mix_decode(pb, _t(x), pcfg, _t(x_prev), _t(s0))
    for got, want in zip(outs_p, outs_j):
        _close(got, want)
    for got, want in zip(prwkv.channel_mix_decode(pb, _t(x), _t(x_prev)),
                         jrwkv.channel_mix_decode(jb, jnp.asarray(x), jnp.asarray(x_prev))):
        _close(got, want)


def test_channel_mix_matches_jax():
    cfg, jp, pp, pcfg = _model(seed=5)
    jb, pb = _block(jp, pp)
    rng = np.random.default_rng(6)
    x = _unit_rms(rng, (2, 17, cfg.d_model))
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    for got, want in zip(prwkv.channel_mix(pb, _t(x), _t(x_prev)),
                         jrwkv.channel_mix(jb, jnp.asarray(x), jnp.asarray(x_prev))):
        _close(got, want)


def test_init_and_cache_specs_match_jax():
    """Names, shapes and dtypes of the port's own draw and of the decode
    cache; u_bonus and w_base stay f32 in a bf16 model."""
    cfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), dtype="bfloat16")
    jp = jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    own = plm.init_params(pcfg, 0, device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape[1:]), str(a.dtype)), jp["layers"])
    for lp in own["layers"]:
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), lp) == want
    assert own["layers"][0]["tm_cm"]["u_bonus"].dtype == torch.float32
    assert not own["layers"][0]["tm_cm"]["u_bonus"].any()
    assert plm.param_count(own) == sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    specs = plm.cache_specs(pcfg, 3, 99)
    jspecs = jlm.cache_specs(cfg, 3, 99)
    assert {k: (s, str(d)[6:]) for k, (s, d) in specs.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
    cache = plm.init_cache(pcfg, 3, 99, device="cpu")
    assert all(not t.any() for t in cache.values())
    rc = prwkv.init_rwkv_cache(pcfg, 3)
    assert tuple(rc.s.shape) == (3, 2, 64, 64) and tuple(rc.x_tm.shape) == (3, 128)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,s,atol_rel", [(None, 64, 1e-4), (256, 512, 1e-3)])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_jax(chunk, s, atol_rel, mode):
    cfg, jp, pp, pcfg = _model(chunk, seed=6)
    toks = _tokens(2, s, seed=7)
    jout = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, mode=mode)
    kernels.reset_launches()
    pout = plm.forward(pp, {"tokens": _t(toks)}, pcfg, mode=mode)
    assert kernels.launches()["wkv6_chunk"] == 0  # the CPU path
    assert set(pout) == set(jout)
    _close(pout["hidden"], jout["hidden"], atol_rel=atol_rel)
    _close(pout["logits"], jout["logits"], atol_rel=atol_rel)
    if mode == "prefill":
        assert set(pout["cache"]) == {"s", "x_tm", "x_cm"}
        for name in ("s", "x_tm", "x_cm"):
            got = pout["cache"][name]
            assert tuple(got.shape) == jout["cache"][name].shape and got.dtype == torch.float32
            _close(got, jout["cache"][name], atol_rel=atol_rel)


def test_decode_sequence_matches_jax():
    cfg, jp, pp, pcfg = _model(seed=8)
    b, s = 2, 12
    toks = _tokens(b, s, seed=9)
    jcache = jlm.init_cache(cfg, b, s)
    pcache = plm.init_cache(pcfg, b, s, device="cpu")
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    pstep = psteps.make_serve_step(pcfg)
    for t in range(s):
        jl, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
        pl, pcache2 = pstep(pp, pcache, {"tokens": _t(toks[:, t:t + 1]), "cache_pos": t})
        assert pcache2 is pcache  # updated in place
        _close(pl, jl, atol_rel=1e-4)
    for name in ("s", "x_tm", "x_cm"):
        _close(pcache[name], jcache[name], atol_rel=1e-4)


def test_decode_step_with_a_tensor_position_matches_jax():
    """``cache_pos`` as a 0-d int64 tensor, as the reference's traced
    ``jnp.int32(t)`` (the ssm family ignores it): at every position the
    logits and the three caches against the JAX ``decode_step``; the int form
    gives the same bits."""
    cfg, jp, pp, pcfg = _model(seed=12)
    b, s = 2, 10
    toks = _tokens(b, s, seed=13)
    jcache = jlm.init_cache(cfg, b, s)
    pcache = plm.init_cache(pcfg, b, s, device="cpu")
    icache = plm.init_cache(pcfg, b, s, device="cpu")
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    for t in range(s):
        jl, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
        pl, _ = plm.decode_step(pp, pcache, {"tokens": _t(toks[:, t:t + 1]),
                                             "cache_pos": torch.tensor(t)}, pcfg)
        il, _ = plm.decode_step(pp, icache, {"tokens": _t(toks[:, t:t + 1]), "cache_pos": t},
                                pcfg)
        _close(pl, jl, atol_rel=1e-4)
        assert torch.equal(pl, il)
        for name in ("s", "x_tm", "x_cm"):
            _close(pcache[name], jcache[name], atol_rel=1e-4)
            assert torch.equal(pcache[name], icache[name])


def test_generate_fills_the_given_cache_as_the_step_loop_does():
    """On the CPU ``generate`` runs its step uncaptured: its tokens and the
    state it was given equal a plain loop of the serve step's, bit for bit."""
    batch, plen, new = 2, 4, 3
    pcfg = configs.get_config(ARCH, smoke=True)
    params = plm.init_params(pcfg, 5, device="cpu")
    prompt = _tokens(batch, plen, seed=15).astype(np.int64)
    cache = plm.init_cache(pcfg, batch, plen + new, device="cpu")
    stats = {}
    got = pserve.generate(arch="rwkv6-7b", batch=batch, prompt_len=plen, max_new_tokens=new,
                          device="cpu", params=params, prompt=prompt, cache=cache, stats=stats)
    want_cache = plm.init_cache(pcfg, batch, plen + new, device="cpu")
    step, toks = psteps.make_serve_step(pcfg), []
    for t in range(plen + new - 1):
        cur = _t(prompt[:, t:t + 1]) if t < plen else toks[-1]
        logits, _ = step(params, want_cache, {"tokens": cur, "cache_pos": t})
        if t >= plen - 1:
            toks.append(torch.argmax(logits[:, 0, :].float(), dim=-1, keepdim=True))
    np.testing.assert_array_equal(got, torch.cat(toks, dim=1).numpy())
    for name in ("s", "x_tm", "x_cm"):
        assert torch.equal(cache[name], want_cache[name])
    assert stats["captures"] == stats["graph_replays"] == 0


@pytest.mark.parametrize("chunk,s", [(None, 64), (None, 24)])
def test_prefill_then_decode_matches_forward(chunk, s):
    """Prefill s tokens: the last-position logits equal the JAX forward's and
    prefill's; then decode token s from the prefill's cache, as the JAX
    package does from its own (at a chunk where the clamps cannot bind)."""
    cfg, jp, pp, pcfg = _model(chunk, seed=10)
    toks = _tokens(2, s + 1, seed=11)
    full = np.asarray(jlm.forward(jp, {"tokens": jnp.asarray(toks[:, :s])}, cfg,
                                  mode="train")["logits"])
    last, cache = psteps.make_prefill_step(pcfg)(pp, {"tokens": _t(toks[:, :s])})
    _close(last, full[:, -1], atol_rel=1e-4)
    jlast, jcache = jsteps.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(toks[:, :s])})
    _close(last, jlast, atol_rel=1e-4)
    logits, _ = plm.decode_step(pp, cache, {"tokens": _t(toks[:, s:s + 1]), "cache_pos": s},
                                pcfg)
    jlogits, _ = jlm.decode_step(jp, jcache, {"tokens": jnp.asarray(toks[:, s:s + 1]),
                                              "cache_pos": jnp.int32(s)}, cfg)
    _close(logits, jlogits, atol_rel=1e-4)


@pytest.mark.parametrize("nonzero_u", [False, True])
def test_generate_greedy_matches_jax(nonzero_u, capsys, monkeypatch):
    """The JAX run's parameters and prompt (both from PRNGKey(seed), as its
    ``generate`` draws them; with ``nonzero_u`` its init is wrapped to
    redraw u_bonus) injected into the port: the same tokens, no kernel
    launch."""
    cfg = jax_get_config(ARCH, smoke=True)
    seed, batch, plen, new = 3, 2, 5, 6
    if nonzero_u:
        init = jlm.init_params
        monkeypatch.setattr(jlm, "init_params", lambda c, k: _nonzero_u(init(c, k)))
    want = jserve.generate(arch=ARCH, batch=batch, prompt_len=plen, max_new_tokens=new,
                           seed=seed)
    key = jax.random.PRNGKey(seed)
    params = convert.lm_params(jax.device_get(jlm.init_params(cfg, key)),
                               configs.get_config(ARCH, smoke=True), device="cpu")
    assert bool(params["layers"][0]["tm_cm"]["u_bonus"].any()) == nonzero_u
    prompt = np.asarray(jax.random.randint(key, (batch, plen), 0, cfg.vocab_size))
    kernels.reset_launches()
    stats = {}
    got = pserve.generate(arch="rwkv6-7b", batch=batch, prompt_len=plen, max_new_tokens=new,
                          seed=seed, device="cpu", params=params, prompt=prompt, stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats["steps"] == plen + new - 1
    assert kernels.launches()["wkv6_chunk"] == 0
    assert "rwkv6-7b: generated (2, 6)" in capsys.readouterr().out


def test_generate_free_run_and_cli(capsys):
    kw = dict(arch="rwkv6-7b", batch=2, prompt_len=4, max_new_tokens=3, device="cpu")
    a, b = pserve.generate(seed=2, **kw), pserve.generate(seed=2, **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 3) and a.min() >= 0 and a.max() < 256
    new = pserve.main(["lm", "--arch", "rwkv6-7b", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "3", "--max-new-tokens", "4"])
    assert new.shape == (2, 4)
    assert "rwkv6-7b: generated (2, 4)" in capsys.readouterr().out


def test_lm_params_carries_a_bf16_rwkv_tree_bit_for_bit():
    """The nested tm_cm dict: bf16 leaves through uint16, and the f32 leaves
    of a bf16 model (w_base, u_bonus) as f32, bit for bit."""
    cfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_config(ARCH, smoke=True), dtype="bfloat16")
    jp = jax.device_get(_nonzero_u(jlm.init_params(cfg, jax.random.PRNGKey(3))))
    pp = convert.lm_params(jp, pcfg, device="cpu")
    assert set(pp) == {"embed", "layers", "final_norm", "unembed"}
    leaves = jp["layers"]["tm_cm"]
    for i in range(cfg.num_layers):
        got = pp["layers"][i]["tm_cm"]
        assert set(got) == set(leaves)
        for name, arr in leaves.items():
            a = np.asarray(arr[i])
            t = got[name]
            if a.dtype == np.float32:
                assert t.dtype == torch.float32, name
                np.testing.assert_array_equal(t.numpy().view(np.uint32), a.view(np.uint32))
            else:
                assert t.dtype == torch.bfloat16, name
                np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                              a.view(np.uint16))
        for ln in ("ln1", "ln2"):
            assert pp["layers"][i][ln].dtype == torch.bfloat16
    assert pp["layers"][1]["tm_cm"]["u_bonus"].any()
    np.testing.assert_array_equal(pp["unembed"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jp["unembed"]).view(np.uint16))
