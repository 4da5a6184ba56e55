"""The port's serving of the LM zoo's audio, vlm, hybrid and moe families
against the JAX package, on the CPU.

The smoke configs of hubert-xlarge (audio: encoder-only, the frame
frontend), qwen2-vl-72b (vlm: vision embeddings ahead of the tokens,
M-RoPE), zamba2-2.7b (hybrid: Mamba-2 layers with one shared attention
block), arctic-480b (moe: 8 experts, top-2, a dense residual MLP) and
llama4-scout (moe: 4 experts, top-1) run in f32. Parameters come from the JAX package's ``lm.init_params``
and are carried across by ``convert.lm_params``; inputs are numpy arrays
from a seed (or the JAX run's own draws). On the CPU the port's attention
takes the reference's own off-TPU branches.

Tolerances (f32 sums taken in another order by XLA and by PyTorch's CPU
kernels): single modules (M-RoPE angles) rtol 1e-5 with an atol of 1e-5
times max|reference|; whole forwards, caches and decode sequences 1e-4 of
max|reference| (the Mamba-2 chunk scan's einsums contract in another order
than the reference's); the moe family's summed Switch loss ``aux_loss``
within rtol 1e-5. Greedy tokens and the bf16 parameters' bits must be
identical. The routing itself (ties, near-ties, the capacity's drops) is
held index for index in tests/test_torch_moe.py.
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
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs, convert, kernels
from repro_torch.launch import serve as pserve
from repro_torch.launch import steps as psteps
from repro_torch.models import layers as PL
from repro_torch.models import lm as plm

torch.set_num_threads(2)

MOE = ["arctic_480b", "llama4_scout_17b_a16e"]
FAMILIES = ["hubert_xlarge", "qwen2_vl_72b", "zamba2_2_7b", *MOE]
DECODERS = ["qwen2_vl_72b", "zamba2_2_7b", *MOE]


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


def vlm_positions(b, sv, st):
    """Qwen2-VL's layout: sv vision patches at (0, row, column) of a square
    grid, then st text tokens from the grid's side on in all three streams."""
    side = int(round(sv ** 0.5))
    assert side * side == sv
    grid = np.stack([np.zeros(sv, np.int64), np.arange(sv) // side, np.arange(sv) % side])
    text = np.broadcast_to(side + np.arange(st), (3, st))
    return np.broadcast_to(np.concatenate([grid, text], 1)[None], (b, 3, sv + st)).copy()


def _batch(cfg, b, s, seed):
    """Numpy inputs of s positions (vlm: vision_tokens of them vision)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)}
    if cfg.family == "vlm":
        sv = cfg.vision_tokens
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - sv)).astype(np.int32),
                "vision_embeds": rng.standard_normal((b, sv, cfg.d_model)).astype(np.float32),
                "positions": vlm_positions(b, sv, s - sv).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,sections,theta", [
    (16, (2, 3, 3), 1e4), (128, (16, 24, 24), 1e6), (32, (8, 4, 4), 1e5)])
def test_mrope_angles_match_jax(head_dim, sections, theta):
    pos = np.random.default_rng(head_dim).integers(0, 5000, (3, 3, 11)).astype(np.int32)
    got = PL.mrope_angles(torch.from_numpy(pos), head_dim, theta, sections)
    want = JL.mrope_angles(jnp.asarray(pos), head_dim, theta, sections)
    _close(got, want)
    # equal streams give RoPE's angles
    same = np.broadcast_to(pos[:, :1], pos.shape).copy()
    _close(PL.mrope_angles(torch.from_numpy(same), head_dim, theta, sections),
           PL.rope_angles(torch.from_numpy(same[:, 0]), head_dim, theta), rtol=0, atol_rel=0)
    with pytest.raises(ValueError, match="sections"):
        PL.mrope_angles(torch.from_numpy(pos), head_dim + 2, theta, sections)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mode", ["train", "prefill", "hidden"])
def test_forward_matches_jax(arch, mode):
    """zamba2 at S = 64 runs two chunks of its ssm_chunk 32."""
    cfg, jp, pp, pcfg = _model(arch, seed=6)
    batch = _batch(cfg, 2, 64, seed=7)
    jout = jlm.forward(jp, _j(batch), cfg, mode=mode)
    pout = plm.forward(pp, _t(batch), pcfg, mode=mode)
    assert set(pout) == set(jout)
    _close(pout["hidden"], jout["hidden"], atol_rel=1e-4)
    if mode != "hidden":
        _close(pout["logits"], jout["logits"], atol_rel=1e-4)
    if mode == "prefill":
        assert set(pout["cache"]) == set(jout["cache"])
        for name, want in jout["cache"].items():
            got = pout["cache"][name]
            assert got.dtype == {jnp.float32: torch.float32}[want.dtype.type], name
            _close(got, want, atol_rel=1e-4)
    assert pout["aux_loss"].dtype == torch.float32 and pout["aux_loss"].dim() == 0
    if cfg.family == "moe":
        assert float(jout["aux_loss"]) > 0
        np.testing.assert_allclose(float(pout["aux_loss"]), float(jout["aux_loss"]), rtol=1e-5)
    else:
        assert float(pout["aux_loss"]) == 0.0 == float(jout["aux_loss"])


def test_encoder_step_matches_jax():
    """hubert's prefill step is the encoder step: every frame's logits, no
    cache; the dense config with causal=False takes it too (its test is in
    tests/test_torch_lm.py)."""
    cfg, jp, pp, pcfg = _model("hubert_xlarge", seed=1)
    batch = _batch(cfg, 2, 40, seed=2)
    jlogits, jcache = jsteps.make_prefill_step(cfg)(jp, _j(batch))
    logits, cache = psteps.make_prefill_step(pcfg)(pp, _t(batch))
    assert cache is None and jcache is None
    assert tuple(logits.shape) == (2, 40, cfg.vocab_size)
    _close(logits, jlogits, atol_rel=1e-4)


def test_encoder_only_bidirectional():
    """tests/test_models.py's check on the port: a late frame changes an
    early position's logits (bidirectional attention), by the reference's
    amount."""
    cfg, jp, pp, pcfg = _model("hubert_xlarge", seed=0)
    frames = np.random.default_rng(0).standard_normal((1, 32, cfg.frontend_dim))
    frames = frames.astype(np.float32)
    frames2 = frames.copy()
    frames2[:, -1, :] = 10.0
    outs = [plm.forward(pp, {"frames": torch.from_numpy(f)}, pcfg, mode="train")["logits"]
            for f in (frames, frames2)]
    assert float((outs[0][:, 0] - outs[1][:, 0]).abs().max()) > 1e-6
    jouts = [jlm.forward(jp, {"frames": jnp.asarray(f)}, cfg, mode="train")["logits"]
             for f in (frames, frames2)]
    _close(outs[1][:, 0] - outs[0][:, 0], jouts[1][:, 0] - jouts[0][:, 0], atol_rel=1e-4)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_step_matches_jax(arch):
    cfg, jp, pp, pcfg = _model(arch, seed=3)
    batch = _batch(cfg, 2, 64, seed=4)
    jlast, jcache = jsteps.make_prefill_step(cfg)(jp, _j(batch))
    last, cache = psteps.make_prefill_step(pcfg)(pp, _t(batch))
    _close(last, jlast, atol_rel=1e-4)
    assert set(cache) == set(jcache)
    for name in jcache:
        _close(cache[name], jcache[name], atol_rel=1e-4)


def _step_batch(cfg, toks, t):
    """The serve step's inputs at position t, as the reference's generate
    builds them (vlm: M-RoPE positions (t, t, t))."""
    b = {"tokens": toks[:, t:t + 1], "cache_pos": t}
    if cfg.family == "vlm":
        b["positions"] = np.full((toks.shape[0], 3, 1), t, np.int32)
    return b


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_sequence_matches_jax(arch):
    """Token by token through the jitted JAX serve step and the port's: the
    logits at every position, then every cache; the port's updated in
    place."""
    cfg, jp, pp, pcfg = _model(arch, seed=10)
    b, s = 2, 12
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jcache = jlm.init_cache(cfg, b, s)
    pcache = plm.init_cache(pcfg, b, s, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in pcache.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jcache.items()}
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    pstep = psteps.make_serve_step(pcfg)
    for t in range(s):
        sb = _step_batch(cfg, toks, t)
        jl, jcache = jstep(jp, jcache, dict(_j({k: v for k, v in sb.items() if k != "cache_pos"}),
                                            cache_pos=jnp.int32(t)))
        pl, pcache2 = pstep(pp, pcache, dict(_t({k: v for k, v in sb.items()
                                                  if k != "cache_pos"}), cache_pos=t))
        assert pcache2 is pcache
        _close(pl, jl, atol_rel=1e-4)
    for name in jcache:
        _close(pcache[name], jcache[name], atol_rel=1e-4)


def _jax_prefill_then_decode(cfg, jp, prompt, steps_in):
    """The JAX package's prefill step on ``prompt`` and its jitted serve step
    on each of ``steps_in`` (its cache grown by their count): the last
    prefill logits and each step's."""
    last, cache = jsteps.make_prefill_step(cfg)(jp, _j(prompt))
    grow = len(steps_in)
    cache = {k: jnp.pad(v, ((0, 0),) * 3 + ((0, grow), (0, 0))) for k, v in cache.items()}
    jstep = jax.jit(jsteps.make_serve_step(cfg))
    out = []
    for sb in steps_in:
        logits, cache = jstep(jp, cache, dict(_j({k: v for k, v in sb.items() if k != "cache_pos"}),
                                              cache_pos=jnp.int32(sb["cache_pos"])))
        out.append(np.asarray(logits[:, 0]))
    return np.asarray(last), out


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_matches_forward(arch):
    """Prefill s = 64 positions, grow the KV cache, decode the positions after
    them one by one: the logits equal the full forward's at each (zamba2:
    32 more, since its full forward takes whole chunks of 32, and its
    Mamba-2 states continue from the prefill's; vlm: one more, the decoded
    token's M-RoPE position following the prompt's text stream). moe: the
    forward routes all positions' tokens under one capacity, the prefill
    routes the prompt's under another and a decode step its B tokens with
    no drop, so prefill then decode is not the forward, in either package;
    the port's (4 more positions) is held to the JAX package's prefill then
    decode instead."""
    cfg, jp, pp, pcfg = _model(arch, seed=7)
    b, s = 2, 64
    total = s + {"hybrid": 32, "moe": 4}.get(cfg.family, 1)
    full_batch = _batch(cfg, b, total, seed=2)
    ntext = full_batch["tokens"].shape[1]
    prompt = dict(full_batch, tokens=full_batch["tokens"][:, :ntext - (total - s)])
    if cfg.family == "vlm":
        prompt["positions"] = full_batch["positions"][:, :, :s]
    steps_in = []
    for t in range(s, total):
        col = ntext - (total - t)
        step = {"tokens": full_batch["tokens"][:, col:col + 1], "cache_pos": t}
        if cfg.family == "vlm":
            step["positions"] = full_batch["positions"][:, :, t:t + 1]
        steps_in.append(step)
    if cfg.family == "moe":
        want_last, want = _jax_prefill_then_decode(cfg, jp, prompt, steps_in)
    else:
        full = np.asarray(jlm.forward(jp, _j(full_batch), cfg, mode="train")["logits"])
        want_last, want = full[:, s - 1], [full[:, t] for t in range(s, total)]
    last, cache = psteps.make_prefill_step(pcfg)(pp, _t(prompt))
    _close(last, want_last, atol_rel=1e-4)
    for name in ("k", "v"):
        cache[name] = torch.nn.functional.pad(cache[name], (0, 0, 0, total - s)).contiguous()
    for step, w in zip(steps_in, want):
        logits, _ = plm.decode_step(pp, cache, dict(_t({k: v for k, v in step.items()
                                                        if k != "cache_pos"}),
                                                    cache_pos=step["cache_pos"]), pcfg)
        _close(logits[:, 0], w, atol_rel=1e-4)


@pytest.mark.parametrize("arch", DECODERS)
def test_generate_greedy_matches_jax(arch, capsys):
    """The JAX run's parameters and prompt (both from PRNGKey(seed), as its
    ``generate`` draws them) injected into the port: the same tokens, and
    the cache the port filled equals a loop of its serve step, bit for bit."""
    cfg = jax_get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    seed, batch, plen, new = 3, 2, 5, 6
    want = jserve.generate(arch=arch, batch=batch, prompt_len=plen, max_new_tokens=new,
                           seed=seed)
    key = jax.random.PRNGKey(seed)
    params = convert.lm_params(jax.device_get(jlm.init_params(cfg, key)), pcfg, device="cpu")
    prompt = np.asarray(jax.random.randint(key, (batch, plen), 0, cfg.vocab_size))
    kernels.reset_launches()
    cache = plm.init_cache(pcfg, batch, plen + new, device="cpu")
    got = pserve.generate(arch=arch, batch=batch, prompt_len=plen, max_new_tokens=new,
                          seed=seed, device="cpu", params=params, prompt=prompt, cache=cache)
    np.testing.assert_array_equal(got, want)
    assert kernels.launches()["flash_attention"] == 0
    assert f"generated ({batch}, {new})" in capsys.readouterr().out
    want_cache = plm.init_cache(pcfg, batch, plen + new, device="cpu")
    step = psteps.make_serve_step(pcfg)
    toks = [torch.from_numpy(prompt[:, i:i + 1].astype(np.int64)) for i in range(plen)]
    for t in range(plen + new - 1):
        sb = {"tokens": toks[t], "cache_pos": t}
        if cfg.family == "vlm":
            sb["positions"] = torch.full((batch, 3, 1), t, dtype=torch.int64)
        logits, _ = step(params, want_cache, sb)
        if t >= plen - 1:
            toks.append(torch.argmax(logits[:, 0, :].float(), dim=-1, keepdim=True))
    for name in cache:
        assert torch.equal(cache[name], want_cache[name]), name


def test_lm_cli_runs_the_new_families_on_cpu(capsys):
    for arch in ("zamba2-2.7b", "qwen2-vl-72b"):
        new = pserve.main(["lm", "--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "3", "--max-new-tokens", "4"])
        assert new.shape == (2, 4)
        assert f"{arch}: generated (2, 4)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="encoder-only"):
        pserve.main(["lm", "--arch", "hubert-xlarge", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_params_carries_bf16_and_f32_leaves_bit_for_bit(arch):
    """A bf16 model's leaves (the f32 ones of Mamba-2 included) carried bit
    for bit, with their dtypes; the port's own draw has the same names,
    shapes and dtypes and the same parameter count."""
    cfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_config(arch, smoke=True), dtype="bfloat16")
    jp = jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(3)))
    pp = convert.lm_params(jp, pcfg, device="cpu")
    want = _leaves({k: v for k, v in jp.items() if k != "layers"})
    got = _leaves({k: v for k, v in pp.items() if k != "layers"})
    for i in range(cfg.num_layers):
        want.update(_leaves(jax.tree.map(lambda a, i=i: a[i], jp["layers"]), f"layers/{i}/"))
        got.update(_leaves(pp["layers"][i], f"layers/{i}/"))
    assert set(got) == set(want)
    f32 = set()
    for name, a in want.items():
        a = np.asarray(a)
        t = got[name]
        if a.dtype == np.float32:
            f32.add(name.split("/")[-1])
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy().view(np.uint32), a.view(np.uint32))
        else:
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
    assert f32 == {"hybrid": {"a_log", "dt_bias", "d_skip"}, "moe": {"router"}}.get(
        cfg.family, set())
    if cfg.family == "audio":
        assert "frame_proj" in got
    if cfg.family == "hybrid":
        assert "shared/attn/wq" in got and "layers/0/mamba/w_in" in got
    if cfg.family == "moe":
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert tuple(got["layers/0/moe/router"].shape) == (d, e)
        assert tuple(got["layers/1/moe/wd"].shape) == (e, f, d)
        assert ("layers/0/mlp/wg" in got) == cfg.moe_dense_residual
    own = plm.init_params(pcfg, 0, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), own) == jax.tree.map(
        lambda t: (tuple(t.shape), t.dtype), pp)
    assert plm.param_count(own) == sum(np.asarray(a).size for a in jax.tree.leaves(jp))
