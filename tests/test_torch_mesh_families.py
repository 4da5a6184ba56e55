"""The hybrid, vlm and audio families under a mesh: the port's sharded
training, prefill and decode over four gloo CPU workers against the JAX
package under the same meshes, and against the port's own unsharded runs.

Three subprocesses, one an arch, run the JAX package on 8 fake CPU
devices each (meshes on the first 4): zamba2-2.7b (hybrid: 4 Mamba-2 layers of 8 heads and a shared
attention + MLP block applied twice), qwen2-vl-72b (vlm: 4 q and 2 kv
heads, 16 vision embeddings ahead of the text, M-RoPE) and hubert-xlarge
(audio: bidirectional, one label a frame) smoke configs in f32, from
``init_params(PRNGKey(0))``, which the port starts from too
(``convert.lm_params``). At meshes (2, 2) and (1, 4): ``train.train``, 2
steps of 4 x 32 (vlm: 16 of them vision); the prefill of 4 prompts of 32
(hubert: the encoder's logits at every frame); for zamba2 and qwen2-vl the
batch-4 decode step from a 48-position cache that the unsharded prefill
filled, and three batch-1 steps, whose kv cache is split on its sequence
dim over the data axis. One 4-process spawn runs the port's side, started
as soon as the JAX scripts have written the initial weights and inputs.

At (1, 4) zamba2's fused projection (296 columns: z 128, x 128, B 16, C
16, dt 8) is cut into blocks of 74 and its conv channels (160) into blocks
of 40 by the reference's specs, so each model shard's 2 heads take columns
from other shards' blocks; qwen2-vl's 2 kv heads do not divide the model
axis (every shard computes both). The decode caches are the workers'
blocks of the full ones (``launch.steps.local_cache``); a sharded prefill
hands back the same blocks (Mamba-2's state by heads, its conv window by
the spec's channel blocks), held here to the blocks of the unsharded
prefill's cache.

Tolerances, those of tests/test_torch_mesh_train.py and
tests/test_torch_mesh_lm.py: losses rtol 1e-5 (the port's sharded against
its unsharded losses 2e-6); after the two steps the worst leaf's max
|difference| over that leaf's max |value| within 1e-3 for the parameters
and 1e-4 for AdamW's m and v, except Mamba-2's ``a_log``, whose gradient
takes each decay as a difference of two cumulative sums (1e-3, as
tests/test_torch_train_families.py holds it; here its m and v came within
4.0e-5, the other leaves' within 7.3e-6, the parameters within 8.3e-4:
qwen2-vl's ``bk``, whose tiny gradient AdamW normalises); logits and
caches rtol 1e-4 with an atol of 1e-4 of the largest |value| (measured:
1.4e-6).
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import dfw, sharding, steps
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import train as ptrain
from repro_torch.models import lm, mamba2
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.compression import tree_leaves
from repro_torch.specs import NotYetPorted

torch.set_num_threads(2)

SRC = str(Path(__file__).resolve().parent.parent / "src")
ARCHS = ("zamba2_2_7b", "qwen2_vl_72b", "hubert_xlarge")
DECODERS = ("zamba2_2_7b", "qwen2_vl_72b")
MESHES = ((2, 2), (1, 4))
RUN = dict(steps=2, seq_len=32, global_batch=4, log_every=1)
PROMPT, CACHE, ONE_STEPS = 32, 48, 3
# (params, AdamW m, AdamW v): the worst leaf's max error over its max |.|
STATE_TOL = (1e-3, 1e-4, 1e-4)
A_LOG_TOL = 1e-3

_JAX_SCRIPT = """
import os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch import sharding, steps, train
from repro.launch.mesh import make_mesh
from repro.models import lm

ARCHS = sys.argv[3].split(",")  # this process's share of the archs
PROMPT, CACHE, ONE_STEPS = 32, 48, 3
run = dict(steps=2, seq_len=32, global_batch=4, log_every=1)
shared = {"inits": {}, "inputs": {}}
for arch in ARCHS:
    rng = np.random.default_rng(sum(map(ord, arch)))
    cfg = get_config(arch, smoke=True)
    shared["inits"][arch] = jax.device_get(lm.init_params(cfg, jax.random.PRNGKey(0)))
    if cfg.family == "audio":
        shared["inputs"][arch] = {"frames": rng.standard_normal(
            (4, PROMPT, cfg.frontend_dim)).astype(np.float32)}
        continue
    sv = cfg.vision_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, PROMPT - sv)).astype(np.int32)}
    nxt = {"tokens": rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)}
    if sv:
        batch["vision_embeds"] = rng.standard_normal((4, sv, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(PROMPT, dtype=np.int32)[None, None], (4, 3, PROMPT)))
    shared["inputs"][arch] = {"prompt": batch, "next": nxt}
pickle.dump(shared, open(sys.argv[2] + ".tmp", "wb"))
os.rename(sys.argv[2] + ".tmp", sys.argv[2])  # the port's workers start from these now


def decode_batch(cfg, tokens, pos):
    b = {"tokens": tokens, "cache_pos": jnp.int32(pos)}
    if cfg.family == "vlm":
        b["positions"] = jnp.full((tokens.shape[0], 3, 1), pos, jnp.int32)
    return b


out = {}
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    params = jax.tree.map(jnp.asarray, shared["inits"][arch])
    inputs = shared["inputs"][arch]
    prefill = jax.jit(steps.make_prefill_step(cfg))
    if cfg.family != "audio":
        _, pc = prefill(params, inputs["prompt"])
        full = {k: (v.at[:, :, :, :PROMPT].set(pc[k]) if k in ("k", "v") else pc[k])
                for k, v in lm.init_cache(cfg, 4, CACHE).items()}
        out[arch, "prefill_cache"] = jax.device_get(pc)
        out[arch, "cache"] = jax.device_get(full)
    for shape in ((2, 2), (1, 4)):
        params_t, opt, hist = train.train(arch=arch, mesh_shape=shape, **run)
        r = {"hist": hist, "state": jax.device_get((params_t, opt.m, opt.v))}
        mesh = make_mesh(shape, ("data", "model"))
        with sharding.use_mesh(mesh):
            prefill = jax.jit(steps.make_prefill_step(cfg))
            if cfg.family == "audio":
                r["prefill"] = prefill(params, inputs)[0]
            else:
                r["prefill"] = prefill(params, inputs["prompt"])[0]
                serve = jax.jit(steps.make_serve_step(cfg))
                nxt = jnp.asarray(inputs["next"]["tokens"])
                r["decode4"] = serve(params, full, decode_batch(cfg, nxt, PROMPT))[0]
                c1, ones = {k: v[:, :1] for k, v in full.items()}, []
                for t in range(ONE_STEPS):
                    lg, c1 = serve(params, c1, decode_batch(cfg, nxt[:1], PROMPT + t))
                    ones.append(lg)
                r["decode1"] = ones
        out[arch, shape] = jax.device_get(r)
pickle.dump(out, open(sys.argv[1], "wb"))
print("OK")
"""


def _cfg(arch):
    return get_config(arch, smoke=True)


def _decode_batch(cfg, tokens, pos):
    b = {"tokens": tokens, "cache_pos": torch.tensor(pos)}
    if cfg.family == "vlm":
        b["positions"] = torch.full((tokens.shape[0], 3, 1), pos, dtype=torch.int32)
    return b


def _tensors(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _serve(cfg, params, inputs, cache):
    """Prefill logits (and cache), batch-4 decode logits, the batch-1 steps'
    logits, under the active mesh (or none); ``cache``: the full decode
    cache, cut to this worker's blocks here."""
    r = {}
    if cfg.family == "audio":
        r["prefill"] = steps.make_prefill_step(cfg)(params, _tensors(inputs))[0]
        return r
    r["prefill"], r["prefill_cache"] = steps.make_prefill_step(cfg)(
        params, _tensors(inputs["prompt"]))
    serve = steps.make_serve_step(cfg)
    nxt = torch.from_numpy(inputs["next"]["tokens"])
    c4 = steps.local_cache({k: v.clone() for k, v in cache.items()}, cfg,
                           ShapeSpec("d", "decode", CACHE, 4))
    r["decode4"] = serve(params, c4, _decode_batch(cfg, nxt, PROMPT))[0]
    c1 = steps.local_cache({k: v[:, :1].clone() for k, v in cache.items()}, cfg,
                           ShapeSpec("d", "decode", CACHE, 1))
    r["cache1_shape"] = {k: tuple(v.shape) for k, v in c1.items()}
    r["decode1"] = [serve(params, c1, _decode_batch(cfg, nxt[:1], PROMPT + t))[0]
                    for t in range(ONE_STEPS)]
    return r


def _worker(group, device, shared, caches, ckpt):
    """Every arch at both meshes on this worker: the train run's history and
    its state gathered (kept by worker 0), ``_serve``'s outputs, and this
    worker's blocks of the unsharded prefill's cache (``local_cache``). The
    zamba2 (2, 2) run writes ``ckpt``, restored at (1, 4) and gathered; each
    arch's blocks drawn from a seed (``init_local_params``) against the
    blocks of the one-device draw."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import params as P

    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        full = convert.lm_params(shared["inits"][arch], cfg, device="cpu")
        for shape in MESHES:
            ck = ckpt if (arch, shape) == ("zamba2_2_7b", (2, 2)) else None
            params, opt, hist = ptrain.train(arch=arch, mesh_shape=shape, params=full,
                                             ckpt_dir=ck, device="cpu", group=group, **RUN)
            mesh = pmesh.make_mesh(shape, ("data", "model"), group)
            with sharding.use_mesh(mesh):
                specs = lm.param_specs(cfg)
                state = tuple(P.gather_params(t, mesh, specs) for t in (params, opt.m, opt.v))
                blocks = P.shard_params(full, mesh, specs)
                with torch.no_grad():
                    r = _serve(cfg, blocks, shared["inputs"][arch], caches.get(arch))
                if arch in caches:
                    r["prefill_cache_want"] = steps.local_cache(
                        caches[arch + "/prefill"], cfg, ShapeSpec("p", "decode", PROMPT, 4))
            r.update(hist=hist, state=state if group.rank == 0 else None)
            out[arch, shape] = r
        mesh = pmesh.make_mesh((2, 2), ("data", "model"), group)
        with sharding.use_mesh(mesh):
            drawn = P.init_local_params(cfg, 3, mesh, device="cpu")
            cut = P.shard_params(lm.init_params(cfg, 3, device="cpu"), mesh)
        out[arch, "drawn_blocks_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(drawn), tree_leaves(cut), strict=True))
    cfg = _cfg("zamba2_2_7b")
    mesh = pmesh.make_mesh((1, 4), ("data", "model"), group)
    with sharding.use_mesh(mesh):
        specs = lm.param_specs(cfg)
    step, params, opt = ptrain.restore(CheckpointStore(ckpt), cfg, device="cpu", mesh=mesh)
    out["restored_at_1x4"] = (step, *(P.gather_params(t, mesh, specs)
                                      for t in (params, opt.m, opt.v)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, each worker's results, the port's unsharded results): the
    JAX subprocesses and the port's workers overlapped (module doc)."""
    d = tmp_path_factory.mktemp("mesh_families")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    files = [(d / f"ref_{a}.pkl", d / f"init_{a}.pkl") for a in ARCHS]
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(path),
                               str(init), arch], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for arch, (path, init) in zip(ARCHS, files)]
    try:
        deadline = time.time() + 300
        while (not all(init.exists() for _, init in files)
               and all(p.poll() is None for p in procs) and time.time() < deadline):
            time.sleep(0.2)
        for p, (_, init) in zip(procs, files):
            assert init.exists(), p.communicate(timeout=60)[1][-4000:]
        shared = {"inits": {}, "inputs": {}}
        for _, init in files:
            part = pickle.loads(init.read_bytes())
            for k in shared:
                shared[k].update(part[k])
        unsharded = {arch: _unsharded(arch, shared) for arch in ARCHS}
        caches = {arch: unsharded[arch]["cache"] for arch in DECODERS}
        caches.update({arch + "/prefill": unsharded[arch]["prefill_cache"] for arch in DECODERS})
        workers = dfw.run_workers(4, _worker, shared, caches, str(d / "ckpt"), device="cpu")
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ref = {"ckpt_dir": str(d / "ckpt")}
    for p, err, (path, _) in zip(procs, errs, files):
        assert p.returncode == 0, err[-4000:]
        ref.update(pickle.loads(path.read_bytes()))
    return ref, workers, unsharded


def _unsharded(arch, shared):
    """The port's unsharded train run, prefill and decodes from the same
    weights and inputs; the decode cache its own prefill filled."""
    cfg = _cfg(arch)
    full = convert.lm_params(shared["inits"][arch], cfg, device="cpu")
    params, opt, hist = ptrain.train(  # trains its own copy in place
        arch=arch, params=convert.lm_params(shared["inits"][arch], cfg, device="cpu"),
        device="cpu", **RUN)
    out = {"hist": hist, "state": (params, opt.m, opt.v)}
    inputs = shared["inputs"][arch]
    with torch.no_grad():
        if cfg.family != "audio":
            _, pc = steps.make_prefill_step(cfg)(full, _tensors(inputs["prompt"]))
            cache = lm.init_cache(cfg, 4, CACHE, device="cpu")
            for k, v in cache.items():
                if k in ("k", "v"):
                    v[:, :, :, :PROMPT] = pc[k]
                else:
                    v.copy_(pc[k])
            out["cache"] = cache
        out.update(_serve(cfg, full, inputs, out.get("cache")))
    return out


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


@pytest.fixture(scope="module")
def alone(runs):
    return runs[2]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def _rows(port, key, name, shape):
    """The global (B, ...) output from each data shard's rows."""
    d, m = shape
    return np.concatenate([port[i * m][key][name].numpy() for i in range(d)])


def _state_errs(got, want):
    """For each of (params, AdamW m, AdamW v): each leaf's max |got - want|
    over its own max |want| (0 where both are 0: hubert's token embedding,
    which the frames never read), in ``tree_leaves``' order."""
    return [[float((g.double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-30))
             for g, w in zip(tree_leaves(g_tree), tree_leaves(w_tree), strict=True)]
            for g_tree, w_tree in zip(got, want, strict=True)]


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def _hold_state(got, want, arch):
    names = _leaf_names(got[0])
    for which, (errs, tol) in enumerate(zip(_state_errs(got, want), STATE_TOL, strict=True)):
        for name, e in zip(names, errs, strict=True):
            bound = max(tol, A_LOG_TOL) if name.endswith("/a_log") else tol
            assert e <= bound, (arch, ("params", "m", "v")[which], name, e)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_reference(ref, port, arch, shape):
    got, want = port[0][arch, shape]["hist"], ref[arch, shape]["hist"]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
    cfg = _cfg(arch)
    want_state = [convert.lm_params(t, cfg, device="cpu") for t in ref[arch, shape]["state"]]
    _hold_state(port[0][arch, shape]["state"], want_state, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_unsharded(port, alone, arch):
    for shape in MESHES:
        got = port[0][arch, shape]
        for w in port:  # every worker logs the global loss
            assert w[arch, shape]["hist"] == got["hist"]
        np.testing.assert_allclose([v for _, v in got["hist"]],
                                   [v for _, v in alone[arch]["hist"]], rtol=2e-6)
        _hold_state(got["state"], alone[arch]["state"], arch)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(ref, port, arch, shape):
    key, want = (arch, shape), ref[arch, shape]
    _close(_rows(port, key, "prefill", shape), want["prefill"])
    vocab = _cfg(arch).vocab_size
    for w in port:  # every model shard of a data shard gives its rows' full logits
        assert w[key]["prefill"].shape[-1] == vocab
    if arch not in DECODERS:
        return
    _close(_rows(port, key, "decode4", shape), want["decode4"])
    for w in port:  # batch 1: the kv cache's sequence dim split over "data"
        assert w[key]["cache1_shape"]["k"][3] == CACHE // shape[0]
        for got, exp in zip(w[key]["decode1"], want["decode1"], strict=True):
            _close(got.numpy(), exp)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(port, alone, arch):
    for shape in MESHES:
        key = (arch, shape)
        _close(_rows(port, key, "prefill", shape), alone[arch]["prefill"].numpy())
        if arch in DECODERS:
            _close(_rows(port, key, "decode4", shape), alone[arch]["decode4"].numpy())
            for w in port:
                for got, exp in zip(w[key]["decode1"], alone[arch]["decode1"], strict=True):
                    _close(got.numpy(), exp.numpy())


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", DECODERS)
def test_sharded_prefill_cache_is_the_decode_caches_blocks(ref, port, alone, arch, shape):
    """Each worker's prefill cache is its block of the unsharded prefill's
    cache, as ``local_cache`` cuts a decode cache of the global batch
    (zamba2: Mamba-2's state by heads, the conv window by the spec's channel
    blocks, which straddle the heads' at (1, 4)); the unsharded cache is
    the reference's."""
    for w in port:
        got, want = w[arch, shape]["prefill_cache"], w[arch, shape]["prefill_cache_want"]
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == want[name].shape, (name, got[name].shape)
            _close(got[name].numpy(), want[name].numpy())
    for name, v in ref[arch, "prefill_cache"].items():
        _close(alone[arch]["prefill_cache"][name].numpy(), v)


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_drawn_from_a_seed_are_the_one_device_draws(port, arch):
    """``init_local_params`` (every leaf cut as drawn, hubert's frame
    projection by its FSDP dim too) gives each worker the blocks of
    ``init_params`` on one device."""
    assert all(w[arch, "drawn_blocks_equal"] for w in port)


def test_mesh_checkpoint_restores_elastically_both_ways(ref, port):
    """zamba2's (2, 2) checkpoint (the leaves gathered, the reference's
    layout) restores at (1, 4) with the trained state's bits, and the JAX
    package reads it back to the same weights."""
    import jax

    from repro.checkpoint import CheckpointStore as JStore
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw

    trained = port[0]["zamba2_2_7b", (2, 2)]["state"]
    for w in port:
        step, *state = w["restored_at_1x4"]
        assert step == RUN["steps"]
        for got, want in zip(state, trained, strict=True):
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want),
                                                         strict=True))
    cfg = jget("zamba2_2_7b", smoke=True)
    aparams = jax.eval_shape(lambda k: jlm.init_params(cfg, k), jax.random.PRNGKey(0))
    like = {"params": aparams, "opt": jax.eval_shape(jadamw.init, aparams)}
    step, state, _ = JStore(ref["ckpt_dir"]).restore(like=like)
    assert step == RUN["steps"]
    got = convert.lm_params(jax.device_get(state["params"]), _cfg("zamba2_2_7b"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(trained[0]),
                                                 strict=True))


def test_mesh_widths_of_the_new_families_are_checked_before_device_work():
    """The hybrid family's Mamba-2 heads, conv channels and fused projection
    must divide the model axis (the leaves' blocks are cut by it); vlm and
    audio are checked as dense; under a sequence-sharded profile a
    multi-token sequence the model axis does not divide is refused for every
    family (vlm: its vision rows and text together)."""
    zamba = _cfg("zamba2_2_7b")
    d_inner, nh, _, n = mamba2.dims(zamba)
    assert (nh, d_inner + 2 * n, 2 * d_inner + 2 * n + nh) == (8, 160, 296)
    odd = pmesh.make_mesh((1, 3), ("data", "model"))
    for arch in ARCHS:
        cfg = _cfg(arch)
        batch = ({"frames": torch.zeros((3, 8, cfg.frontend_dim))} if cfg.family == "audio"
                 else {"tokens": torch.zeros((3, 8), dtype=torch.int64)})
        with sharding.use_mesh(odd):
            with pytest.raises(NotYetPorted, match="not divisible by the model axis"):
                lm.forward(lm.init_params(cfg, device="meta"), batch, cfg)
    for profile in ("sp", "msp"):
        with sharding.use_mesh(pmesh.make_mesh((1, 4), ("data", "model")),
                               sharding.rules_for(profile)):
            for arch in ARCHS:
                cfg = _cfg(arch)
                batch = ({"frames": torch.zeros((4, 10, cfg.frontend_dim))}
                         if cfg.family == "audio" else
                         {"tokens": torch.zeros((4, 10), dtype=torch.int64)})
                if cfg.family == "vlm":  # 16 vision rows + 10 tokens: 26 positions
                    batch["vision_embeds"] = torch.zeros((4, cfg.vision_tokens, cfg.d_model))
                n = 10 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
                with pytest.raises(NotYetPorted, match=f"{n} positions .* 'seq_act'"):
                    lm.forward(lm.init_params(cfg, device="meta"), batch, cfg)
