"""The port's sharded LM serving paths over four gloo CPU workers against the
JAX package under the same meshes: prefill, decode at batch 4 (the cache
split on batch, or on its sequence dim over the model axis where that axis
does not divide the kv heads) and at batch 1 (the cache split on its
sequence dim over the data axes), the moe expert-parallel block and
prefill, rwkv6's prefill and decode (its state's heads over the model
axis, or all of them on every model shard where that axis does not divide
them), ``decode_attention_seq_sharded``, and the refusals.

One subprocess runs the JAX package on 8 fake CPU devices (meshes on the
first 4): qwen2-1.5b (dense, 4 q and 2 kv heads), llama4-scout (moe, 4
experts top-1) and rwkv6-7b (ssm, 2 heads) smoke configs from
``init_params(PRNGKey(0))``, 4 prompts of 32 tokens, a 48-position cache
filled by the unsharded prefill (rwkv6: its state after the prompts), at
meshes (2, 2) and (1, 4), jitted under ``use_mesh``. One 4-process spawn
runs the port's side from the same parameters and inputs.

Tolerances: logits and moe outputs rtol 1e-4 with an atol of 1e-4 of the
largest |value| (f32 sums in other orders: the partial products' psum, the
vocab-parallel head, the flash-decode combine). The moe capacity is per
data shard under a mesh (the reference's rule): at the configured factor
1.25, on tokens leaning toward one expert, the mesh drops other tokens
than one device does, and the port's output matches the reference's mesh
output, dropped tokens included; at factor 32 nothing drops and all
agree.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import dfw, multihost, sharding, steps
from repro_torch.launch import mesh as pmesh
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec
from repro_torch.specs import NotYetPorted

SRC = str(Path(__file__).resolve().parent.parent / "src")
MESHES = ((2, 2), (1, 4))
CASES = (("qwen2_1_5b", None), ("llama4_scout_17b_a16e", 32.0),
         ("llama4_scout_17b_a16e", None), ("rwkv6_7b", None))
PROMPT, CACHE, ONE_STEPS = 32, 48, 3

_JAX_SCRIPT = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.kernels.flash_attention import ref as attn_ref
from repro.launch import sharding, steps
from repro.launch.mesh import make_mesh
from repro.models import layers, lm, moe

PROMPT, CACHE, ONE_STEPS = 32, 48, 3
rng = np.random.default_rng(0)
toks = rng.integers(0, 256, (4, PROMPT)).astype(np.int32)
nxt = rng.integers(0, 256, (4, 1)).astype(np.int32)
out = {"toks": toks, "nxt": nxt}
for arch, factor in (("qwen2_1_5b", None), ("llama4_scout_17b_a16e", 32.0),
                     ("llama4_scout_17b_a16e", None), ("rwkv6_7b", None)):
    cfg = get_config(arch, smoke=True)
    if factor:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    out[arch, "init"] = jax.device_get(params)
    _, pc = jax.jit(steps.make_prefill_step(cfg))(params, {"tokens": toks})
    full = pc if cfg.family == "ssm" else {
        k: v.at[:, :, :, :PROMPT].set(pc[k]) for k, v in lm.init_cache(cfg, 4, CACHE).items()}
    out[arch, factor, "cache"] = jax.device_get(full)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    if cfg.family == "moe":  # tokens leaning toward expert 0, so the capacity binds
        r0 = params["layers"]["moe"]["router"][0][:, 0]
        x = x + 1.5 * r0 / jnp.linalg.norm(r0)
    out[arch, "x"] = np.asarray(x)
    for shape in (None, (2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model")) if shape else None
        with sharding.use_mesh(mesh):
            r = {"prefill": jax.jit(steps.make_prefill_step(cfg))(params, {"tokens": toks})[0]}
            serve = jax.jit(steps.make_serve_step(cfg))
            r["decode4"] = serve(params, full, {"tokens": nxt, "cache_pos": jnp.int32(PROMPT)})[0]
            if cfg.family != "moe":
                c1, ones = {k: v[:, :1] for k, v in full.items()}, []
                for t in range(ONE_STEPS):
                    lg, c1 = serve(params, c1, {"tokens": nxt[:1],
                                                "cache_pos": jnp.int32(PROMPT + t)})
                    ones.append(lg)
                r["decode1"] = ones
            else:
                layer0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
                r["moe"] = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(layer0, x)
        out[arch, factor, shape] = jax.device_get(r)
mesh = make_mesh((4, 1), ("data", "model"))
q = rng.standard_normal((1, 4, 1, 16)).astype(np.float32)
k = rng.standard_normal((1, 2, 128, 16)).astype(np.float32)
v = rng.standard_normal((1, 2, 128, 16)).astype(np.float32)
with sharding.use_mesh(mesh):
    out["fd"] = (q, k, v, np.asarray(layers.decode_attention_seq_sharded(
        q, k, v, scale=16**-0.5, cache_pos=jnp.int32(100), mesh=mesh)))
pickle.dump(out, open(sys.argv[1], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_lm") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(path)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return pickle.loads(path.read_bytes())


def _cfg(arch, factor):
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, moe_capacity_factor=factor) if factor else cfg


def _serve_worker(group, device, ref_inputs):
    """Every case at every mesh on this worker: its rows of the prefill and
    batch-4 decode logits, the batch-1 decode logits, its rows of the moe
    block; and the (4, 1) flash-decode of its sequence block."""
    from repro_torch.data import shard_rows
    from repro_torch.launch import params as P
    from repro_torch.models import layers, moe

    toks, nxt = (torch.from_numpy(ref_inputs[k]) for k in ("toks", "nxt"))
    out = {}
    for shape in MESHES:
        mesh = pmesh.make_mesh(shape, ("data", "model"), group)
        for arch, factor in CASES:
            cfg = _cfg(arch, factor)
            full_params = convert.lm_params(ref_inputs[arch, "init"], cfg, device="cpu")
            full_cache = {k: torch.from_numpy(np.asarray(v))
                          for k, v in ref_inputs[arch, factor, "cache"].items()}
            with sharding.use_mesh(mesh):
                params = P.shard_params(full_params, mesh)
                r = {"prefill": steps.make_prefill_step(cfg)(params, {"tokens": toks})[0]}
                serve = steps.make_serve_step(cfg)
                cache = steps.local_cache(full_cache, cfg, ShapeSpec("d", "decode", CACHE, 4))
                r["decode4"] = serve(params, cache, {"tokens": nxt,
                                                     "cache_pos": torch.tensor(PROMPT)})[0]
                if cfg.family != "moe":
                    c1 = steps.local_cache({k: v[:, :1] for k, v in full_cache.items()}, cfg,
                                           ShapeSpec("d", "decode", CACHE, 1))
                    r["decode1"] = [serve(params, c1, {"tokens": nxt[:1], "cache_pos":
                                                       torch.tensor(PROMPT + t)})[0]
                                    for t in range(ONE_STEPS)]
                else:
                    x = torch.from_numpy(ref_inputs[arch, "x"])
                    par_rows = shard_rows({"tokens": x}, mesh.index(("data",)),
                                          mesh.shape["data"])["tokens"]
                    r["moe"] = moe.moe_block(params["layers"][0]["moe"], par_rows, cfg)
            out[arch, factor, shape] = r
    q, k, v, _ = (torch.from_numpy(a) for a in ref_inputs["fd"])
    mesh = pmesh.make_mesh((4, 1), ("data", "model"), group)
    s_loc = k.shape[2] // 4
    blk = slice(group.rank * s_loc, (group.rank + 1) * s_loc)
    with sharding.use_mesh(mesh):
        out["fd"] = layers.decode_attention_seq_sharded(
            q, k[:, :, blk], v[:, :, blk], scale=16**-0.5, cache_pos=torch.tensor(100), mesh=mesh)
    return out


@pytest.fixture(scope="module")
def port(ref):
    inputs = {k: v for k, v in ref.items() if k in ("toks", "nxt", "fd") or k[1:] == ("init",)
              or k[1:] == ("x",) or (len(k) == 3 and k[2] == "cache")}
    return dfw.run_workers(4, _serve_worker, inputs, device="cpu")


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _rows(port, key, name, shape):
    """The global (B, ...) output from each data shard's rows."""
    d, m = shape
    return np.concatenate([port[i * m][key][name].detach().numpy() for i in range(d)])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_sharded_prefill_and_decode_match_reference(ref, port, case, shape):
    key = (*case, shape)
    want = ref[key]
    _close(_rows(port, key, "prefill", shape), want["prefill"])
    _close(_rows(port, key, "decode4", shape), want["decode4"])
    for w in port:  # every model shard of a data shard gives its rows' full logits
        assert w[key]["prefill"].shape[-1] == 256
    if "decode1" in want:  # batch 1: a kv cache's sequence dim split over "data"
        for w in port:
            for got, exp in zip(w[key]["decode1"], want["decode1"], strict=True):
                _close(got.detach().numpy(), exp)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("factor", [32.0, None])
def test_moe_block_capacity_is_per_data_shard(ref, port, factor, shape):
    arch = "llama4_scout_17b_a16e"
    key = (arch, factor, shape)
    got = np.concatenate([port[i * shape[1]][key]["moe"][0].detach().numpy()
                          for i in range(shape[0])])
    want, one_device = ref[key]["moe"][0], ref[arch, factor, None]["moe"][0]
    _close(got, want)
    np.testing.assert_allclose(port[0][key]["moe"][1].item(), float(ref[key]["moe"][1]),
                               rtol=1e-5)
    dropped = np.all(got == 0, axis=-1)  # top-1: a dropped token's output is exactly 0
    assert (dropped == np.all(np.asarray(want) == 0, axis=-1)).all()
    if factor == 32.0:
        assert not dropped.any()
        _close(got, one_device)
    elif shape[0] > 1:  # the capacity of a data shard's 32 tokens, not of all 64
        one_dropped = np.all(np.asarray(one_device) == 0, axis=-1)
        assert dropped.any() or one_dropped.any()
        assert (dropped != one_dropped).any()


def test_decode_attention_seq_sharded_combines_the_shards(ref, port):
    want = ref["fd"][3]
    for w in port:
        _close(w["fd"].numpy(), want)
    q, k, v, _ = ref["fd"]
    # against the plain softmax over the 100 valid positions
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k[:, :, :100], 2, axis=1)) * 16**-0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    plain = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True),
                      np.repeat(v[:, :, :100], 2, axis=1))
    _close(port[0]["fd"].numpy(), plain)


def test_unported_mesh_paths_raise_before_device_work():
    layout = pmesh.make_mesh((2, 2), ("data", "model"))
    zamba = get_config("zamba2_2_7b", smoke=True)
    params = lm.init_params(zamba, device="meta")
    # the sequence-parallel profiles run; a multi-token sequence that the
    # "seq_act" (model) axis does not divide does not
    with sharding.use_mesh(layout, sharding.rules_for("msp")):
        with pytest.raises(NotYetPorted, match="9 positions .* 'seq_act'"):
            lm.forward(params, {"tokens": torch.zeros((4, 9), dtype=torch.int64)}, zamba)
    qwen = get_config("qwen2_1_5b", smoke=True)
    with sharding.use_mesh(layout, sharding.rules_for("sp")):
        with pytest.raises(NotYetPorted, match="9 positions .* 'seq_act'"):
            lm.loss_fn(lm.init_params(qwen, device="meta"),
                       {"tokens": torch.zeros((4, 9), dtype=torch.int64),
                        "labels": torch.zeros((4, 9), dtype=torch.int64)}, qwen)
    with pytest.raises(NotYetPorted, match="dryrun"):
        multihost.main(["--device", "cpu", "dryrun"])
    with pytest.raises(ValueError, match="needs 4 workers"):
        pmesh.make_mesh((2, 2), ("data", "model"), type("G", (), {"size": 2, "rank": 0})())
