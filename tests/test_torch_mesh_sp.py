"""The sequence-parallel profiles ``sp`` and ``msp`` (``launch.sharding
.rules_for``) for the dense family: the port's sharded training, prefill
and decode over four gloo CPU workers against the JAX package jitted under
``use_mesh(mesh, rules_for(profile))`` on the same meshes; the loss's
``seq_act`` branch and the gradient sum it needs; a checkpoint written
under ``sp`` restored under ``tp`` and back; and ``comm.spmd``'s
``scatter`` and ``split``. The harness here (``run_parity``,
``check_train``, ``check_serve``) holds the other families too, in
tests/test_torch_mesh_sp_ssm_moe.py, tests/test_torch_mesh_sp_families.py
and tests/test_torch_mesh_sp_vlm_audio.py (``--dist loadfile`` runs each
file on its own worker).

Two subprocesses run the JAX package on 8 fake CPU devices each (meshes on
the first 4) for qwen2-1.5b (GQA, biases, a tied embedding), qwen2.5-14b,
codeqwen1.5-7b and starcoder2-7b (starcoder2's GELU MLP) smoke configs in
f32, from ``init_params(PRNGKey(0))``, which the port starts from too
(``convert.lm_params``). Under each profile at meshes (2, 2) and (1, 4):
two AdamW steps of 4 x 32 tokens (``make_train_step``; the port through
``launch.train.train`` under ``use_mesh(None, rules_for(profile))``), the
prefill of 4 prompts of 32 and its cache, and the batch-4 decode step from
a 48-position cache that the unsharded prefill filled. Under ``sp`` each
worker runs its 16 (at (1, 4) 8) rows of the sequence with every head, K
and V gathered over the model axis and the causal mask at its rows'
offset; under ``msp`` the heads stay split and the rows are gathered
around each layer. One 4-process spawn runs the port's side.

Tolerances, those of tests/test_torch_mesh_train.py and
tests/test_torch_mesh_families.py: losses rtol 1e-5; after the two steps
the worst leaf's max |difference| over that leaf's max |value| within 1e-3
for the parameters and 1e-4 for AdamW's m and v; logits and caches rtol
1e-4 with an atol of 1e-4 of the largest |value|. The seq_act gradient sum
(``lm._sum_replicated_grads``): each worker's gradient of a leaf the model
axis does not shard is its rows' part, within 1e-4 of the reference's
gradient once summed and more than 10% from it without the sum.
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
from repro_torch.launch import params as P
from repro_torch.launch import train as ptrain
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.compression import tree_leaves

torch.set_num_threads(2)

SRC = str(Path(__file__).resolve().parent.parent / "src")
# one JAX subprocess a group of archs
ARCH_GROUPS = (("qwen2_1_5b", "starcoder2_7b"), ("qwen2_5_14b", "codeqwen1_5_7b"))
ARCHS = tuple(a for g in ARCH_GROUPS for a in g)
PROFILES = ("sp", "msp")
MESHES = ((2, 2), (1, 4))
RUN = dict(steps=2, seq_len=32, global_batch=4, log_every=1)
PROMPT, CACHE = 32, 48
# (params, AdamW m, AdamW v): the worst leaf's max error over its max |.|
STATE_TOL = (1e-3, 1e-4, 1e-4)
A_LOG_TOL = 1e-3  # Mamba-2's a_log (tests/test_torch_mesh_families.py)
GRAD_ARCH = "qwen2_1_5b"  # the seq_act gradient sum's check (in ARCH_GROUPS)

JAX_SCRIPT = """
import os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data import SyntheticLMStream
from repro.launch import sharding, steps
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.models.config import ShapeSpec
from repro.optim import adamw

ARCHS = sys.argv[3].split(",")  # this process's share of the archs
GRAD_ARCH = sys.argv[4]
PROMPT, CACHE = 32, 48
shared = {"inits": {}, "inputs": {}}
for arch in ARCHS:
    rng = np.random.default_rng(sum(map(ord, arch)))
    cfg = get_config(arch, smoke=True)
    shared["inits"][arch] = jax.device_get(lm.init_params(cfg, jax.random.PRNGKey(0)))
    if cfg.family == "audio":
        shared["inputs"][arch] = {"prompt": {"frames": rng.standard_normal(
            (4, PROMPT, cfg.frontend_dim)).astype(np.float32)}}
        continue
    sv = cfg.vision_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, PROMPT - sv)).astype(np.int32)}
    if sv:
        batch["vision_embeds"] = rng.standard_normal((4, sv, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(PROMPT, dtype=np.int32)[None, None], (4, 3, PROMPT)))
    shared["inputs"][arch] = {"prompt": batch, "next": {
        "tokens": rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)}}
pickle.dump(shared, open(sys.argv[2] + ".tmp", "wb"))
os.rename(sys.argv[2] + ".tmp", sys.argv[2])  # the port's workers start from these now

out = {}
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    params = jax.tree.map(jnp.asarray, shared["inits"][arch])
    inputs = shared["inputs"][arch]
    stream = SyntheticLMStream(cfg, ShapeSpec("t", "train", 32, 4))
    if arch == GRAD_ARCH:  # the gradient at the initial weights, one device
        out["grad"] = jax.device_get(jax.grad(lambda p: lm.loss_fn(
            p, stream.batch_for_step(0), cfg)[0])(params))
    if cfg.family != "audio":
        _, pc = jax.jit(steps.make_prefill_step(cfg))(params, inputs["prompt"])
        full = {k: (v.at[:, :, :, :PROMPT].set(pc[k]) if k in ("k", "v") else pc[k])
                for k, v in lm.init_cache(cfg, 4, CACHE).items()}
        out[arch, "prefill_cache"] = jax.device_get(pc)
        out[arch, "cache"] = jax.device_get(full)
    for profile in ("sp", "msp"):
        for shape in ((2, 2), (1, 4)):
            with sharding.use_mesh(make_mesh(shape, ("data", "model")),
                                   sharding.rules_for(profile)):
                step = jax.jit(steps.make_train_step(cfg))
                p, opt, hist = params, adamw.init(params), []
                for i in range(2):
                    p, opt, m = step(p, opt, stream.batch_for_step(i))
                    hist.append((i + 1, float(m["loss"])))
                r = {"hist": hist, "state": (p, opt.m, opt.v)}
                r["prefill"], r["prefill_cache"] = jax.jit(steps.make_prefill_step(cfg))(
                    params, inputs["prompt"])
                if cfg.family != "audio":
                    b = {"tokens": jnp.asarray(inputs["next"]["tokens"]),
                         "cache_pos": jnp.int32(PROMPT)}
                    if cfg.family == "vlm":
                        b["positions"] = jnp.full((4, 3, 1), PROMPT, jnp.int32)
                    r["decode4"] = jax.jit(steps.make_serve_step(cfg))(params, full, b)[0]
            out[arch, profile, shape] = jax.device_get(r)
pickle.dump(out, open(sys.argv[1], "wb"))
print("OK")
"""


def _tensors(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _decode_batch(cfg, tokens, pos):
    b = {"tokens": tokens, "cache_pos": torch.tensor(pos)}
    if cfg.family == "vlm":
        b["positions"] = torch.full((tokens.shape[0], 3, 1), pos, dtype=torch.int32)
    return b


def profile_worker(group, device, archs, shared, caches, extra):
    """Every arch under each profile at both meshes on this worker: the
    train run's history and its state gathered (kept by worker 0), the
    prefill's last logits (this data shard's rows) and cache, and the
    batch-4 decode step's logits from this worker's block of the unsharded
    decode cache. ``extra`` (fn, args), when given: ``fn(group, *args)``'s
    results are added."""
    out = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        full = convert.lm_params(shared["inits"][arch], cfg, device="cpu")
        inputs = shared["inputs"][arch]
        for profile in PROFILES:
            rules = sharding.rules_for(profile)
            for shape in MESHES:
                with sharding.use_mesh(None, rules):
                    params, opt, hist = ptrain.train(arch=arch, mesh_shape=shape, params=full,
                                                     device="cpu", group=group, **RUN)
                mesh = pmesh.make_mesh(shape, ("data", "model"), group)
                r = {"hist": hist}
                with sharding.use_mesh(mesh, rules):
                    specs = lm.param_specs(cfg)
                    state = tuple(P.gather_params(t, mesh, specs) for t in (params, opt.m, opt.v))
                    blocks = P.shard_params(full, mesh, specs)
                    with torch.no_grad():
                        r["prefill"], cache = steps.make_prefill_step(cfg)(
                            blocks, _tensors(inputs["prompt"]))
                        if not cfg.encoder_only:
                            r["prefill_cache"] = cache
                            c4 = steps.local_cache({k: v.clone() for k, v in caches[
                                arch, "cache"].items()}, cfg, ShapeSpec("d", "decode", CACHE, 4))
                            r["decode4"] = steps.make_serve_step(cfg)(blocks, c4, _decode_batch(
                                cfg, torch.from_numpy(inputs["next"]["tokens"]), PROMPT))[0]
                r["state"] = state if group.rank == 0 else None
                out[arch, profile, shape] = r
    if extra is not None:
        out.update(extra[0](group, *extra[1]))
    return out


def _unsharded_caches(arch, shared):
    """The port's unsharded prefill cache of the arch's prompt and the
    48-position decode cache it fills (the decode step's start)."""
    cfg = get_config(arch, smoke=True)
    full = convert.lm_params(shared["inits"][arch], cfg, device="cpu")
    with torch.no_grad():
        _, pc = steps.make_prefill_step(cfg)(full, _tensors(shared["inputs"][arch]["prompt"]))
    cache = lm.init_cache(cfg, 4, CACHE, device="cpu")
    for k, v in cache.items():
        if k in ("k", "v"):
            v[:, :, :, :PROMPT] = pc[k]
        else:
            v.copy_(pc[k])
    return {(arch, "prefill_cache"): pc, (arch, "cache"): cache}


def run_parity(tmp, arch_groups, extra_from_inits=None):
    """(reference, each worker's results, the port's unsharded caches): the
    JAX subprocesses (one a group of archs) and the port's workers
    overlapped, the workers started as soon as every subprocess has written
    its initial weights and inputs."""
    # one thread a JAX process: the compiles are serial, and the port's four
    # workers share the cores
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    files = [(tmp / f"ref_{i}.pkl", tmp / f"init_{i}.pkl") for i in range(len(arch_groups))]
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(path),
                               str(init), ",".join(group), GRAD_ARCH], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for group, (path, init) in zip(arch_groups, files)]
    archs = tuple(a for g in arch_groups for a in g)
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
        caches = {}
        for arch in archs:
            if not get_config(arch, smoke=True).encoder_only:
                caches.update(_unsharded_caches(arch, shared))
        extra = extra_from_inits(shared) if extra_from_inits else None
        workers = dfw.run_workers(4, profile_worker, archs, shared, caches, extra, device="cpu")
        errs = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ref = {"shared": shared}
    for p, err, (path, _) in zip(procs, errs, files):
        assert p.returncode == 0, err[-4000:]
        ref.update(pickle.loads(path.read_bytes()))
    return ref, workers, caches


def extras(group, inits, ckpt_sp, ckpt_tp):
    """The seq_act gradient sum, checkpoints across profiles, and
    ``spmd.scatter``/``split`` (module doc); worker 0's results."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.comm import spmd
    from repro_torch.data import SyntheticLMStream, device_put_batch

    out = {}
    cfg = get_config(GRAD_ARCH, smoke=True)
    batch = device_put_batch(SyntheticLMStream(cfg, ShapeSpec("t", "train", 32, 4))
                             .batch_for_step(0), "cpu")
    for profile in PROFILES:
        mesh = pmesh.make_mesh((2, 2), ("data", "model"), group)
        with sharding.use_mesh(mesh, sharding.rules_for(profile)):
            specs = lm.param_specs(cfg)
            blocks = P.shard_params(inits, mesh, specs)
            _, g = lm.value_and_grad(blocks, batch, cfg)
            summed = P.gather_params(g, mesh, specs)
            orig = lm._sum_replicated_grads

            def over_data_alone(grads, cfg_):  # no "seq_act" axis active
                with sharding.whole_sequence():
                    orig(grads, cfg_)

            try:
                lm._sum_replicated_grads = over_data_alone
                _, g = lm.value_and_grad(blocks, batch, cfg)
            finally:
                lm._sum_replicated_grads = orig
            parts = P.gather_params(g, mesh, specs)
        out["seq_sum", profile] = (summed, parts) if group.rank == 0 else None

    # a checkpoint written under sp at (2, 2) restored under tp at (1, 4), and
    # one written under tp at (2, 2) restored under sp at (1, 4): full leaves
    for write, read, ck in (("sp", "tp", ckpt_sp), ("tp", "sp", ckpt_tp)):
        with sharding.use_mesh(None, sharding.rules_for(write)):
            params, opt, _ = ptrain.train(arch=GRAD_ARCH, mesh_shape=(2, 2), params=inits,
                                          ckpt_dir=ck, device="cpu", group=group, **RUN)
        mesh = pmesh.make_mesh((2, 2), ("data", "model"), group)
        with sharding.use_mesh(mesh, sharding.rules_for(write)):
            specs = lm.param_specs(cfg)
        trained = tuple(P.gather_params(t, mesh, specs) for t in (params, opt.m, opt.v))
        mesh = pmesh.make_mesh((1, 4), ("data", "model"), group)
        rules = sharding.rules_for(read)
        with sharding.use_mesh(None, rules):
            step, params, opt = ptrain.restore(CheckpointStore(ck), cfg, device="cpu",
                                               mesh=mesh)
        with sharding.use_mesh(mesh, rules):
            specs = lm.param_specs(cfg)
        restored = tuple(P.gather_params(t, mesh, specs) for t in (params, opt.m, opt.v))
        out["ckpt", write, read] = (step, all(
            torch.equal(a, b) for t, u in zip(trained, restored, strict=True)
            for a, b in zip(tree_leaves(t), tree_leaves(u), strict=True)))

    # spmd.scatter and spmd.split against the gathered computation, over the
    # whole group (dim 0) and over the model axis of a (2, 2) mesh (dim 1)
    mesh = pmesh.make_mesh((2, 2), ("data", "model"), group)
    for name, grp, dim in (("world", group, 0), ("model", mesh.group_of(("model",)), 1)):
        gen = torch.Generator().manual_seed(5)
        base = torch.randn(8, 12, generator=gen, dtype=torch.float64)
        w = torch.randn(8, 12, generator=gen, dtype=torch.float64)  # the loss's weights
        n = base.shape[dim] // grp.size
        mine = slice(grp.rank * n, (grp.rank + 1) * n)
        block = (lambda t: t[mine]) if dim == 0 else (lambda t: t[:, mine])
        x = (base * (grp.rank + 1)).requires_grad_(True)  # partial: the sum is 10 base at 4
        before = group.tally.snapshot()
        y = spmd.scatter(x, dim, grp)
        (y * block(w)).sum().backward()
        scale = sum(range(1, grp.size + 1))
        r = {"scatter_out": torch.allclose(y, block(base * scale), rtol=1e-12, atol=0),
             "scatter_grad": torch.equal(x.grad, w)}
        xs = base.clone().requires_grad_(True)  # replicated
        z = spmd.split(xs, dim, grp)
        (z * block(w)).sum().backward()
        r.update(split_out=torch.equal(z, block(base)), split_grad=torch.equal(xs.grad, w),
                 tally=_tally_delta(before, group.tally.snapshot()))
        out["spmd", name] = r
    return out if group.rank == 0 else {}


def _tally_delta(before, after):
    """{kind: (calls, bytes)} of the collectives between two snapshots."""
    return {k: (after["calls"][k] - before["calls"].get(k, 0),
                after["bytes"][k] - before["bytes"].get(k, 0))
            for k in after["calls"] if after["calls"][k] != before["calls"].get(k, 0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_sp")
    return run_parity(d, ARCH_GROUPS, extra_from_inits=lambda shared: (extras, (
        convert.lm_params(shared["inits"][GRAD_ARCH], get_config(GRAD_ARCH, smoke=True),
                          device="cpu"), str(d / "ckpt_sp"), str(d / "ckpt_tp"))))


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def rows(port, key, name, shape):
    """The global (B, ...) output from each data shard's rows."""
    d, m = shape
    return np.concatenate([port[i * m][key][name].numpy() for i in range(d)])


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def hold_state(got, want, arch):
    """Each leaf of (params, AdamW m, AdamW v): max |got - want| over its
    max |want| (0 where both are 0) within ``STATE_TOL``."""
    names = _leaf_names(got[0])
    for which, (g_tree, w_tree, tol) in enumerate(zip(got, want, STATE_TOL, strict=True)):
        for name, g, w in zip(names, tree_leaves(g_tree), tree_leaves(w_tree), strict=True):
            e = float((g.double() - w.double()).abs().max()
                      / w.double().abs().max().clamp_min(1e-30))
            bound = max(tol, A_LOG_TOL) if name.endswith("/a_log") else tol
            assert e <= bound, (arch, ("params", "m", "v")[which], name, e)


def check_train(ref, port, arch, profile, shape):
    key = (arch, profile, shape)
    got, want = port[0][key]["hist"], ref[key]["hist"]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
    for w in port:  # every worker logs the global loss
        assert w[key]["hist"] == got
    cfg = get_config(arch, smoke=True)
    hold_state(port[0][key]["state"],
               [convert.lm_params(t, cfg, device="cpu") for t in ref[key]["state"]], arch)


class _Rank:
    """The attributes a ``Mesh`` reads of a worker group: a layout at one
    worker's coordinates, to cut a full tensor to that worker's block."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def split(self, parts):
        return tuple(next(p for p in parts if self.rank in p))


def check_serve(ref, port, caches, arch, profile, shape):
    key = (arch, profile, shape)
    close(rows(port, key, "prefill", shape), ref[key]["prefill"])
    cfg = get_config(arch, smoke=True)
    for w in port:  # every model shard of a data shard gives its rows' full logits
        assert w[key]["prefill"].shape[-1] == cfg.vocab_size
    if cfg.encoder_only:
        return
    close(rows(port, key, "decode4", shape), ref[key]["decode4"])
    full = _tensors(ref[key]["prefill_cache"])
    for rank, w in enumerate(port):  # the prefill's cache: this worker's block of the reference's
        mesh = pmesh.Mesh(shape, ("data", "model"), _Rank(rank, 4))
        with sharding.use_mesh(mesh, sharding.rules_for(profile)):
            want = steps.local_cache(full, cfg, ShapeSpec("p", "decode", PROMPT, 4))
        got = w[key]["prefill_cache"]
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == want[name].shape, (name, got[name].shape)
            close(got[name].numpy(), want[name].numpy())
    for name, v in ref[arch, "prefill_cache"].items():  # the unsharded cache is the reference's
        close(caches[arch, "prefill_cache"][name].numpy(), v)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_train_matches_reference(ref, port, arch, profile, shape):
    check_train(ref, port, arch, profile, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_prefill_and_decode_match_reference(ref, port, runs, arch, profile,
                                                              shape):
    check_serve(ref, port, runs[2], arch, profile, shape)


@pytest.mark.parametrize("profile", PROFILES)
def test_seq_act_gradient_sum_over_the_sequence_shards(ref, port, profile):
    """Under a sequence split a norm scale's gradient (here every layer's
    ``ln1`` and ``ln2`` and the final norm) is a part on each worker, its
    rows' (``sp``), or its rows' and heads' (``msp``): summed over the
    "seq_act" axis as well as the data axis it matches the reference's
    gradient; summed over the data axis alone it does not."""
    cfg = get_config(GRAD_ARCH, smoke=True)
    want = convert.lm_params(ref["grad"], cfg, device="cpu")
    summed, parts = port[0]["seq_sum", profile]
    scales = [("final_norm",)] + [("layers", i, n) for i in range(cfg.num_layers)
                                  for n in ("ln1", "ln2")]

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for path in scales:
        w = leaf(want, path)
        scale = float(w.abs().max())
        assert float((leaf(summed, path) - w).abs().max()) <= 1e-4 * scale, path
        assert float((leaf(parts, path) - w).abs().max()) > 0.1 * scale, path
    for g, w in zip(tree_leaves(summed), tree_leaves(want), strict=True):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max().clamp_min(1e-30))


def test_sp_checkpoint_restores_under_tp_and_back(port):
    """A checkpoint holds full leaves: one written under ``sp`` on (2, 2)
    restores under ``tp`` on (1, 4), one written under ``tp`` restores
    under ``sp``, each with the trained state's bits."""
    for write, read in (("sp", "tp"), ("tp", "sp")):
        step, same = port[0]["ckpt", write, read]
        assert step == RUN["steps"] and same, (write, read)


@pytest.mark.parametrize("over", ["world", "model"])
def test_spmd_scatter_and_split_over_gloo(port, over):
    """``scatter``: the reduce-scatter of the workers' partial tensors (their
    sum's block), its gradient the all-gather of the blocks' (the whole on
    every worker); ``split``: a replicated tensor's block, its gradient
    gathered whole. Over the four workers along dim 0 and over a (2, 2)
    mesh's model axis along dim 1, in f64. The group's tally counts them:
    gloo reduce-scatters as an all-reduce of the whole (twice its bytes),
    and the two backward all-gathers move the whole tensor each."""
    r = port[0]["spmd", over]
    assert r["scatter_out"] and r["scatter_grad"] and r["split_out"] and r["split_grad"]
    whole = 8 * 12 * 8  # bytes of the f64 (8, 12) tensor
    assert r["tally"] == {"all_reduce": (1, 2 * whole), "all_gather": (2, 2 * whole)}
