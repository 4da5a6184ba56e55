"""Sharded LM training of the port (``launch.train.train(mesh_shape=...)``
over four gloo CPU workers) against the JAX package's
``repro.launch.train.train(mesh_shape=...)``, elastic checkpoints both ways,
and ``launch.multihost train --mesh`` over environment-launched processes.

One subprocess runs the JAX package on 8 fake CPU devices (meshes on the
first 4): qwen2-1.5b (dense, GQA with 2 kv heads), rwkv6-7b (ssm),
arctic-480b and llama4-scout (moe: 8 experts top-2 with a dense residual
MLP, 4 experts top-1) smoke configs, 2 steps of 4 x 32 tokens, at meshes
(2, 2) and (1, 4), from ``init_params(PRNGKey(0))``, which the port starts
from too (``convert.lm_params``); its qwen2 (2, 2) run writes a
checkpoint. At (1, 4) the model axis does not divide qwen2's kv heads
(each worker computes both and its q head reads its own) nor rwkv6's 2
heads (each worker runs both, and keeps its block of ``wo``'s rows); the
moe experts are split over the model axis (2 or 1 a worker). One 4-process
spawn runs the port's side.

The moe capacity is per data shard, in both packages: at (2, 2) each data
shard routes its 64 tokens with a capacity of 24 slots, where one device's
128 tokens get 40, so other tokens are dropped (the 40 bind at these
sizes). The sharded runs are held to the reference's at the configured
capacity factor; against the port's unsharded run, at (1, 4) (one data
shard: the same capacity) at the configured factor, and at (2, 2) at a
factor of 32, under which no token drops on either side. The Switch loss
is per data shard too (the mean over the data shards of each shard's
E sum_e frac_e mean_p_e, a product of means over its own tokens), so the
unsharded run at (2, 2)'s side takes the mean of its two row halves' Switch
losses in each moe layer (``_aux_per_data_shard``): every other part of
the loss and of its gradient is the one-device computation's.

Tolerances: losses rtol 1e-5, as tests/test_torch_train.py holds the
unsharded run (the JAX package's own mesh and unsharded losses differ by
about 1.6e-7 relative, f32 sums in other orders); the port's sharded
losses against its unsharded ones rtol 2e-6. Checkpoints restore bit for
bit on any mesh.

The losses alone cannot see the size of a gradient (AdamW's first update
is about sign(g)), so the trained parameters and AdamW's m and v, gathered
from the workers, are held leaf by leaf against the reference's and the
unsharded run's: the worst leaf's max |difference| over that leaf's max
|value| within 1e-4 for m and v (measured: at most 1e-5) and 1e-3 for the
parameters (at most 1.6e-4: AdamW divides tiny gradients by their own
size, so their f32 noise moves the parameters by up to the step). A
gradient scaled by 2 on any leaf puts its m off by 1 and its v by 3 on
that scale.
"""
import contextlib
import dataclasses
import os
import pickle
import re
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.launch import dfw
from repro_torch.launch import params as P
from repro_torch.launch import train as ptrain
from repro_torch.models import lm
from repro_torch.optim.compression import tree_leaves

SRC = str(Path(__file__).resolve().parent.parent / "src")
ARCHS = ("qwen2_1_5b", "rwkv6_7b", "arctic_480b", "llama4_scout_17b_a16e")
MOE = ("arctic_480b", "llama4_scout_17b_a16e")
NO_DROP = 32.0  # a moe capacity factor under which no token drops
MESHES = ((2, 2), (1, 4))
RUN = dict(steps=2, seq_len=32, global_batch=4, log_every=1)
# (params, AdamW m, AdamW v) after the 2 steps: the worst leaf's max error
# over that leaf's max |.| (module doc)
STATE_TOL = {"reference": (1e-3, 1e-4, 1e-4), "unsharded": (1e-3, 1e-4, 1e-4)}

_JAX_SCRIPT = """
import os, pickle, sys
import jax
from repro.configs import get_config
from repro.launch import train
from repro.models import lm

run = dict(steps=2, seq_len=32, global_batch=4, log_every=1)
inits = {arch: jax.device_get(lm.init_params(get_config(arch, smoke=True),
                                             jax.random.PRNGKey(0)))
         for arch in ("qwen2_1_5b", "rwkv6_7b", "arctic_480b", "llama4_scout_17b_a16e")}
pickle.dump(inits, open(sys.argv[3] + ".tmp", "wb"))
os.rename(sys.argv[3] + ".tmp", sys.argv[3])  # the port's runs start from these now
out = {}
for arch in ("qwen2_1_5b", "rwkv6_7b", "arctic_480b", "llama4_scout_17b_a16e"):
    for shape in ((2, 2), (1, 4)):
        ck = sys.argv[2] if (arch, shape) == ("qwen2_1_5b", (2, 2)) else None
        params, opt, hist = train.train(arch=arch, mesh_shape=shape, ckpt_dir=ck, **run)
        out[arch, shape] = hist
        out[arch, shape, "state"] = jax.device_get((params, opt.m, opt.v))
        if ck:
            out["ckpt_params"] = jax.device_get(params)
pickle.dump(out, open(sys.argv[1], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the port's workers, overlapped: the JAX
    script writes its initial parameters first, the port's runs start from
    them while the JAX package trains. Returns (reference, port) results."""
    d = tmp_path_factory.mktemp("mesh_train")
    path, ckpt, init = d / "ref.pkl", d / "jax_ckpt", d / "init.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(path),
                             str(ckpt), str(init)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.time() + 300
        while not init.exists() and proc.poll() is None and time.time() < deadline:
            time.sleep(0.2)
        assert init.exists(), proc.communicate(timeout=60)[1][-4000:]
        inits = {a: convert.lm_params(t, get_config(a, smoke=True), device="cpu")
                 for a, t in pickle.loads(init.read_bytes()).items()}
        port_ck = str(d / "port_ckpt")
        port = dfw.run_workers(4, _mesh_worker, inits, port_ck, device="cpu")[0]
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ref = pickle.loads(path.read_bytes())
    ref["ckpt_dir"] = str(ckpt)
    port.update(ckpt_dir=port_ck, inits=inits,
                jax_at_1x4=dfw.run_workers(4, _restore_worker, str(ckpt), device="cpu")[0])
    return ref, port


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def _restore_worker(group, device, ckpt):
    """The qwen2 checkpoint at ``ckpt`` restored at (1, 4): (full params,
    full AdamW m, step) gathered on worker 0."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding

    cfg = get_config("qwen2_1_5b", smoke=True)
    mesh = M.make_mesh((1, 4), ("data", "model"), group)
    with sharding.use_mesh(mesh):
        specs = lm.param_specs(cfg)
    _, params, opt = ptrain.restore(CheckpointStore(ckpt), cfg, device="cpu", mesh=mesh)
    out = (P.gather_params(params, mesh, specs), P.gather_params(opt.m, mesh, specs),
           int(opt.step))
    return out if group.rank == 0 else None


def _mesh_worker(group, device, inits, port_ckpt):
    """Every train run of both archs at both meshes; the qwen2 (2, 2) run
    writes ``port_ckpt``, then restored at (1, 4) (worker 0 returns the
    full leaves)."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding

    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for shape in MESHES:
            ck = port_ckpt if (arch, shape) == ("qwen2_1_5b", (2, 2)) else None
            params, opt, hist = ptrain.train(arch=arch, mesh_shape=shape, params=inits[arch],
                                             ckpt_dir=ck, device="cpu", group=group, **RUN)
            out[arch, shape] = hist
            mesh = M.make_mesh(shape, ("data", "model"), group)
            with sharding.use_mesh(mesh):
                specs = lm.param_specs(cfg)
            out[arch, shape, "state"] = tuple(P.gather_params(t, mesh, specs)
                                              for t in (params, opt.m, opt.v))
            if ck:
                out["trained"] = out[arch, shape, "state"][0]
        if arch in MOE:  # (2, 2) where no token drops, against the unsharded run
            no_drop = dataclasses.replace(cfg, moe_capacity_factor=NO_DROP)
            params, opt, hist = ptrain.train(arch=arch, cfg=no_drop, mesh_shape=(2, 2),
                                             params=inits[arch], device="cpu", group=group, **RUN)
            mesh = M.make_mesh((2, 2), ("data", "model"), group)
            with sharding.use_mesh(mesh):
                specs = lm.param_specs(no_drop)
            out[arch, "no_drop"] = hist, tuple(P.gather_params(t, mesh, specs)
                                               for t in (params, opt.m, opt.v))
    out["port_at_1x4"] = _restore_worker(group, device, port_ckpt)
    out["remat_in_another_thread"] = _remat_backward_in_another_thread(group, inits)
    return out if group.rank == 0 else None


def _remat_backward_in_another_thread(group, inits):
    """qwen2 with remat="full" at (2, 2): the gradients of a backward run in
    another thread (where autograd runs a CUDA backward: the mesh context of
    the forward's thread is not set there, and the checkpointed layers'
    recomputation must still run sharded) equal the same thread's."""
    import dataclasses
    import threading

    from repro_torch.data import SyntheticLMStream, device_put_batch
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding
    from repro_torch.models.config import ShapeSpec

    cfg = dataclasses.replace(get_config("qwen2_1_5b", smoke=True), remat="full")
    mesh = M.make_mesh((2, 2), ("data", "model"), group)
    batch = device_put_batch(SyntheticLMStream(cfg, ShapeSpec("t", "train", 32, 4))
                             .batch_for_step(0), "cpu")
    with sharding.use_mesh(mesh):
        params = P.shard_params(inits["qwen2_1_5b"], mesh)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def loss():
        with sharding.use_mesh(mesh):
            return lm.loss_fn(params, batch, cfg)[0]

    same = torch.autograd.grad(loss(), leaves)
    got, other = {}, loss()

    def backward():
        try:
            got["grads"] = torch.autograd.grad(other, leaves)
        except Exception as e:  # noqa: BLE001 - reported to the test
            got["error"] = repr(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    if "error" in got:
        return got["error"]
    return all(torch.equal(a, b) for a, b in zip(got["grads"], same, strict=True))


def _state_errs(got, want):
    """For each of (params, AdamW m, AdamW v): the worst leaf's max |got -
    want| over its own max |want|, and that leaf's index."""
    out = []
    for g_tree, w_tree in zip(got, want, strict=True):
        errs = [float((g.double() - w.double()).abs().max() / w.double().abs().max())
                for g, w in zip(tree_leaves(g_tree), tree_leaves(w_tree), strict=True)]
        out.append((max(errs), int(np.argmax(errs))))
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_reference(ref, port, arch, shape):
    got, want = port[arch, shape], ref[arch, shape]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
    cfg = get_config(arch, smoke=True)
    want_state = [convert.lm_params(t, cfg, device="cpu") for t in ref[arch, shape, "state"]]
    errs = _state_errs(port[arch, shape, "state"], want_state)
    print(arch, shape, "against the reference", errs)
    assert all(e <= tol for (e, _), tol in zip(errs, STATE_TOL["reference"])), errs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_unsharded(port, arch):
    """Each mesh's run against the unsharded run from the same weights; a
    moe config at (2, 2) at the capacity factor NO_DROP on both sides
    (module doc)."""
    cfg = get_config(arch, smoke=True)

    def unsharded(cfg):
        return ptrain.train(arch=arch, cfg=cfg, params=convert.lm_params(
            convert_back(port["inits"][arch]), cfg, device="cpu"), device="cpu", **RUN)

    params, opt, hist = unsharded(cfg)
    runs = {shape: (port[arch, shape], port[arch, shape, "state"], (params, opt.m, opt.v), hist)
            for shape in MESHES}
    if arch in MOE:
        with _aux_per_data_shard(MESHES[0][0]):
            params, opt, hist = unsharded(dataclasses.replace(cfg, moe_capacity_factor=NO_DROP))
        runs[(2, 2)] = (*port[arch, "no_drop"], (params, opt.m, opt.v), hist)
    for shape, (got_hist, got_state, want_state, want_hist) in runs.items():
        np.testing.assert_allclose([v for _, v in got_hist], [v for _, v in want_hist],
                                   rtol=2e-6)
        errs = _state_errs(got_state, want_state)
        print(arch, shape, "against the unsharded run", errs)
        assert all(e <= tol for (e, _), tol in zip(errs, STATE_TOL["unsharded"])), errs


@contextlib.contextmanager
def _aux_per_data_shard(n_data):
    """Inside the block each ``moe.moe_block`` call returns its output and
    the mean of the Switch losses of its ``n_data`` row blocks (the data
    shards' rows; the Switch loss reads the routing alone, not the
    capacity), as a mesh of ``n_data`` data shards defines it."""
    from repro_torch.models import moe

    orig = moe.moe_block

    def per_shard(p, x, cfg):
        out, _ = orig(p, x, cfg)
        n = x.shape[0] // n_data
        return out, sum(orig(p, x[i * n:(i + 1) * n], cfg)[1] for i in range(n_data)) / n_data

    moe.moe_block = per_shard
    try:
        yield
    finally:
        moe.moe_block = orig


def convert_back(tree):
    """A port parameter tree as numpy leaves in the JAX package's layout
    (layers stacked), for ``convert.lm_params`` to rebuild a fresh copy."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = {n: _stack([lp[n] for lp in v]) for n in v[0]}
        elif isinstance(v, dict):
            out[k] = convert_back(v)
        else:
            out[k] = v.numpy().copy()
    return out


def _stack(parts):
    if isinstance(parts[0], dict):
        return {n: _stack([p[n] for p in parts]) for n in parts[0]}
    return np.stack([p.numpy() for p in parts])


def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


def test_remat_recomputes_under_the_forwards_mesh(port):
    assert port["remat_in_another_thread"] is True, port["remat_in_another_thread"]


def test_port_checkpoint_restores_on_any_mesh(port):
    cfg = get_config("qwen2_1_5b", smoke=True)
    params, m, step = port["port_at_1x4"]
    assert step == 2
    _same(params, port["trained"])
    at, p1, opt1 = ptrain.restore(CheckpointStore(port["ckpt_dir"]), cfg, device="cpu")
    assert at == 2 and int(opt1.step) == 2
    _same(p1, port["trained"])
    _same(opt1.m, m)


def test_jax_mesh_checkpoint_restores_into_a_port_mesh(ref, port):
    cfg = get_config("qwen2_1_5b", smoke=True)
    params, _, step = port["jax_at_1x4"]
    assert step == 2
    _same(params, convert.lm_params(ref["ckpt_params"], cfg, device="cpu"))


def test_port_mesh_checkpoint_restores_in_the_reference(port):
    import jax

    from repro.checkpoint import CheckpointStore as JStore
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw

    cfg = jget("qwen2_1_5b", smoke=True)
    aparams = jax.eval_shape(lambda k: jlm.init_params(cfg, k), jax.random.PRNGKey(0))
    like = {"params": aparams, "opt": jax.eval_shape(jadamw.init, aparams)}
    step, state, _ = JStore(port["ckpt_dir"]).restore(like=like)
    assert step == 2
    _same(convert.lm_params(jax.device_get(state["params"]), get_config("qwen2_1_5b", smoke=True),
                            device="cpu"), port["trained"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_train_mesh_over_launched_processes(tmp_path):
    """``python -m repro_torch.launch.multihost --device cpu train --mesh
    2x2`` in four processes joined through the environment (as torchrun
    sets it): the sharded run's losses are the one-process run's."""
    env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="4", LOCAL_WORLD_SIZE="4",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.multihost", "--device", "cpu", "train",
           "--arch", "qwen2_1_5b", "--mesh", "2x2", "--steps", "2", "--seq-len", "32",
           "--global-batch", "4"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    got = [float(x) for x in re.findall(r"loss=([0-9.]+)", outs[0][0])]
    assert "[multihost] 4 processes" in outs[0][0] and not re.findall("loss=", outs[1][0])
    _, _, hist = ptrain.train(arch="qwen2_1_5b", steps=2, seq_len=32, global_batch=4,
                              device="cpu", log_every=10)
    np.testing.assert_allclose(got, [v for _, v in hist], rtol=0, atol=1e-4)  # printed to 4 places
