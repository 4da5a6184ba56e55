"""The port's mesh layouts and sharding specs (``repro_torch.launch.mesh``,
``sharding``, ``params``, ``steps``) against the JAX package's, on the CPU.

One subprocess runs the JAX package on 512 fake CPU devices (the device
count locks at the first JAX start in a process) and resolves, under each
layout, every architecture's parameter specs (``param_pspecs`` of
``jax.eval_shape(init_params)``, smoke and full widths), the batch, cache
and logits specs of every applicable shape, and the ``tp``/``sp``/``msp``
rule sets. The port resolves the same on layouts without processes (meta
tensors for the parameters). Specs compare exactly. The port keeps layers
as a list, so a layer leaf's spec is the reference's without its leading
(stacked-layer) None. The parameter, batch, logits and cache specs are
compared under each profile: ``tp`` (the default rules) and the
sequence-parallel ``sp`` and ``msp`` (``use_mesh(mesh, rules_for(p))``).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding, steps
from repro_torch.models import lm
from repro_torch.models.config import applicable_shapes

SRC = str(Path(__file__).resolve().parent.parent / "src")

LAYOUTS = {
    "2x4": ((2, 4), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}

_JAX_SCRIPT = """
import json, math, sys
import jax
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import ARCH_IDS, get_config
from repro.launch import sharding, steps
from repro.launch.params import param_pspecs
from repro.models import lm
from repro.models.config import applicable_shapes

layouts = json.loads(sys.argv[2])

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

out = {"rules": {p: sharding.rules_for(p) for p in ("tp", "sp", "msp")}}
abstract = {(a, smoke): jax.eval_shape(lambda k: lm.init_params(get_config(a, smoke=smoke), k),
                                       jax.random.PRNGKey(0))
            for a in ARCH_IDS for smoke in (True, False)}
for name, (shape, axes) in layouts.items():
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:math.prod(shape)]).reshape(shape),
                             tuple(axes))
    with sharding.use_mesh(mesh):
        out[name + "|resolve"] = [enc(sharding.pspec(*l)) for l in (
            ("heads", "seq_act"), ("batch", "fsdp"), ("batch_tp", "heads"), ("seq", "batch"))]
        with sharding.use_mesh(mesh, sharding.rules_for("msp")):
            out[name + "|resolve_msp"] = enc(sharding.pspec("batch", "heads", "seq_act", None))
    for profile in ("tp", "sp", "msp"):
        key = name if profile == "tp" else f"{name}|{profile}"
        with sharding.use_mesh(mesh, sharding.rules_for(profile)):
            for (a, smoke), ap in abstract.items():
                cfg = get_config(a, smoke=smoke)
                flat = jax.tree_util.tree_flatten_with_path(
                    param_pspecs(ap), is_leaf=lambda x: isinstance(x, P))[0]
                rec = {"params": {"/".join(str(getattr(k, "key", k)) for k in path): enc(s)
                                  for path, s in flat}}
                if smoke:
                    shapes = {}
                    for sname, shp in applicable_shapes(cfg).items():
                        shp = type(shp)(shp.name, shp.kind, 64, shp.global_batch)
                        r = {"batch": {k: enc(v) for k, v in steps.batch_pspecs(cfg, shp).items()},
                             "logits": enc(steps.logits_pspec(cfg, shp)),
                             "logits_full": enc(steps.logits_pspec(cfg, shp, full_seq=True))}
                        if not cfg.encoder_only:
                            r["cache"] = {k: enc(v) for k, v in steps.cache_pspecs(cfg, shp).items()}
                        shapes[sname] = r
                    rec["shapes"] = shapes
                out[f"{key}|{a}|{smoke}"] = rec
json.dump(out, open(sys.argv[1], "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), str(path),
         json.dumps({k: [list(s), list(a)] for k, (s, a) in LAYOUTS.items()})],
        capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(path.read_text())


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat_port(tree, prefix=""):
    """{path: spec} of a port spec tree; "layers" holds every layer's specs,
    which must agree, under the path of the first."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            firsts = [_flat_port(lp, "") for lp in v]
            assert all(f == firsts[0] for f in firsts)
            out.update({f"{prefix}layers/{p}": s for p, s in firsts[0].items()})
        elif isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _enc(v)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(ref, arch, smoke, layout):
    _hold_param_specs(ref, arch, smoke, layout, "tp")


@pytest.mark.parametrize("profile", ("sp", "msp"))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference_under_sequence_profiles(ref, arch, smoke, layout, profile):
    """Under "sp" the attention and MLP weights lose their model split and
    gain it on the FSDP dim; "msp" keeps "tp"'s."""
    _hold_param_specs(ref, arch, smoke, layout, profile)
    if profile == "sp" and layout == "2x4":
        cfg = get_config(arch, smoke=smoke)
        with sharding.use_mesh(pmesh.make_mesh(*LAYOUTS[layout]), sharding.rules_for("sp")):
            specs = lm.param_specs(cfg)
        if cfg.family != "ssm":
            wq = specs["layers"][0]["attn"]["wq"] if "attn" in specs["layers"][0] else \
                specs["shared"]["attn"]["wq"]
            assert wq == (("data", "model"), None)


def _key(layout, profile):
    return layout if profile == "tp" else f"{layout}|{profile}"


def _hold_param_specs(ref, arch, smoke, layout, profile):
    shape, axes = LAYOUTS[layout]
    cfg = get_config(arch, smoke=smoke)
    with sharding.use_mesh(pmesh.make_mesh(shape, axes), sharding.rules_for(profile)):
        got = _flat_port(lm.param_specs(cfg))
    want = ref[f"{_key(layout, profile)}|{arch}|{smoke}"]["params"]
    assert set(got) == set(want)
    for path, spec in got.items():
        w = want[path]
        if path.startswith("layers/"):
            w = w[1:]  # the stacked-layer dim
        assert spec == w, (path, spec, w)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_match_reference(ref, arch, layout):
    _hold_step_specs(ref, arch, layout, "tp")


@pytest.mark.parametrize("profile", ("sp", "msp"))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_match_reference_under_sequence_profiles(ref, arch, layout, profile):
    """Batch, logits and cache specs under "sp" and "msp" (the kv cache
    whole over the model axis under "sp", where "kv_heads" maps to none)."""
    _hold_step_specs(ref, arch, layout, profile)


def _hold_step_specs(ref, arch, layout, profile):
    shape, axes = LAYOUTS[layout]
    cfg = get_config(arch, smoke=True)
    want = ref[f"{_key(layout, profile)}|{arch}|True"]["shapes"]
    assert set(want) == set(applicable_shapes(cfg))
    with sharding.use_mesh(pmesh.make_mesh(shape, axes), sharding.rules_for(profile)):
        for sname, shp in applicable_shapes(cfg).items():
            shp = type(shp)(shp.name, shp.kind, 64, shp.global_batch)
            w = want[sname]
            assert {k: _enc(v) for k, v in steps.batch_pspecs(cfg, shp).items()} == w["batch"]
            assert _enc(steps.logits_pspec(cfg, shp)) == w["logits"]
            assert _enc(steps.logits_pspec(cfg, shp, full_seq=True)) == w["logits_full"]
            if not cfg.encoder_only:
                assert {k: _enc(v) for k, v in steps.cache_pspecs(cfg, shp).items()} == \
                    w["cache"]


def test_train_state_specs_mirror_the_parameters():
    cfg = get_config("qwen2_1_5b")
    with sharding.use_mesh(pmesh.make_mesh((2, 4), ("data", "model"))):
        aparams, aopt, pspecs, ospecs = steps.train_state_specs(cfg)
        assert pspecs == lm.param_specs(cfg)
    assert ospecs.step == () and ospecs.m == pspecs and ospecs.v == pspecs
    assert aparams["embed"].is_meta and aopt.m["embed"].shape == aparams["embed"].shape
    assert aopt.m["embed"].dtype == torch.float32 and pspecs["embed"] == ("model", "data")


def test_rules_and_resolve_match_reference(ref):
    for profile in ("tp", "sp", "msp"):
        got = {k: (list(v) if isinstance(v, tuple) else v)
               for k, v in sharding.rules_for(profile).items()}
        assert got == ref["rules"][profile]
    for name, (shape, axes) in LAYOUTS.items():
        mesh = pmesh.make_mesh(shape, axes)
        with sharding.use_mesh(mesh):
            got = [_enc(sharding.pspec(*lg)) for lg in (
                ("heads", "seq_act"), ("batch", "fsdp"), ("batch_tp", "heads"), ("seq", "batch"))]
            assert got == ref[name + "|resolve"]
            with sharding.use_mesh(mesh, sharding.rules_for("msp")):
                # heads and seq_act both map to model: the earlier dim keeps it
                got = _enc(sharding.pspec("batch", "heads", "seq_act", None))
                assert got == ref[name + "|resolve_msp"]
                if "model" in axes:
                    assert got[1] == "model" and got[2] is None


def test_mesh_layout_without_processes():
    mesh = pmesh.make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16} and mesh.size == 512
    assert mesh.rank == 0 and mesh.coords == {"pod": 0, "data": 0, "model": 0}
    with pytest.raises(RuntimeError):  # a layout has no process groups
        mesh.group_of(("model",))
    with sharding.use_mesh(mesh):
        assert sharding.data_axes() == ("pod", "data")
        assert sharding.axes_size("batch") == 32 and sharding.axes_size("fsdp") == 32
        assert sharding.seq_axes() == ("data",) and sharding.model_axes() == ("model",)
    assert sharding.active_mesh() is None and sharding.axes_size("batch") == 1


def test_mesh_rank_layout_is_row_major():
    class Group:  # the attributes Mesh reads of a WorkerGroup
        def __init__(self, rank, size):
            self.rank, self.size = rank, size

        def split(self, parts):
            return tuple(next(p for p in parts if self.rank in p))

    for rank in range(8):
        mesh = pmesh.make_mesh((2, 4), ("data", "model"), Group(rank, 8))
        assert mesh.coords == {"data": rank // 4, "model": rank % 4}
        assert mesh.index(("data", "model")) == rank
        assert mesh.group_of(("model",)) == tuple(range(rank // 4 * 4, rank // 4 * 4 + 4))
        assert mesh.group_of(("data",)) == (rank % 4, rank % 4 + 4)
    with pytest.raises(ValueError):
        pmesh.make_mesh((2, 2), ("data", "model"), Group(0, 8))
    with pytest.raises(ValueError, match="needs 256 workers"):
        pmesh.make_production_mesh(group=Group(0, 8))


def test_mesh_constants_are_the_h100s():
    assert pmesh.PEAK_FLOPS_BF16 == 989e12 and pmesh.HBM_BW == 3.35e12
    assert pmesh.NVLINK_BW == 450e9
    assert not hasattr(pmesh, "ICI_BW") and not hasattr(pmesh, "DCN_BW")
