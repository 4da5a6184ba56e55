"""The sequence-parallel profiles ``sp`` and ``msp`` for the hybrid
family: the port's sharded training, prefill and decode over four gloo CPU
workers against the JAX package jitted under ``use_mesh(mesh,
rules_for(profile))``, as tests/test_torch_mesh_sp.py holds the dense
family (its harness: ``run_parity``, ``check_train``, ``check_serve``);
the vlm and audio families are in tests/test_torch_mesh_sp_vlm_audio.py.

One subprocess runs the JAX package on 8 fake CPU devices (meshes on the
first 4): zamba2-2.7b (4 Mamba-2 layers of 8 heads and a shared attention
+ MLP block applied twice) smoke config in f32, from
``init_params(PRNGKey(0))``. Under each profile at meshes (2, 2) and (1,
4): two AdamW steps of 4 x 32 tokens, the prefill of 4 prompts of 32, its
cache, and the batch-4 decode step from a 48-position cache that the
unsharded prefill filled. Mamba-2 runs its chunk scan and conv on the
gathered sequence.

Tolerances, those of tests/test_torch_mesh_families.py: losses rtol 1e-5;
after the two steps the worst leaf's max |difference| over that leaf's max
|value| within 1e-3 for the parameters and 1e-4 for AdamW's m and v,
except Mamba-2's ``a_log`` (1e-3: its gradient takes each decay as a
difference of two cumulative sums); logits and caches rtol 1e-4 with an
atol of 1e-4 of the largest |value|.
"""
import pytest
import torch

from test_torch_mesh_sp import MESHES, PROFILES, check_serve, check_train, run_parity

torch.set_num_threads(2)

ARCH_GROUPS = (("zamba2_2_7b",),)
ARCHS = tuple(a for g in ARCH_GROUPS for a in g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_parity(tmp_path_factory.mktemp("mesh_sp_families"), ARCH_GROUPS)


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


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
