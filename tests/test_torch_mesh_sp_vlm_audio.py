"""The sequence-parallel profiles ``sp`` and ``msp`` for the vlm and audio
families: the port's sharded training, prefill and decode over four gloo
CPU workers against the JAX package jitted under ``use_mesh(mesh,
rules_for(profile))``, as tests/test_torch_mesh_sp.py holds the dense
family (its harness: ``run_parity``, ``check_train``, ``check_serve``).

Two subprocesses run the JAX package on 8 fake CPU devices each (meshes on
the first 4): qwen2-vl-72b (vlm: 16 vision embeddings ahead of 16 text
tokens, M-RoPE) and hubert-xlarge (audio: bidirectional, one label a
frame) smoke configs in f32, from ``init_params(PRNGKey(0))``. Under each
profile at meshes (2, 2) and (1, 4): two AdamW steps of 4 x 32 positions
(vlm: 16 of them vision), the prefill of 4 prompts of 32 (hubert: the
encoder's logits at every frame) and, for qwen2-vl, its cache and the
batch-4 decode step from a 48-position cache that the unsharded prefill
filled. The sequence split covers the concatenated sequence: at (1, 4)
qwen2-vl's first two workers hold vision rows only, and their loss takes
no position (the text positions are kept by their global index).

Tolerances, those of tests/test_torch_mesh_families.py: losses rtol 1e-5;
after the two steps the worst leaf's max |difference| over that leaf's max
|value| within 1e-3 for the parameters and 1e-4 for AdamW's m and v;
logits and caches rtol 1e-4 with an atol of 1e-4 of the largest |value|.
"""
import pytest
import torch

from test_torch_mesh_sp import MESHES, PROFILES, check_serve, check_train, run_parity

torch.set_num_threads(2)

ARCH_GROUPS = (("qwen2_vl_72b",), ("hubert_xlarge",))
ARCHS = tuple(a for g in ARCH_GROUPS for a in g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_parity(tmp_path_factory.mktemp("mesh_sp_vlm_audio"), ARCH_GROUPS)


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
