"""The port's Mamba-2 block (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2``, on the CPU.

zamba2-2.7b's smoke config (d 64, ssm_head_dim 16, ssm_state 16, d_conv 4)
in f32, its ``init_mamba`` weights drawn by the JAX package and carried
across; inputs are numpy arrays from a seed. The conv and the decode
recurrence are held to 1e-5 of max|reference| (rtol 1e-5); the chunked scan
(S = 64 at ssm_chunk 32: two chunks) to 1e-4 of max, since its einsums
contract in another order than the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as jm
from repro_torch import configs
from repro_torch.models import mamba2 as pm

torch.set_num_threads(2)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _block(seed=0, **cfg_kw):
    """(JAX cfg, JAX params, port cfg, port params) of one Mamba-2 layer;
    dt_bias and d_skip redrawn away from their constant init, so the test
    sees their wiring."""
    cfg = dataclasses.replace(jax_get_config("zamba2_2_7b", smoke=True), **cfg_kw)
    pcfg = dataclasses.replace(configs.get_config("zamba2_2_7b", smoke=True), **cfg_kw)
    jp = jax.device_get(jm.init_mamba(jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    jp = dict(jp, dt_bias=rng.normal(0.0, 0.5, jp["dt_bias"].shape).astype(np.float32),
              d_skip=rng.normal(1.0, 0.5, jp["d_skip"].shape).astype(np.float32),
              conv_b=rng.normal(0.0, 0.1, jp["conv_b"].shape).astype(np.float32))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    return cfg, jp, pcfg, pp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    got = pm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # causal: a later input leaves earlier outputs as they were
    x2 = x.copy()
    x2[:, 5] += 1.0
    got2 = pm._causal_conv(torch.from_numpy(x2), torch.from_numpy(w), torch.from_numpy(b))
    assert torch.equal(got2[:, :5], got[:, :5]) and not torch.equal(got2[:, 5], got[:, 5])


def test_dims_and_split_match_jax():
    cfg, jp, pcfg, pp = _block()
    assert pm.dims(pcfg) == jm.dims(cfg)
    proj = np.random.default_rng(2).standard_normal((2, 3, pp["w_in"].shape[1]))
    proj = proj.astype(np.float32)
    for got, want in zip(pm._split(pcfg, torch.from_numpy(proj)), jm._split(cfg, proj)):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_block_matches_jax(return_state):
    """S = 64 at ssm_chunk 32: two chunks, the state carried across."""
    cfg, jp, pcfg, pp = _block(seed=3)
    x = _x(cfg, 2, 64, seed=4)
    want = jm.mamba_block(jp, jnp.asarray(x), cfg, return_state=return_state)
    got = pm.mamba_block(pp, torch.from_numpy(x), pcfg, return_state=return_state)
    if not return_state:
        _close(got, want, atol_rel=1e-4)
        return
    _close(got[0], want[0], atol_rel=1e-4)
    _close(got[1].h, want[1].h, atol_rel=1e-4)
    assert got[1].h.dtype == torch.float32
    _close(got[1].conv, want[1].conv)  # the last conv inputs (pre-conv projections)


def test_chunk_length_does_not_change_the_block():
    """The chunked scan is one function of the sequence: chunks of 16, 32
    and 64 agree (1e-4), as the reference's do."""
    cfg, jp, pcfg, pp = _block(seed=5)
    x = torch.from_numpy(_x(cfg, 1, 64, seed=6))
    outs = [pm.mamba_block(pp, x, dataclasses.replace(pcfg, ssm_chunk=q)) for q in (16, 32, 64)]
    for o in outs[1:]:
        _close(o, outs[0], atol_rel=1e-4)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    cfg, jp, pcfg, pp = _block()
    with pytest.raises(ValueError, match="chunk"):
        pm.mamba_block(pp, torch.from_numpy(_x(cfg, 1, 48, seed=0)), pcfg)


def test_decode_steps_match_jax():
    """Ten one-token steps from a zero cache: each output and the carried
    state and conv window against the reference's; the cache passed in is
    not written."""
    cfg, jp, pcfg, pp = _block(seed=7)
    x = _x(cfg, 2, 10, seed=8)
    jc = jm.init_mamba_cache(cfg, 2)
    pc = pm.init_mamba_cache(pcfg, 2)
    for t in range(10):
        jy, jc = jm.mamba_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jc, cfg)
        before = pc
        py, pc = pm.mamba_decode_step(pp, torch.from_numpy(x[:, t:t + 1]), pc, pcfg)
        assert pc.h is not before.h and pc.conv.data_ptr() != before.conv.data_ptr()
        _close(py, jy)
        _close(pc.h, jc.h)
        _close(pc.conv, jc.conv)


def test_prefill_state_then_decode_continues_the_forward():
    """The state a 64-token prefill returns, fed to the decode recurrence for
    32 more tokens, gives the outputs of the full 96-token block."""
    cfg, jp, pcfg, pp = _block(seed=9)
    x = torch.from_numpy(_x(cfg, 2, 96, seed=10))
    full = pm.mamba_block(pp, x, pcfg)
    out, cache = pm.mamba_block(pp, x[:, :64], pcfg, return_state=True)
    _close(out, full[:, :64], atol_rel=1e-4)
    for t in range(64, 96):
        y, cache = pm.mamba_decode_step(pp, x[:, t:t + 1], cache, pcfg)
        _close(y, full[:, t:t + 1], atol_rel=1e-4)
