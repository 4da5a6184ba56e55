"""The port's bf16 LM paths against the JAX package's, on the CPU.

The dense family (qwen2-1.5b's smoke config) and the ssm family (rwkv6-7b's,
with ``u_bonus`` redrawn nonzero as in tests/test_torch_rwkv6.py) run in
bf16: the JAX package's ``init_params`` draws the bf16 weights, the port gets
them bit for bit through ``convert.lm_params``, and the same weights upcast
to f32 give the f32 computation. Both packages round to bf16 at their own
places, so the port is not held to the JAX package's bf16 bits.

Tolerances, on train-mode logits of 2 x 64 tokens, from the JAX package's
own distance d between its bf16 and f32 logits on the same weights (the
rule chip_smoke.py holds the card's bf16 paths to): the port's bf16 logits
within 1.25 d of the f32 ones, and within sqrt(1 + 1.25^2) d of the JAX
package's bf16 ones (two roundings of that size taken independently). The
distances are root-mean-square over the logits, relative to the RMS of the
reference: the largest single difference swings by a factor of three from
one seed to the next, the RMS by under 10%. The port's f32 logits on the
upcast weights match the JAX package's to 1e-4 of max|logits|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch import configs, convert
from repro_torch.models import lm as plm

torch.set_num_threads(2)


def _nonzero_u(jp, seed=9):
    """rwkv6: u_bonus (L, H, 64) redrawn N(0, 0.5^2), f32 as initialised."""
    tm = jp["layers"]["tm_cm"]
    u = jax.random.normal(jax.random.PRNGKey(seed), tm["u_bonus"].shape, tm["u_bonus"].dtype)
    return dict(jp, layers=dict(jp["layers"], tm_cm=dict(tm, u_bonus=u * 0.5)))


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rms_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "rwkv6_7b"])
def test_bf16_forward_is_as_close_to_jax_as_jax_bf16_is_to_f32(arch):
    cfg16 = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    pcfg16 = dataclasses.replace(configs.get_config(arch, smoke=True), dtype="bfloat16")
    pcfg32 = dataclasses.replace(pcfg16, dtype="float32")
    jp16 = jlm.init_params(cfg16, jax.random.PRNGKey(3))
    if arch == "rwkv6_7b":
        jp16 = _nonzero_u(jp16)
    assert jp16["embed"].dtype == jnp.bfloat16
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    toks = np.random.default_rng(4).integers(0, cfg16.vocab_size, (2, 64)).astype(np.int32)

    j16 = np.asarray(jlm.forward(jp16, {"tokens": jnp.asarray(toks)}, cfg16,
                                 mode="train")["logits"].astype(jnp.float32))
    j32 = np.asarray(jlm.forward(jp32, {"tokens": jnp.asarray(toks)}, cfg32,
                                 mode="train")["logits"])
    pp16 = convert.lm_params(jax.device_get(jp16), pcfg16, device="cpu")
    pp32 = convert.lm_params(jax.device_get(jp32), pcfg32, device="cpu")
    assert pp16["embed"].dtype == torch.bfloat16
    t = torch.from_numpy(toks)
    p16 = plm.forward(pp16, {"tokens": t}, pcfg16, mode="train")["logits"].float().numpy()
    p32 = plm.forward(pp32, {"tokens": t}, pcfg32, mode="train")["logits"].numpy()

    assert _max_rel(p32, j32) <= 1e-4
    d = _rms_rel(j16, j32)  # the reference's own bf16 rounding on these weights
    assert 0 < d < 0.5
    assert _rms_rel(p16, j32) <= 1.25 * d, (_rms_rel(p16, j32), d)
    assert _rms_rel(p16, j16) <= np.hypot(1.0, 1.25) * d, (_rms_rel(p16, j16), d)
