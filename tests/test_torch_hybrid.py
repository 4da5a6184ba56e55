"""The port's hybrid optimizer (AdamW on the backbone, DFW-Trace on the
untied head) against the JAX package's ``optim.hybrid``, on the CPU.

codeqwen1.5-7b's smoke config (f32, untied head) from the JAX package's
weights through ``convert.lm_params``; the batches from the port's stream
(the reference's bits); the power method's start vectors injected: the
reference draws ``sphere_vector(fold_in(key, fw_step), V)``, and the port
takes those vectors through a ``V0Stream.from_table``.

Tolerances over 8 steps (f32 sums in other orders; the jitted reference
contracts multiply-adds; two power iterations leave the top direction
unsettled, so each step's u v^T carries the gradient's rounding):
- loss rtol 1e-5 at step 1, 1e-4 over the run; fw_gamma exactly (both
  2 / (t + 2) in f32); fw_sigma rtol 1e-4;
- parameters 1e-3 of each leaf's max plus 1% of the learning rates summed
  (AdamW's normalized step moves a parameter whose gradient sits at the
  rounding noise by up to lr); the head 1e-3 of its max;
- the head's trace norm <= mu (1 + 1e-3) after the first step (gamma = 1),
  the reference's own test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.power_method import sphere_vector
from repro.models import lm as jlm
from repro.optim import hybrid as jhybrid
from repro_torch import V0Stream, configs, convert
from repro_torch.data import SyntheticLMStream, device_put_batch
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import hybrid
from repro_torch.optim.compression import tree_leaves

torch.set_num_threads(2)

ARCH = "codeqwen1_5_7b"
STEPS = 8


def _start(seed=0):
    cfg = jax_get_config(ARCH, smoke=True)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(seed))
    pcfg = configs.get_config(ARCH, smoke=True)
    return cfg, jp, pcfg, convert.lm_params(jax.device_get(jp), pcfg, device="cpu")


def _v0_table(key, steps, v):
    return np.stack([np.asarray(sphere_vector(jax.random.fold_in(key, t), v))
                     for t in range(steps)])


def _lr_sum(peak, warmup, steps):
    return peak * sum(range(steps)) / warmup


@pytest.mark.parametrize("mu,peak_lr", [(5.0, 1e-3), (100.0, 3e-4)])
def test_hybrid_step_matches_reference_over_eight_steps(mu, peak_lr):
    cfg, jp, pcfg, pp = _start()
    key = jax.random.PRNGKey(5)
    jstep = jax.jit(jhybrid.make_hybrid_train_step(cfg, mu=mu, peak_lr=peak_lr))
    pstep = hybrid.make_hybrid_train_step(pcfg, mu=mu, peak_lr=peak_lr)
    jst, pst = jhybrid.init(jp), hybrid.init(pp)
    v0 = V0Stream.from_table(_v0_table(key, STEPS, cfg.vocab_size))
    stream = SyntheticLMStream(pcfg, ShapeSpec("t", "train", 64, 4))
    for t in range(STEPS):
        b = stream.batch_for_step(t)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()}, key)
        pp, pst, pm = pstep(pp, pst, device_put_batch(b, "cpu"), v0)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if t == 0 else 1e-4)
        np.testing.assert_allclose(float(pm["ce"]), float(jm["ce"]), rtol=1e-4)
        assert float(pm["fw_gamma"]) == float(jm["fw_gamma"]) == np.float32(2) / np.float32(t + 2)
        np.testing.assert_allclose(float(pm["fw_sigma"]), float(jm["fw_sigma"]), rtol=1e-4)
        assert torch.isfinite(pm["loss"])
        if t == 0:  # after the first FW step (gamma = 1) the head is feasible
            tn = float(torch.linalg.svdvals(pp["unembed"]).sum())
            assert tn <= mu * (1 + 1e-3), tn
    assert pst.fw_step == STEPS == int(jst.fw_step) and int(pst.adam.step) == STEPS
    want = convert.lm_params(jax.device_get(jp), pcfg, device="cpu")
    lr_sum = _lr_sum(peak_lr, 100, STEPS)
    for g, w in zip(tree_leaves(pp), tree_leaves(want), strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()) + 1e-2 * lr_sum)
    tn = float(torch.linalg.svdvals(pp["unembed"]).sum())
    assert tn <= mu * (1 + 1e-3), tn
    # the head's moments stay zero, as the reference's zeroed gradient keeps them
    assert not pst.adam.m["unembed"].any() and not pst.adam.v["unembed"].any()
    assert not np.asarray(jst.adam.m["unembed"]).any()


def test_hybrid_state_carries_across_from_the_reference():
    """Three JAX steps, then the port from the JAX state (``convert``) for
    three more, against six JAX steps."""
    cfg, jp, pcfg, _ = _start(seed=2)
    key = jax.random.PRNGKey(9)
    jstep = jax.jit(jhybrid.make_hybrid_train_step(cfg, mu=10.0, peak_lr=1e-3))
    pstep = hybrid.make_hybrid_train_step(pcfg, mu=10.0, peak_lr=1e-3)
    stream = SyntheticLMStream(pcfg, ShapeSpec("t", "train", 32, 2))
    v0 = V0Stream.from_table(_v0_table(key, 6, cfg.vocab_size))
    jst = jhybrid.init(jp)
    for t in range(6):
        b = {k: jnp.asarray(v) for k, v in stream.batch_for_step(t).items()}
        jp, jst, jm = jstep(jp, jst, b, key)
        if t == 2:
            pp = convert.lm_params(jax.device_get(jp), pcfg, device="cpu")
            pst = convert.hybrid_state(jax.device_get(jst), pcfg, device="cpu")
            assert pst.fw_step == 3 and int(pst.adam.step) == 3
        elif t > 2:
            pp, pst, pm = pstep(pp, pst, device_put_batch(stream.batch_for_step(t), "cpu"), v0)
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-4)
    want = convert.lm_params(jax.device_get(jp), pcfg, device="cpu")
    for g, w in zip(tree_leaves(pp), tree_leaves(want), strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * float(w.abs().max()) + 1e-2 * 1e-3 * 6)


def test_free_run_draws_from_a_seed_and_repeats():
    """An int key draws v0 from a torch.Generator by (seed, t): two runs
    from the same weights give the same bits."""
    _, _, pcfg, p0 = _start()
    stream = SyntheticLMStream(pcfg, ShapeSpec("t", "train", 32, 2))
    outs = []
    for _ in range(2):
        pp = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  [{n: {a: t.clone() for a, t in x.items()} if isinstance(x, dict) else x.clone()
                    for n, x in lp.items()} for lp in v]) for k, v in p0.items()}
        step = hybrid.make_hybrid_train_step(pcfg, mu=5.0)
        st = hybrid.init(pp)
        for t in range(3):
            pp, st, _ = step(pp, st, device_put_batch(stream.batch_for_step(t), "cpu"), 7)
        outs.append(pp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])))


def test_hybrid_refuses_a_tied_head():
    with pytest.raises(ValueError, match="untied"):
        hybrid.make_hybrid_train_step(configs.get_config("qwen2_1_5b", smoke=True))
