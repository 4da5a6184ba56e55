"""The paper's ImageNet head in the port (``repro_torch.core.dfw_head``)
against the JAX package's ``repro.core.dfw_head``, on the CPU.

- **Features.** ``extract_features`` on the smoke qwen2-1.5b, rwkv6-7b and
  arctic-480b configs, weights carried across by ``convert.lm_params``: X within the
  whole-forward tolerance of tests/test_torch_lm.py (rtol 1e-5, atol 1e-4
  of max|reference|), y equal, ``max_tokens`` honoured.
- **The head on backbone features** (tests/test_system.py's pipeline):
  smoke qwen2 features, 32 planted classes, mu 10, 30 epochs, both
  packages on the same features with the JAX run's start vectors injected
  (``V0Stream.from_table``). This trajectory is ill-conditioned past epoch
  13: the reference run on X moved by 1e-7 relative departs from itself by
  up to ~3e-3 in loss and ~1e-2 in gap and sigma. So the history is held
  within rtol 1e-4 for its first 13 epochs and after them to three times
  the reference's own spread (its largest over the run, at least 1e-4), W
  to 1e-5 of max|W| or three times the spread's; the top-5 error is the
  reference's, where a row's hit may differ only if its k-th and (k+1)-th
  logits tie within 1e-6 of the row's largest |logit| (the test counts
  such rows).
- **The sharded fit** (the head half of
  tests/test_distributed.py::test_sharded_head_training_and_powersgd):
  n 2048, d 32, m 16, mu 8, 25 epochs, on one process and on gloo groups of
  2 and 4 (``run_workers``), against the JAX ``sharded_fit`` on a one-device
  mesh with its draws injected, within tests/test_torch_dfw_multi.py's
  multi-worker tolerances (loss rtol 1e-5; gap rtol 1e-4 with atol 1e-4,
  the logistic case's; sigma rtol 1e-4; W to 1e-6 of max|W|), plus the
  reference test's own asserts.
- **Checkpoint and resume** (tests/test_checkpoint_resume.py's head test):
  steps [4, 8, 12]; a resume from 8 gives the full run's history, final
  loss and iterate exactly; the finished run and a budget of 8 return the
  checkpoint; written on 2 gloo workers and resumed on 1 and on 4, within
  the sharded tolerances above (W to 1e-5 of max, tests/test_torch_resume.py's
  elastic tolerance); a checkpoint the JAX package's ``sharded_fit`` wrote,
  resumed in the port, gives the JAX run's remaining history within
  tests/test_torch_fit.py's rtol 1e-4 (W 1e-4 of max).
- ``gap_tol`` stops at the JAX run's epoch; ``right_multiply`` and
  ``trace_norm_upper_bound`` match the reference's (rtol 1e-5, atol 1e-5 of
  max).

The JAX package is imported in fixtures, not at module level: the worker
processes import this module and need none of it.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import V0Stream, checkpoint, configs, convert
from repro_torch.core import dfw_head, low_rank, tasks
from repro_torch.launch import dfw
from repro_torch.specs import NotYetPorted

torch.set_num_threads(2)

N, D, M = 2048, 32, 16  # the sharded head fit
MU, EPOCHS = 8.0, 25
CN, CD, CM = 96, 16, 8  # the checkpointed head fit
CKW = dict(mu=5.0, num_epochs=12, block_epochs=4)
STABLE = 13  # epochs of the backbone-feature head fit before its trajectory turns sensitive


def _head_data():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((D, M))
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _ckpt_data():
    rng = np.random.default_rng(12)
    return (rng.standard_normal((CN, CD)).astype(np.float32),
            rng.integers(0, CM, CN).astype(np.int32))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import checkpoint as jckpt
    from repro.configs import get_config
    from repro.core import dfw_head as jhead
    from repro.core import low_rank as jlr
    from repro.core import tasks as jtasks
    from repro.core.power_method import sphere_vector
    from repro.models import lm as jlm

    def table(m, epochs, seed=0):
        """The JAX run's start vectors: sphere_vector(fold_in(key, t), m)."""
        key = jax.random.PRNGKey(seed)
        return np.stack([np.asarray(sphere_vector(jax.random.fold_in(key, t), m))
                         for t in range(epochs)])

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jckpt=jckpt, get_config=get_config, jhead=jhead, jlr=jlr,
        jtasks=jtasks, jlm=jlm, table=table,
        mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))


def _close(got, want, rtol=1e-4, atol_rel=0.0, atol=0.0, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(atol, atol_rel * float(np.abs(want).max())),
                               err_msg=err_msg)


def _w(it):
    return low_rank.materialize(low_rank.FactoredIterate(*it)).numpy()


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


def _lm(jx, arch, seed=0):
    cfg = jx.get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    jp = jx.jlm.init_params(cfg, jx.jax.random.PRNGKey(seed))
    if cfg.family == "ssm":  # u_bonus redrawn nonzero (the reference inits zeros)
        u = jp["layers"]["tm_cm"]["u_bonus"]
        jp = dict(jp, layers=dict(jp["layers"], tm_cm=dict(
            jp["layers"]["tm_cm"],
            u_bonus=jx.jax.random.normal(jx.jax.random.PRNGKey(9), u.shape) * 0.5)))
    return cfg, jp, pcfg, convert.lm_params(jx.jax.device_get(jp), pcfg, device="cpu")


def _batches(vocab, seed, count=2, b=2, s=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "rwkv6_7b"])
def test_extract_features_matches_jax(arch, jx):
    cfg, jp, pcfg, pp = _lm(jx, arch)
    batches = _batches(cfg.vocab_size, 3)
    jxf, jyf = jx.jhead.extract_features(
        jp, [{"tokens": jx.jnp.asarray(t), "labels": jx.jnp.asarray(y)} for t, y in batches], cfg)
    tb = [{"tokens": torch.from_numpy(t), "labels": torch.from_numpy(y)} for t, y in batches]
    x, y = dfw_head.extract_features(pp, tb, pcfg)
    assert x.dtype == torch.float32 and tuple(x.shape) == (2 * 2 * 64, cfg.d_model)
    _close(x, jxf, rtol=1e-5, atol_rel=1e-4)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jyf))
    xc, yc = dfw_head.extract_features(pp, tb, pcfg, max_tokens=100)
    assert tuple(xc.shape) == (100, cfg.d_model)
    assert torch.equal(xc, x[:100]) and torch.equal(yc, y[:100])


def test_extract_features_refuses_an_unported_family(jx):
    """Every family of the zoo runs since the moe family was ported: arctic's
    features (8 experts, top-2, a dense residual) match the JAX package's
    within the whole-forward tolerance; a family outside
    ``lm.PORTED_FAMILIES`` is still refused before any device work."""
    cfg, jp, pcfg, pp = _lm(jx, "arctic_480b")
    batches = _batches(cfg.vocab_size, 4)
    jxf, jyf = jx.jhead.extract_features(
        jp, [{"tokens": jx.jnp.asarray(t), "labels": jx.jnp.asarray(y)} for t, y in batches], cfg)
    tb = [{"tokens": torch.from_numpy(t), "labels": torch.from_numpy(y)} for t, y in batches]
    x, y = dfw_head.extract_features(pp, tb, pcfg)
    assert x.dtype == torch.float32 and tuple(x.shape) == (2 * 2 * 64, cfg.d_model)
    _close(x, jxf, rtol=1e-5, atol_rel=1e-4)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jyf))
    with pytest.raises(NotYetPorted, match="not yet ported"):
        dfw_head.extract_features(pp, tb, dataclasses.replace(pcfg, family="retnet"))


def _hits(logits, y, k):
    idx = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    return np.any(idx == y[:, None], axis=1)


def test_head_on_backbone_features_matches_jax(jx):
    """tests/test_system.py's pipeline, both packages on the JAX features."""
    jax, jnp = jx.jax, jx.jnp
    cfg, jp, pcfg, pp = _lm(jx, "qwen2_1_5b")
    batches = []
    for i in range(2):
        toks = jax.random.randint(jax.random.PRNGKey(10 + i), (2, 64), 0, cfg.vocab_size)
        batches.append({"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)})
    jfeat, _ = jx.jhead.extract_features(jp, batches, cfg)
    w_plant = jax.random.normal(jax.random.PRNGKey(3), (cfg.d_model, 32))
    y_plant = jnp.argmax(jfeat @ w_plant, axis=1)
    jres = jx.jhead.train_head(jfeat, y_plant, 32, mu=10.0, num_epochs=30)
    x, y = np.array(jfeat), np.asarray(y_plant).astype(np.int32)
    res = dfw_head.train_head(x, y, 32, mu=10.0, num_epochs=30,
                              key=V0Stream.from_table(jx.table(32, 30)), device="cpu")
    # The reference's own spread: its run on X moved by a 1e-7 relative
    # perturbation (about an ulp) departs from itself by up to ~3e-3 in loss
    # and ~1e-2 in sigma after epoch 14, where K = 2 iterations leave the
    # top direction unsettled.
    rng = np.random.default_rng(1)
    xp = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(np.float32)
    jalt = jx.jhead.train_head(jnp.asarray(xp), y_plant, 32, mu=10.0, num_epochs=30)
    for name in ("loss", "gap", "sigma", "gamma"):
        got, want, alt = (np.asarray(r.history[name], np.float64) for r in (res, jres, jalt))
        dev = np.abs(got - want) / np.abs(want)
        spread = np.abs(alt - want) / np.abs(want)
        assert np.all(dev[:STABLE] <= 1e-4), (name, dev[:STABLE])
        assert dev.max() <= max(1e-4, 3 * spread.max()), (name, dev.max(), spread.max())
    assert res.history["k"] == jres.history["k"]
    w_want = np.asarray(jres.head_matrix())
    w_spread = np.abs(np.asarray(jalt.head_matrix()) - w_want).max() / np.abs(w_want).max()
    assert tuple(res.head_matrix().shape) == (cfg.d_model, 32)
    _close(res.head_matrix(), w_want, rtol=0, atol_rel=max(1e-5, 3 * w_spread))
    # the reference test's own asserts
    assert res.history["loss"][-1] < res.history["loss"][0]
    err = dfw_head.top_k_error(res.iterate, torch.tensor(x), torch.tensor(y), k=5)
    jerr = jx.jhead.top_k_error(jres.iterate, jfeat, y_plant, k=5)
    assert err < 0.6, err
    # The same head in both packages (the JAX one carried across): the
    # reference's error, a row's hit differing only at a tie within 1e-6 of
    # its scale. The port's own head: a row's hit differs only where the
    # two heads' logits part by more than the gap at its k-th logit.
    xt, yt = torch.tensor(x), torch.tensor(y)
    jlog = np.asarray(jx.jlr.right_multiply(jres.iterate, jfeat))
    jhit = np.asarray(jax.lax.top_k(jlog, 5)[1] == y[:, None]).any(axis=1)
    srt = -np.sort(-jlog, axis=1)
    kgap = np.abs(srt[:, 4] - srt[:, 5])
    scale = np.abs(jlog).max(axis=1)
    same = convert.iterate(jax.device_get(jres.iterate), 30, device="cpu")
    for it, slack in ((same, 0.0), (res.iterate, None)):
        plog = low_rank.right_multiply(it, xt).numpy()
        phit = _hits(plog, y, 5)
        part = np.abs(plog - jlog).max(axis=1)
        tied = kgap <= (1e-6 * scale if slack is not None else 2 * part + 1e-6 * scale)
        assert not np.any((jhit != phit) & ~tied), np.flatnonzero((jhit != phit) & ~tied)
        got = dfw_head.top_k_error(it, xt, yt, k=5)
        assert got == float(np.float32(1.0) - np.float32(phit.sum()) / np.float32(len(y)))
        if slack is not None:  # the same head: the same hits here
            assert np.all(jhit == phit) and got == jerr
    assert err == dfw_head.top_k_error(res.iterate, xt, yt, k=5)


def test_top_k_error_chunks_give_one_call_s_answer(monkeypatch):
    x, y = _head_data()
    res = dfw_head.train_head(x, y, M, mu=MU, num_epochs=6, device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    one = dfw_head.top_k_error(res.iterate, xt, yt, k=5)
    whole = low_rank.right_multiply(res.iterate, xt)
    monkeypatch.setattr(low_rank, "RIGHT_MULTIPLY_ROWS", 300)
    assert dfw_head.top_k_error(res.iterate, xt, yt, k=5) == one
    # the CPU's products take another order by row count (on the card the
    # kernel's batch tiling moves no bit: the gpu tests hold that)
    _close(low_rank.right_multiply(res.iterate, xt), whole, rtol=1e-6, atol_rel=1e-6)


# ---------------------------------------------------------------------------
# The sharded fit, on 1, 2 and 4 workers
# ---------------------------------------------------------------------------


def _summary(res):
    return dict(history=res.history, final_loss=res.final_loss,
                iterate=[t.clone() for t in res.iterate])


def _ranks(group, device, head, ckpt, table, ckdir):
    """One worker (module level: run_workers starts it by name): the head fit
    on four workers and (workers 0, 1) on two; workers 0, 1 then write the
    checkpointed fit, which all four resume from step 8."""
    torch.set_num_threads(1)
    two = group.split([[0, 1], [2, 3]])
    (x, y), (cx, cy) = head, ckpt
    kw = dict(mu=MU, num_epochs=EPOCHS, device=device)
    out = {"four": _summary(dfw_head.sharded_fit(group, x, y, M, key=V0Stream.from_table(table),
                                                 **kw))}
    task = tasks.MultinomialLogistic(CD, CM)
    if group.rank < 2:
        out["two"] = _summary(dfw_head.sharded_fit(two, x, y, M, key=V0Stream.from_table(table),
                                                   **kw))
        ck = checkpoint.RunCheckpointer(ckdir, keep_last=None, extra=checkpoint.run_extra(
            task, num_workers=2, comm="dense", num_epochs=12, schedule="const:2", mu=5.0,
            step_size="default"))
        out["ckpt-two"] = _summary(dfw_head.sharded_fit(two, cx, cy, CM, key=2, checkpointer=ck,
                                                        device=device, **CKW))
    group.all_reduce(torch.zeros(1))  # the two-worker checkpoint has landed
    snap = checkpoint.restore_run(ckdir, task=task, step=8)
    out["elastic-four"] = _summary(dfw_head.sharded_fit(group, cx, cy, CM, key=2, resume=snap,
                                                        device=device, **CKW))
    return out


@pytest.fixture(scope="module")
def jax_head(jx):
    x, y = _head_data()
    res = jx.jhead.sharded_fit(jx.mesh, x, y, M, mu=MU, num_epochs=EPOCHS)
    return dict(history=res.history, final_loss=res.final_loss,
                w=np.asarray(res.head_matrix()),
                err=jx.jhead.top_k_error(res.iterate, x, y, k=5))


@pytest.fixture(scope="module")
def multi(jx, tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("head_multi") / "ck"
    out = dfw.run_workers(4, _ranks, _head_data(), _ckpt_data(), jx.table(M, EPOCHS),
                          str(ckdir), device="cpu")
    return dict(workers=out, ckdir=ckdir)


def _within_sharded(got, want, w_atol_rel=1e-6):
    for key, rtol, atol in (("loss", 1e-5, 0.0), ("gap", 1e-4, 1e-4), ("sigma", 1e-4, 0.0)):
        _close(got["history"][key], want["history"][key], rtol=rtol, atol=atol, err_msg=key)
    _close(got["final_loss"], want["final_loss"], rtol=1e-5)
    _close(_w(got["iterate"]), want["w"] if "w" in want else _w(want["iterate"]), rtol=0,
           atol_rel=w_atol_rel)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_sharded_fit_matches_jax(workers, jx, jax_head, multi):
    """The head half of tests/test_distributed.py's test on 1, 2 and 4
    workers, against the JAX sharded_fit with the same draws."""
    x, y = _head_data()
    if workers == 1:
        got = _summary(dfw_head.sharded_fit(None, x, y, M, mu=MU, num_epochs=EPOCHS,
                                            key=V0Stream.from_table(jx.table(M, EPOCHS)),
                                            device="cpu"))
    else:
        name = {2: "two", 4: "four"}[workers]
        got = multi["workers"][0][name]
        for j in range(1, workers):
            assert multi["workers"][j][name]["history"] == got["history"]
    _within_sharded(got, jax_head)
    loss = got["history"]["loss"]
    assert loss[-1] < 0.7 * loss[0]
    err = dfw_head.top_k_error(low_rank.FactoredIterate(*got["iterate"]), torch.from_numpy(x),
                               torch.from_numpy(y), k=5)
    assert err < 0.5, err
    assert abs(err - jax_head["err"]) <= 2 / N


def test_one_worker_sharded_fit_is_train_head_bit_for_bit():
    x, y = _head_data()
    a = dfw_head.sharded_fit(None, x, y, M, mu=MU, num_epochs=10, key=3, device="cpu")
    b = dfw_head.train_head(x, y, M, mu=MU, num_epochs=10, key=3, device="cpu")
    c = dfw.fit_serial(tasks.MultinomialLogistic(D, M), x, y, key=3, device="cpu",
                       cfg=dfw.DFWConfig(mu=MU, num_epochs=10))
    for r in (b, c):
        assert a.history == r.history and a.final_loss == r.final_loss
        assert all(torch.equal(p, q) for p, q in zip(a.iterate, r.iterate))


def test_sharded_fit_refuses_a_ragged_split():
    class Two:
        size, rank = 3, 0

    x, y = _head_data()
    with pytest.raises(ValueError, match="divisible"):
        dfw_head.sharded_fit(Two(), x[:100], y[:100], M, device="cpu")


# ---------------------------------------------------------------------------
# Checkpoint and resume
# ---------------------------------------------------------------------------


def _checkpointer(path, workers=1):
    return checkpoint.RunCheckpointer(path, keep_last=None, extra=checkpoint.run_extra(
        tasks.MultinomialLogistic(CD, CM), num_workers=workers, comm="dense", num_epochs=12,
        schedule="const:2", mu=5.0, step_size="default"))


def test_head_checkpoint_resume(tmp_path):
    """tests/test_checkpoint_resume.py's head test on the port."""
    cx, cy = _ckpt_data()
    task = tasks.MultinomialLogistic(CD, CM)
    ck = _checkpointer(tmp_path / "ck")
    full = dfw_head.sharded_fit(None, cx, cy, CM, key=2, checkpointer=ck, device="cpu", **CKW)
    assert ck.store.steps() == [4, 8, 12]
    snap = checkpoint.restore_run(tmp_path / "ck", task=task, step=8)
    res = dfw_head.sharded_fit(None, cx, cy, CM, key=2, resume=snap, device="cpu", **CKW)
    assert res.history == full.history and res.final_loss == full.final_loss
    assert all(torch.equal(a, b) for a, b in zip(res.iterate, full.iterate))
    fin = checkpoint.restore_run(tmp_path / "ck", task=task)
    assert fin.t == 12
    done = dfw_head.sharded_fit(None, cx, cy, CM, mu=5.0, num_epochs=12, key=2, resume=fin,
                                device="cpu")
    assert done.history == full.history and done.final_loss == full.final_loss
    shrunk = dfw_head.sharded_fit(None, cx, cy, CM, mu=5.0, num_epochs=8, key=2, resume=fin,
                                  device="cpu")
    assert shrunk.history == full.history and int(shrunk.iterate.count) == 12
    # a fresh run into the directory owns it: the old run's later steps go
    dfw_head.sharded_fit(None, cx, cy, CM, mu=5.0, num_epochs=8, block_epochs=4, key=2,
                         checkpointer=_checkpointer(tmp_path / "ck"), device="cpu")
    assert _checkpointer(tmp_path / "ck").store.steps() == [4, 8]


def test_head_resume_refuses_another_problem(tmp_path):
    cx, cy = _ckpt_data()
    dfw_head.sharded_fit(None, cx, cy, CM, key=2, checkpointer=_checkpointer(tmp_path / "ck"),
                         device="cpu", **CKW)
    snap = checkpoint.restore_run(tmp_path / "ck", task=tasks.MultinomialLogistic(CD, CM))
    with pytest.raises(ValueError, match="same problem"):
        dfw_head.sharded_fit(None, cx, cy, CM + 1, key=2, resume=snap, device="cpu", **CKW)


def test_elastic_head_resume(multi):
    """Written on two gloo workers; resumed from step 8 on four (in the
    spawn) and on one (here): within the sharded tolerances of the
    uninterrupted two-worker run, the first eight epochs restored as saved."""
    full = multi["workers"][0]["ckpt-two"]
    assert multi["workers"][1]["ckpt-two"]["history"] == full["history"]
    snap = checkpoint.restore_run(multi["ckdir"], task=tasks.MultinomialLogistic(CD, CM), step=8)
    cx, cy = _ckpt_data()
    one = _summary(dfw_head.sharded_fit(None, cx, cy, CM, key=2, resume=snap, device="cpu",
                                        **CKW))
    for got in (one, *(w["elastic-four"] for w in multi["workers"])):
        assert got["history"]["loss"][:8] == full["history"]["loss"][:8]
        assert len(got["history"]["loss"]) == 12
        _within_sharded(got, full, w_atol_rel=1e-5)


def test_port_resumes_a_jax_head_checkpoint(jx, tmp_path):
    """The JAX package's sharded_fit writes steps 4, 8, 12; the port resumes
    from 8 with the JAX run's draws and gives its remaining history."""
    cx, cy = _ckpt_data()
    jtask = jx.jtasks.MultinomialLogistic(d=CD, m=CM)
    jck = jx.jckpt.RunCheckpointer(tmp_path / "ck", keep_last=None, extra=jx.jckpt.run_extra(
        jtask, num_workers=1, comm="dense", num_epochs=12, schedule="const:2", mu=5.0,
        step_size="default"))
    jres = jx.jhead.sharded_fit(jx.mesh, cx, cy, CM, key=jx.jax.random.PRNGKey(2),
                                checkpointer=jck, **CKW)
    jck.wait()
    snap = checkpoint.restore_run(tmp_path / "ck", task=tasks.MultinomialLogistic(CD, CM),
                                  step=8)
    assert snap.t == 8 and snap.seed == 2
    res = dfw_head.sharded_fit(None, cx, cy, CM, key=V0Stream.from_table(jx.table(CM, 12, 2)),
                               resume=snap, device="cpu", **CKW)
    assert res.history["loss"][:8] == jres.history["loss"][:8]
    for name in ("loss", "gap", "sigma", "gamma"):
        _close(res.history[name], jres.history[name], err_msg=name)
    _close(res.final_loss, jres.final_loss)
    _close(res.head_matrix(), np.asarray(jres.head_matrix()), rtol=0, atol_rel=1e-4)


def test_gap_tol_stops_at_the_jax_epoch(jx):
    x, y = _head_data()
    free = jx.jhead.sharded_fit(jx.mesh, x, y, M, mu=MU, num_epochs=EPOCHS)
    gaps = free.history["gap"]
    # a tolerance well between the first gap that sets a new low and the low before it
    e = next(e for e in range(5, EPOCHS) if gaps[e] < 0.98 * min(gaps[:e]))
    tol = float(np.sqrt(gaps[e] * min(gaps[:e])))
    jres = jx.jhead.sharded_fit(jx.mesh, x, y, M, mu=MU, num_epochs=EPOCHS, gap_tol=tol)
    res = dfw_head.sharded_fit(None, x, y, M, mu=MU, num_epochs=EPOCHS, gap_tol=tol,
                               key=V0Stream.from_table(jx.table(M, EPOCHS)), device="cpu")
    assert len(jres.history["loss"]) < EPOCHS
    assert len(res.history["loss"]) == len(jres.history["loss"])
    _close(res.history["gap"], jres.history["gap"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The factored iterate's helpers
# ---------------------------------------------------------------------------


def test_right_multiply_and_trace_bound_match_jax(jx):
    rng = np.random.default_rng(7)
    r, count = 9, 6
    u = np.zeros((r, D), np.float32)
    v = np.zeros((r, M), np.float32)
    s = np.zeros(r, np.float32)
    u[:count] = rng.standard_normal((count, D))
    v[:count] = rng.standard_normal((count, M))
    s[:count] = rng.standard_normal(count)
    jit = jx.jlr.FactoredIterate(u=jx.jnp.asarray(u), s=jx.jnp.asarray(s), v=jx.jnp.asarray(v),
                                 alpha=jx.jnp.float32(-0.7), count=jx.jnp.int32(count))
    it = convert.iterate(jx.jax.device_get(jit), r, device="cpu")
    x = rng.standard_normal((50, D)).astype(np.float32)
    _close(low_rank.right_multiply(it, torch.from_numpy(x)), jx.jlr.right_multiply(jit, x),
           rtol=1e-5, atol_rel=1e-5)
    _close(low_rank.trace_norm_upper_bound(it), jx.jlr.trace_norm_upper_bound(jit), rtol=1e-6)
    empty = low_rank.init(4, D, M, device="cpu")
    assert torch.equal(low_rank.right_multiply(empty, torch.from_numpy(x)), torch.zeros(50, M))
