"""The port's factor_matvec kernel module against the JAX package's Pallas
kernel and plain versions.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX kernel
runs in interpret mode at block_b=32, block_o=64, as tests/test_kernels.py
runs it, at that file's four shapes (f32). The same numpy inputs go to both.
Tolerance: rtol 1e-5 with an atol of 1e-6 times max|reference| (f32 sums in
another order). Bucket padding with s = 0 rows must give the same bits.

bf16 operands (X, A, B each bf16 or f32; s f32): the same four shapes with
all three in bf16, as tests/test_kernels.py runs the JAX kernel, and the
mixed cases. Both packages take every product and sum in f32 on exact bf16
values, so the reference's bf16 tolerance (rtol = atol = 3e-2) is far wider
than what is measured; the port is held at the f32 tolerance above, and to
its own f32 route on the widened operands bit for bit.

The CUDA kernel itself is tested on the card by
``tests/test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import factor_matvec as jfm
from repro_torch import kernels
from repro_torch.kernels import factor_matvec as fm

torch.set_num_threads(2)

SHAPES = [(128, 256, 8, 256), (130, 300, 7, 65), (1, 7, 1, 3), (33, 129, 12, 257)]


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


def _inputs(bt, n_in, r, n_out, seed=0):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((bt, n_in)) / np.sqrt(n_in)).astype(np.float32),
        rng.standard_normal((r, n_in)).astype(np.float32),
        rng.standard_normal(r).astype(np.float32),
        rng.standard_normal((r, n_out)).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bt,n_in,r,n_out", SHAPES)
def test_factor_matvec_matches_jax(bt, n_in, r, n_out):
    x, a, s, b = _inputs(bt, n_in, r, n_out)
    got = fm.factor_matvec(*_t(x, a, s, b), alpha=0.7)
    assert got.shape == (bt, n_out) and got.dtype == torch.float32
    jx, ja, js, jb = map(jnp.asarray, (x, a, s, b))
    _close(got, jfm.factor_matvec(jx, ja, js, jb, alpha=0.7, block_b=32, block_o=64,
                                  interpret=True))
    _close(got, jfm.ref.factor_matvec(jx, ja, 0.7 * js, jb))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and back to f32 (round to nearest even, as
    both packages round)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("which", ["xab", "x", "ab", "b"])
@pytest.mark.parametrize("bt,n_in,r,n_out", SHAPES)
def test_factor_matvec_bf16_operands_match_jax(bt, n_in, r, n_out, which):
    """X, A, B in bf16 where named in ``which`` (f32 otherwise) against the
    JAX kernel in interpret mode given the same bf16 operands and its plain
    version; the f32 route on the widened operands gives the same bits."""
    x, a, s, b = _inputs(bt, n_in, r, n_out, seed=6)
    ops = {"x": x, "a": a, "b": b}
    for k in which:
        ops[k] = _bf16(ops[k])
    tx, ta, ts, tb = _t(ops["x"], ops["a"], s, ops["b"])
    args = {"x": tx, "a": ta, "b": tb}
    for k in which:
        args[k] = args[k].bfloat16()
    got = fm.factor_matvec(args["x"], args["a"], ts, args["b"], alpha=0.7)
    assert got.shape == (bt, n_out) and got.dtype == torch.float32
    assert torch.equal(got, fm.factor_matvec(tx, ta, ts, tb, alpha=0.7))
    jargs = {k: jnp.asarray(v, jnp.bfloat16 if k in which else jnp.float32)
             for k, v in ops.items()}
    want = jfm.factor_matvec(jargs["x"], jargs["a"], jnp.asarray(s), jargs["b"], alpha=0.7,
                             block_b=32, block_o=64, interpret=True)
    _close(got, want)
    _close(got, jfm.ref.factor_matvec(jargs["x"], jargs["a"], 0.7 * jnp.asarray(s), jargs["b"]))
    _close(fm.ref.factor_matvec(args["x"], args["a"], 0.7 * ts, args["b"]), want)


@pytest.mark.parametrize("bt,n_in,r,n_out", SHAPES)
def test_plain_versions_match_jax(bt, n_in, r, n_out):
    """ref.factor_matvec and ref.dense_matvec against the JAX ref twins."""
    x, a, s, b = _inputs(bt, n_in, r, n_out, seed=1)
    jx, ja, js, jb = map(jnp.asarray, (x, a, s, b))
    _close(fm.ref.factor_matvec(*_t(x, a, s, b)), jfm.ref.factor_matvec(jx, ja, js, jb))
    _close(fm.ref.dense_matvec(*_t(x, a, s, b)), jfm.ref.dense_matvec(jx, ja, js, jb))


@pytest.mark.parametrize("transpose", [False, True])
def test_scoring_both_directions_matches_dense(transpose):
    """X @ W is factor_matvec(x, u, s, v) and X @ W^T factor_matvec(x, v, s, u)."""
    rng = np.random.default_rng(2)
    d, m, k = 30, 20, 4
    u, s, v = (rng.standard_normal((k, d)).astype(np.float32),
               rng.standard_normal(k).astype(np.float32),
               rng.standard_normal((k, m)).astype(np.float32))
    w = 0.6 * (u.T * s) @ v
    x = rng.standard_normal((5, m if transpose else d)).astype(np.float32)
    args = (v, s, u) if transpose else (u, s, v)
    got = fm.factor_matvec(*_t(x, *args), alpha=0.6)
    _close(got, x @ (w.T if transpose else w), rtol=1e-4, atol_rel=1e-5)


def test_rank_zero_is_exact_zeros_without_a_launch():
    kernels.reset_launches()
    x = torch.randn(9, 50)
    z = fm.factor_matvec(x, torch.zeros(0, 50), torch.zeros(0), torch.zeros(0, 30), alpha=1.3)
    assert z.shape == (9, 30) and z.dtype == torch.float32 and not torch.any(z)
    jz = jfm.factor_matvec(jnp.asarray(x.numpy()), jnp.zeros((0, 50)), jnp.zeros((0,)),
                           jnp.zeros((0, 30)), interpret=True)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert fm.factor_matvec.launches == 0


@pytest.mark.parametrize("live,cap", [(3, 16), (20, 32), (20, 64), (1, 8)])
def test_zero_tail_rows_are_exact_noops(live, cap):
    """Capacity rows with s == 0 change no bit: a padded rank bucket scores
    exactly what the live rank alone scores."""
    x, a, s, b = _inputs(6, 40, live, 20, seed=3)

    def pad(t):
        return np.concatenate([t, np.zeros((cap - live,) + t.shape[1:], np.float32)])

    live_scores = fm.factor_matvec(*_t(x, a, s, b), alpha=0.9)
    padded = fm.factor_matvec(*_t(x, pad(a), pad(s), pad(b)), alpha=0.9)
    assert torch.equal(live_scores, padded)


def test_alpha_is_folded_into_s():
    x, a, s, b = _t(*_inputs(5, 24, 4, 11, seed=4))
    folded = fm.factor_matvec(x, a, s * 0.3, b)
    assert torch.equal(fm.factor_matvec(x, a, s, b, alpha=0.3), folded)
    assert torch.equal(fm.factor_matvec(x, a, s, b, alpha=torch.tensor(0.3)), folded)
    assert torch.equal(fm.factor_matvec(x, a, s, b), fm.ref.factor_matvec(x, a, s, b))
    assert torch.equal(fm.factor_matvec(x, a, s.reshape(-1, 1), b),
                       fm.factor_matvec(x, a, s, b))


def test_wrapper_refuses_bad_operands():
    x, a, s, b = _t(*_inputs(5, 24, 4, 11, seed=5))
    with pytest.raises(TypeError, match="float32"):
        fm.factor_matvec(x.double(), a, s, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fm.factor_matvec(x, a, s, b.to(torch.float16))
    with pytest.raises(TypeError, match="float32"):
        fm.factor_matvec(x, a, s.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="contiguous"):
        fm.factor_matvec(torch.randn(24, 5).T, a, s, b)
    with pytest.raises(ValueError, match="shape"):
        fm.factor_matvec(x, a[:, :20], s, b)
    with pytest.raises(ValueError, match="shape"):
        fm.factor_matvec(x, a, s[:3], b)
    with pytest.raises(ValueError, match="2-D"):
        fm.factor_matvec(x[0], a, s, b)
    with pytest.raises(TypeError, match="alpha"):
        fm.factor_matvec(x, a, s, b, alpha=torch.tensor([0.5, 0.5]))
    meta = [t.to("meta") for t in (x, a, s, b)]
    with pytest.raises(ValueError, match="is on"):
        fm.factor_matvec(x, *meta[1:])
    with pytest.raises(ValueError, match="no kernel for device"):
        fm.factor_matvec(*meta)


@pytest.mark.parametrize("bt,r,batch_tile,batch_tiles,rank_tiles", [
    (1, 32, 16, 1, 1), (20, 32, 32, 1, 1), (64, 64, 64, 1, 1), (130, 256, 64, 3, 4),
    (300, 32, 64, 5, 1), (600, 64, 64, 10, 1), (1024, 256, 64, 16, 4),
])
def test_launch_plan_tiles_batch_and_ranks(bt, r, batch_tile, batch_tiles, rank_tiles):
    """A cluster of 16 blocks per batch tile of 16, 32 or 64 rows; ranks in
    tiles of 64. At the serving widths stage 1 splits 2048 inputs into 16
    chunks of 128 (1000 into 16 of 64) and stage 2 gives each block 64 (128)
    output columns, whatever the batch and the rank."""
    from repro_torch.kernels.factor_matvec import kernel

    plan = kernel.launch_plan(bt, 2048, r, 1000)
    assert (plan.batch_tile, plan.batch_tiles, plan.rank_tiles) == (
        batch_tile, batch_tiles, rank_tiles)
    assert plan.m_tiles * 16 == plan.batch_tile and plan.blocks == 16 * batch_tiles
    assert (plan.chunks, plan.chunk_width, plan.out_cols) == (16, 128, 64)
    back = kernel.launch_plan(bt, 1000, r, 2048)
    assert (back.chunks, back.chunk_width, back.out_cols) == (16, 64, 128)


@pytest.mark.parametrize("n_in", [0, 1, 7, 64, 65, 129, 300, 449, 1000, 2048, 4096, 100003])
def test_launch_plan_stage1_split_depends_on_n_in_alone(n_in):
    """Stage 1's chunks (the order of every sum) are a function of n_in
    only, at most one per block of the cluster, each a multiple of 8 wide,
    covering n_in with none empty; the batch, the rank and n_out change the
    tiles and never the split."""
    from repro_torch.kernels.factor_matvec import kernel

    plans = [kernel.launch_plan(bt, n_in, r, n_out)
             for bt in (1, 33, 1024) for r in (1, 64, 5000) for n_out in (1, 1000, 4100)]
    split = {(p.chunks, p.chunk_width) for p in plans}
    assert len(split) == 1
    chunks, width = split.pop()
    assert 1 <= chunks <= kernel.CLUSTER and width % 8 == 0 and width >= 8
    assert (chunks - 1) * width < max(n_in, 1) <= max(chunks * width, 1)
    with pytest.raises(ValueError):
        kernel.launch_plan(0, n_in, 1, 1)


def test_phase_tool_instruments_the_kernel_source():
    """tools/torch_factor_matvec_phases.py edits the kernel's text to add its
    phase stamps and skip switches: every edit still finds its line in
    csrc/factor_matvec.cu (the tool itself runs only on the card)."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_factor_matvec_phases", root / "tools" / "torch_factor_matvec_phases.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src" / "repro_torch" / "csrc" / "factor_matvec.cu").read_text()
    out = tool.instrumented(src)
    assert out.count("clock64()") == 7 and out.count("long long* dbg, int skip") == 3
    assert "(skip & 1)" in out and "(skip & 2)" in out and "(skip & 4)" in out
