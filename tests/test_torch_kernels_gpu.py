"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the CUDA graphs (the engine's segment programs, the serving engine's
scorer a rank bucket, ``generate``'s decode step) against the same work run
uncaptured (``captured`` in their names: the same bits, launches and stats).

Every test here is marked ``gpu`` and skips without CUDA. This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX.) Tolerances: the
matvecs sum in another order than cuBLAS (the COO matvec than the atomics of
``index_add_``, factor_matvec than its rank-by-rank plain version, on the
tensor cores in 3xTF32), so rtol 1e-4 with an atol of 1e-5 times
max|plain|; flash attention's online softmax sums in another order than one
softmax over the row, so each query row is held to its own max|plain| (f32:
1e-4; bf16: 1e-2, the output's rounding); the rank-1 update and the quantize pair are spelled in their
plain versions' order and must match them bit for bit. The WKV6 chunk is
held to its plain chunk form taken in f64 on the same inputs, each (head,
row) of y to its own max and S_out to its max, 2e-4 (the kernel's 3xTF32
products, about 2^-20 of each product, and its prefix sums rounded to f32,
which the clamped exp factors carry relatively), and at q = 32 to the exact recurrence as the JAX
package's test holds its kernel (rtol = atol = 2e-4, f32); the ssm, audio,
vlm and hybrid smoke models' prefill on the card to the CPU's as the dense
one's.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import power_matvec as pm
from repro_torch.kernels import rank1_update as r1

SHAPES = [(512, 48), (300, 40), (65, 33), (37, 5), (1, 7)]


def _close(got, want, rtol=1e-4, atol_rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(float(np.max(np.abs(want))), 1e-30)
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _misaligned(shape, device):
    """A contiguous float32 tensor whose data starts 4 bytes past a 16-byte
    boundary, so the kernels take their scalar (non-float4) path."""
    numel = int(np.prod(shape))
    return torch.randn(numel + 1, device=device)[1:].view(*shape)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", SHAPES + [(5000, 1000), (4099, 2048), (70001, 12),
                                         (1, 1000), (2, 1000), (3, 1000), (9, 1000),
                                         (9, 1001)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_power_matvec_matches_plain(cuda, n, m, aligned):
    """Row counts 1-3 and 9 leave the last warp's group of four rows partly
    past n; m = 1001 takes the 4-byte path even when aligned."""
    a = torch.randn(n, m, device=cuda) if aligned else _misaligned((n, m), cuda)
    v, u = torch.randn(m, device=cuda), torch.randn(n, device=cuda)
    before = kernels.launches()
    got = pm.matvec(a, v)
    _close(got.cpu(), pm.ref.matvec(a, v).cpu())
    out = pm.rmatvec(a, u)
    _close(out.cpu(), pm.ref.rmatvec(a, u).cpu())
    torch.cuda.synchronize()
    assert kernels.launches()["matvec"] == before["matvec"] + 1
    assert kernels.launches()["rmatvec"] == before["rmatvec"] + 1
    # two-stage fixed-order reduction: repeated calls give identical bits
    assert torch.equal(pm.rmatvec(a, u), out)
    # each row's sum in one fixed order: identical bits on repeat
    assert torch.equal(pm.matvec(a, v), got)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", SHAPES + [(5000, 1000), (333, 37)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_rank1_update_matches_plain(cuda, n, m, aligned):
    make = (lambda s: torch.randn(*s, device=cuda)) if aligned else (
        lambda s: _misaligned(s, cuda))
    z, y0 = make((n, m)), make((n, m))
    x, y = torch.randn(n, device=cuda), torch.randn(m, device=cuda)
    g = torch.full((), 0.3, device=cuda)
    scal2 = torch.stack([1.0 - g, -g * 2.0])
    scal3 = torch.stack([1.0 - g, -g * 2.0, -g])
    want = r1.ref.rank1_update(z, x, y, scal2)
    assert torch.equal(r1.rank1_update(z, x, y, 1.0 - g, -g * 2.0), want)
    want = r1.ref.rank1_update_axpy(z, y0, x, y, scal3)
    got = r1.rank1_update_axpy(z, y0, x, y, 1.0 - g, -g * 2.0, -g, out=z)
    assert got is z and torch.equal(z, want)


def _coo(n_rows, n_cols, p, device, seed=0, heavy=0, long_row=0):
    """COO entries with a skewed row law, duplicates, an empty row and column
    and ``heavy`` extra entries in column 1 (several kernel pieces); with
    ``long_row``, that many more in row 3 (a segment longer than a piece)
    beside one entry in each row from 5 on (many one-entry segments)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = (torch.arange(n_rows, dtype=torch.float64) + 1) ** -0.6
    rows = torch.multinomial(w, p, replacement=True, generator=g)
    cols = torch.randint(0, n_cols, (p,), generator=g)
    if heavy:
        rows = torch.cat([rows, torch.randint(0, n_rows, (heavy,), generator=g)])
        cols = torch.cat([cols, torch.ones(heavy, dtype=torch.long)])
    if long_row:
        rows = torch.cat([rows, torch.full((long_row,), 3), torch.arange(5, n_rows)])
        cols = torch.cat([cols, torch.randint(0, n_cols, (long_row + n_rows - 5,),
                                              generator=g)])
    rows[rows == 2] = 1
    cols[cols == 0] = 1
    vals = torch.randn(rows.numel(), generator=g)
    return (rows.to(torch.int32).to(device), cols.to(torch.int32).to(device),
            vals.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy", [(40, 30, 600, 0), (1000, 300, 50000, 5000),
                                         (20000, 17, 300000, 0), (3, 5000, 7, 0)])
def test_cuda_coo_matvec_matches_plain(cuda, d, m, p, heavy):
    """The kernel on the values' sorted copies (``gather_sorted``)."""
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy)
    v, u = torch.randn(m, device=cuda), torch.randn(d, device=cuda)
    by_row, by_col = mc.build_order(rows, cols, d, m), mc.build_order(cols, rows, m, d)
    vr, vc = mc.gather_sorted(by_row, vals), mc.gather_sorted(by_col, vals)
    before = kernels.launches()["coo_matvec"]
    gv = mc.coo_matvec(by_row, vr, v)
    gu = mc.coo_matvec(by_col, vc, u)
    torch.cuda.synchronize()
    assert kernels.launches()["coo_matvec"] == before + 2
    _close(gv.cpu(), mc.ref.coo_matvec(rows, cols, vals, v, d).cpu())
    _close(gu.cpu(), mc.ref.coo_matvec(cols, rows, vals, u, m).cpu())
    if d > 3:
        assert float(gv[2]) == 0.0 and float(gu[0]) == 0.0  # empty row and column
    # no atomics: repeated calls give identical bits
    assert torch.equal(mc.coo_matvec(by_row, vr, v), gv)
    assert torch.equal(mc.coo_matvec(by_col, vc, u), gu)
    # zero-weight padding at (0, 0) changes no bit
    pad = torch.zeros(37, dtype=torch.int32, device=cuda)
    rows_p, cols_p = torch.cat([rows, pad]), torch.cat([cols, pad])
    vals_p = torch.cat([vals, torch.zeros(37, device=cuda)])
    for seg, gat, od, idim, x, want in ((rows_p, cols_p, d, m, v, gv),
                                        (cols_p, rows_p, m, d, u, gu)):
        order = mc.build_order(seg, gat, od, idim)
        assert torch.equal(mc.coo_matvec(order, mc.gather_sorted(order, vals_p), x), want)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 4, 5, 1023, 300001])
def test_cuda_gather_sorted_is_vals_perm_bit_for_bit(cuda, p):
    """The refresh gather equals vals[perm] bit for bit, at lengths that take
    its four-a-thread and scalar tails; one launch a call."""
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(50, 40, p, cuda, seed=p)
    for order in (mc.build_order(rows, cols, 50, 40), mc.build_order(cols, rows, 40, 50)):
        before = kernels.launches()["gather_sorted"]
        got = mc.gather_sorted(order, vals)
        torch.cuda.synchronize()
        assert kernels.launches()["gather_sorted"] == before + 1
        assert torch.equal(got, vals[order.perm.long()])


def _offset(t, words):
    """A copy of t (contiguous) whose data starts ``words`` 4-byte words past
    a 16-byte boundary."""
    buf = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)
    out = buf[words:]
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 4, 5, 4097, 2**20 + 3])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cuda_record_gather_is_field_perm_bit_for_bit(cuda, p, offset):
    """The record gather (a state's copies: pack, then one 16-byte record
    read per entry) gives field[perm] bit for bit for f32 and int32 fields
    that start off a 16-byte boundary (``offset`` words), at lengths that
    take its four-a-thread and scalar tails; with a perm off alignment too
    (the gather's scalar path); one launch a call, and build_order_with_copies
    gives build_order's order."""
    import dataclasses

    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(50, 40, p, cuda, seed=p)
    w = (torch.arange(p, device=cuda) % 5 != 0).float()
    ints = torch.randint(-2**31, 2**31 - 1, (p,), device=cuda, dtype=torch.int32)
    fields = [_offset(t, offset) for t in (w * vals, ints, w)]
    for seg, gat, od, idim in ((rows, cols, 50, 40), (cols, rows, 40, 50)):
        before = kernels.launches()["gather_sorted"]
        order, copies = mc.build_order_with_copies(seg, gat, od, idim, fields)
        torch.cuda.synchronize()
        assert kernels.launches()["gather_sorted"] == before + 1
        perm = order.perm.long()
        want = mc.build_order(seg, gat, od, idim)
        assert torch.equal(order.perm, want.perm) and torch.equal(order.gat_sorted, gat[perm])
        for t, c in zip(fields, copies):
            assert c.dtype == t.dtype and torch.equal(c, t[perm])
        odd = dataclasses.replace(order, perm=_offset(order.perm, 1))
        for n in (1, 2, 4):
            got = mc.gather_sorted_fields(odd, [*fields, gat][:n])
            torch.cuda.synchronize()
            for t, c in zip([*fields, gat], got):
                assert torch.equal(c, t[perm])
        assert kernels.launches()["gather_sorted"] == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy", [(40, 30, 600, 0), (1000, 300, 50000, 5000),
                                         (20000, 17, 300001, 0), (3, 5000, 7, 0)])
@pytest.mark.parametrize("gamma_from", ["linesearch", "schedule"])
@pytest.mark.parametrize("mu", [0.0, 2.718281828459045])
def test_cuda_update_resid_is_the_chain_bit_for_bit(cuda, d, m, p, heavy, gamma_from, mu):
    """update_resid's three outputs equal MatrixCompletion's chain on the
    card followed by gather_sorted, bit for bit, for gamma from the line
    search's clamp and from the 2/(t+2) schedule, and mu = 0; one launch a
    call. Zero-weight entries (a third of them) stay exactly 0."""
    from repro_torch.core import tasks
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy)
    weight = (torch.arange(rows.numel(), device=cuda) % 3 != 0).float()
    resid = weight * torch.randn(rows.numel(), device=cuda)
    state = tasks.mc_state(rows, cols, vals, resid, weight, d, m)
    u, v = torch.randn(d, device=cuda), torch.randn(m, device=cuda)
    if gamma_from == "linesearch":
        gamma = torch.clamp(torch.tensor(0.7, device=cuda) / torch.clamp(
            torch.tensor(3.1, device=cuda), min=1e-30), 0.0, 1.0)
    else:
        gamma = 2.0 / (torch.full((), 5.0, device=cuda) + 2.0)
    want = mc.ref.resid_step(gamma, mu, resid, vals, weight, u[rows], v[cols])
    before = kernels.launches()["update_resid"]
    got = tasks.MatrixCompletion(d, m).update(state, u, v, gamma, mu)
    torch.cuda.synchronize()
    assert kernels.launches()["update_resid"] == before + 1
    assert torch.equal(got.resid, want)
    assert torch.equal(got.resid_by_row, mc.gather_sorted(state.by_row, want))
    assert torch.equal(got.resid_by_col, mc.gather_sorted(state.by_col, want))
    assert not torch.any(got.resid[weight == 0])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 37, 1000, 17_770, 135_168, 135_171, 480_189])
@pytest.mark.parametrize("budget", [127, 15, 1])
def test_cuda_quantize_pair_matches_plain_bit_for_bit(cuda, n, budget):
    from repro_torch.kernels import quantize as qz

    x = torch.randn(n, device=cuda) * 3.0
    noise = torch.rand(n, device=cuda)
    scale = torch.max(torch.abs(x))
    # values on and beside the integer grid, where an FMA would floor differently
    k = torch.arange(n, device=cuda, dtype=torch.float32) % (2 * budget + 1) - budget
    grid = k * scale / budget
    before = kernels.launches()
    for xs, ns in ((x, noise), (grid, torch.zeros_like(grid)), (grid, torch.full_like(grid, 0.5))):
        q = qz.quantize(xs, ns, scale, budget=budget)
        assert q.dtype == torch.int8
        assert torch.equal(q, qz.ref.quantize(xs, ns, scale, budget))
        y = qz.dequantize(q, scale, budget=budget)
        assert torch.equal(y, qz.ref.dequantize(q, scale, budget))
        # q one byte off alignment: dequantize's scalar path (from n = 135,168,
        # four a thread where aligned)
        q_off = torch.empty(n + 1, dtype=torch.int8, device=cuda)[1:]
        q_off.copy_(q)
        assert torch.equal(qz.dequantize(q_off, scale, budget=budget), y)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["quantize"] == before["quantize"] + 3
    assert after["dequantize"] == before["dequantize"] + 6


@pytest.mark.gpu
def test_cuda_logistic_fit_repeats_its_bits(cuda):
    """Two logistic fits on the card give the same bits: the label sum is a
    segment sum in a fixed order (index_add_'s atomics were not)."""
    from repro_torch.core import low_rank, tasks
    from repro_torch.launch import dfw

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    n, d, m = 20_000, 64, 40
    x = torch.randn(n, d, generator=gen, device=cuda)
    labels = torch.randint(0, m, (n,), generator=gen, device=cuda)
    cfg = dfw.DFWConfig(mu=5.0, num_epochs=6, schedule="log_half", verify_kernels=False)
    runs = [dfw.fit_serial(tasks.MultinomialLogistic(d, m), x, labels, cfg=cfg, key=1,
                           device=cuda) for _ in range(2)]
    assert runs[0].history == runs[1].history
    assert torch.equal(low_rank.materialize(runs[0].iterate),
                       low_rank.materialize(runs[1].iterate))


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts k elements past the
    allocation's start (k = 0: aligned as allocated)."""
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:]
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17_770, 135_167, 135_168, 135_171, 480_189])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 0, 0), (0, 2, 0), (0, 0, 3), (3, 1, 2)])
@pytest.mark.parametrize("budget", [1, 31, 127])
def test_cuda_quantize_vector_path_bit_for_bit(cuda, n, offsets, budget):
    """quantize's four-a-thread path (n >= 135,168, x and noise 16-byte and q
    4-byte aligned) and its one-a-thread path (below that n, past the last
    four, any pointer off its alignment) give the plain version's bits: on
    random x, at x = +-s (the clip), and where x * inv + noise lands exactly
    on an integer (an FMA would floor differently there)."""
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + budget)
    x = torch.randn(n, generator=gen, device=cuda) * 3.0
    scale = torch.max(torch.abs(x))
    x[:: 97] = scale
    x[1:: 89] = -scale
    noise = torch.rand(n, generator=gen, device=cuda)
    inv = torch.full_like(scale, float(budget)) / (scale + 1e-30)
    k = torch.arange(n, device=cuda, dtype=torch.float32) % (2 * budget + 1) - budget
    grid = k / inv  # x * inv lands on (or within an ulp of) the integer k
    half = torch.where(torch.arange(n, device=cuda) % 2 == 0, 0.0, 0.5)
    cases = ((x, noise), (grid, torch.zeros_like(grid)), (grid, half.float()),
             (grid, torch.nextafter(torch.ones_like(grid), torch.zeros_like(grid))))
    ox, on, oq = offsets
    before = kernels.launches()["quantize"]
    for xs, ns in cases:
        want = qz.ref.quantize(xs, ns, scale, budget)
        got = qz.quantize(_offset(xs, ox), _offset(ns, on), scale, budget=budget)
        assert torch.equal(got, want)
        if oq:  # the kernel writing into a q off its 4-byte alignment
            out = torch.empty(n + oq, dtype=torch.int8, device=cuda)[oq:]
            qz.kernel.quantize(_offset(xs, ox), _offset(ns, on), scale, out, budget)
            assert torch.equal(out, want)
    torch.cuda.synchronize()
    assert kernels.launches()["quantize"] == before + len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("bt,n_in,r,n_out", [
    (1, 2048, 32, 1000), (64, 2048, 64, 1000), (64, 1000, 64, 2048), (1024, 2048, 256, 1000),
    (3, 129, 7, 65), (130, 300, 7, 65), (33, 129, 12, 257), (5, 64, 5000, 40),
    (300, 2048, 64, 1000), (600, 1000, 64, 2048), (300, 129, 7, 65), (600, 300, 33, 257),
    (1024, 1000, 256, 2048), (17, 129, 65, 7), (16, 300, 64, 4100), (2, 0, 3, 5),
    (3, 8, 5, 12), (20, 4, 70, 16),
])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_factor_matvec_matches_plain(cuda, bt, n_in, r, n_out, aligned):
    """Kernel against its plain version (the same sums in another order, on
    the tensor cores in 3xTF32: rtol 1e-4, atol 1e-5 of max), identical bits
    on repeat, one launch a call. The shapes take each batch tile (16, 32
    and 64 rows), several rank tiles (r = 65, 70, 256, 5000), stage-1 chunks
    of every kind (n_in = 0, 4, 8, 64, 129, 300, 1000, 2048; copy-engine
    boxes wider than n_in) and stage 2 in more than one pass of columns
    (n_out = 4100)."""
    from repro_torch.kernels import factor_matvec as fm

    make = (lambda s: torch.randn(*s, device=cuda)) if aligned else (
        lambda s: _misaligned(s, cuda))
    x, a, b = make((bt, n_in)) / n_in ** 0.5, make((r, n_in)), make((r, n_out))
    s = torch.randn(r, device=cuda)
    before = kernels.launches()["factor_matvec"]
    got = fm.factor_matvec(x, a, s, b, alpha=0.7)
    torch.cuda.synchronize()
    assert kernels.launches()["factor_matvec"] == before + 1
    assert got.shape == (bt, n_out)
    _close(got.cpu(), fm.ref.factor_matvec(x, a, 0.7 * s, b).cpu())
    assert torch.equal(fm.factor_matvec(x, a, s, b, alpha=0.7), got)


@pytest.mark.gpu
@pytest.mark.parametrize("live,cap", [(20, 32), (20, 64), (1, 32), (30, 5000), (70, 256)])
@pytest.mark.parametrize("bt", [1, 20, 64, 300, 600, 1024])
@pytest.mark.parametrize("n_in,n_out", [(2048, 1000), (1000, 2048), (129, 4100)])
def test_cuda_factor_matvec_zero_tail_gives_the_same_bits(cuda, live, cap, bt, n_in, n_out):
    """Rows past the live rank (s = 0, zero factors) change no bit, whatever
    the capacity, the batch tile and the number of rank tiles and column
    passes."""
    from repro_torch.kernels import factor_matvec as fm

    x = torch.randn(bt, n_in, device=cuda)
    a, s, b = (torch.randn(live, n_in, device=cuda), torch.randn(live, device=cuda),
               torch.randn(live, n_out, device=cuda))

    def pad(t):
        return torch.cat([t, torch.zeros((cap - live,) + t.shape[1:], device=cuda)])

    assert torch.equal(fm.factor_matvec(x, pad(a), pad(s), pad(b)),
                       fm.factor_matvec(x, a, s, b))


@pytest.mark.gpu
def test_cuda_serving_engine_scores_and_swaps(cuda):
    """The engine on the card: start-up check (2 launches), scores against
    the dense product, an in-flight batch keeps the old model."""
    from repro_torch import serve

    rng = np.random.default_rng(0)

    def packed(k):
        return {"u": rng.standard_normal((k, 300)).astype(np.float32),
                "s": rng.standard_normal(k).astype(np.float32),
                "v": rng.standard_normal((k, 200)).astype(np.float32),
                "alpha": np.float32(0.5), "count": np.int32(k)}

    def dense(p):
        return 0.5 * (p["u"].T * p["s"]) @ p["v"]

    before = kernels.launches()["factor_matvec"]
    with kernels.Executed() as ran:
        eng = serve.ServingEngine(300, 200, serve.ServeConfig(max_batch=16, rank_block=8))
        old, new = packed(5), packed(7)
        eng.load(old)
        x = rng.standard_normal((9, 300)).astype(np.float32)
        first = eng.score_async(x)
        eng.load(new)
        second = eng.score_async(x)
        got_first, got_second = first.block(), second.block()
    np.testing.assert_allclose(got_first, x @ dense(old), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_second, x @ dense(new), rtol=1e-4, atol=1e-4)
    assert (first.version, second.version) == (0, 1)
    # calls: the start-up check's 2, the bucket's warm-up and its capture;
    # the device ran the check's 2, the warm-up and one replay a dispatch
    assert kernels.launches()["factor_matvec"] == before + 2 + 1 + 1
    assert ran.launches["factor_matvec"] == 2 + 1 + 2
    assert eng.stats == {"compilations": 1, "dispatches": 2, "loads": 2, "requests": 18}


def _serving(cuda, rank_block=8, transpose=False):
    """A captured engine on the card at 300 x 200 (batch 16) and a source of
    pack_live dicts of a given live rank."""
    from repro_torch import serve

    rng = np.random.default_rng(1)

    def packed(k):
        return {"u": rng.standard_normal((k, 300)).astype(np.float32),
                "s": rng.standard_normal(k).astype(np.float32),
                "v": rng.standard_normal((k, 200)).astype(np.float32),
                "alpha": np.float32(0.5), "count": np.int32(k)}

    eng = serve.ServingEngine(300, 200, serve.ServeConfig(max_batch=16, rank_block=rank_block,
                                                          transpose=transpose), device=cuda)
    return eng, packed, rng


def _uncaptured(fm, model, x, max_batch, transpose=False):
    """factor_matvec called directly on the model's factors and x zero-padded
    to the engine's batch: the caller's rows."""
    a, b = (model.v, model.u) if transpose else (model.u, model.v)
    pad = torch.zeros((max_batch, x.shape[1]), device=model.u.device)
    pad[:x.shape[0]] = torch.from_numpy(x).to(pad.device)
    return fm.factor_matvec(pad, a, model.s_alpha, b)[:x.shape[0]].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("transpose", [False, True])
def test_cuda_captured_engine_scores_are_the_kernels_bits(cuda, transpose):
    """One captured scorer a rank bucket: every dispatch a replay (counted on
    the device), its scores the uncaptured kernel's bits on the same padded
    rows and factors, across three buckets and back."""
    from repro_torch.kernels import factor_matvec as fm

    eng, packed, rng = _serving(cuda, transpose=transpose)
    n_in = 200 if transpose else 300
    served = []
    with kernels.Executed() as ran:
        for live in (3, 8, 12, 20, 5):
            eng.load(packed(live))
            for b in (1, 9, 16):
                x = rng.standard_normal((b, n_in)).astype(np.float32)
                served.append((eng.model, x, eng.score(x)))
    assert eng.stats["compilations"] == 3 and eng.stats["dispatches"] == 15
    assert len(eng.timings["capture_ms"]) == len(eng.timings["pool_bytes"]) == 3
    assert ran.launches["factor_matvec"] == 2 + 3 + 15  # check, warm-ups, replays
    for model, x, got in served:
        assert np.array_equal(got, _uncaptured(fm, model, x, 16, transpose))


@pytest.mark.gpu
def test_cuda_captured_dispatches_in_flight_keep_their_rows(cuda):
    """Many dispatches queued before any is read: each handle keeps its own
    rows (the scores leave the bucket's static output before the next
    replay), as the MicroBatcher's batches in flight do."""
    from repro_torch import serve
    from repro_torch.kernels import factor_matvec as fm

    eng, packed, rng = _serving(cuda)
    eng.load(packed(6))
    xs = [rng.standard_normal((16, 300)).astype(np.float32) for _ in range(8)]
    handles = [eng.score_async(x) for x in xs]
    batcher = serve.MicroBatcher(eng, flush_at=4)
    singles = rng.standard_normal((12, 300)).astype(np.float32)
    tickets = [batcher.submit(q) for q in singles]
    for x, h in zip(xs, handles):
        assert np.array_equal(h.block(), _uncaptured(fm, eng.model, x, 16))
    want = _uncaptured(fm, eng.model, singles, 16)
    assert np.array_equal(np.stack([t.result() for t in tickets]), want)


@pytest.mark.gpu
def test_cuda_captured_same_bucket_hot_swap_keeps_a_pending_handle(cuda):
    """A swap inside one bucket overwrites its slots on the serving stream,
    after the pending replay: the pending handle scores the old model's
    bits, the next dispatch the new one's; no new capture."""
    from repro_torch.kernels import factor_matvec as fm

    eng, packed, rng = _serving(cuda)
    old = eng.load(packed(3))
    x = rng.standard_normal((16, 300)).astype(np.float32)
    pending = eng.score_async(x)
    new = eng.load(packed(7))
    after = eng.score_async(x)
    assert old.capacity == new.capacity and eng.stats["compilations"] == 1
    assert pending.version == 0 and after.version == 1
    assert np.array_equal(pending.block(), _uncaptured(fm, old, x, 16))
    assert np.array_equal(after.block(), _uncaptured(fm, new, x, 16))


@pytest.mark.gpu
def test_cuda_captured_dispatch_under_the_contract_guard(cuda):
    """``score_async`` of a full batch under ``Contract.guard()`` makes no
    implicit host sync (the guard raises on one, as a ``.item()`` shows);
    ``check_contract`` pins the captures at the buckets visited."""
    from repro_torch.analysis.contracts import ContractViolation

    eng, packed, rng = _serving(cuda, rank_block=4)
    for live in (2, 6, 3):
        eng.load(packed(live))
    x = rng.standard_normal((16, 300)).astype(np.float32)
    eng.score(x)
    with eng.contract().guard():
        pending = eng.score_async(x)
        with pytest.raises(RuntimeError):
            torch.ones(1, device=cuda).item()
    assert pending.block().shape == (16, 200)
    eng.check_contract(eng.contract(max_compilations=2))
    with pytest.raises(ContractViolation, match="compilations"):
        eng.check_contract(eng.contract(max_compilations=1))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "rwkv6_7b", "qwen2_vl_72b", "zamba2_2_7b",
                                  "arctic_480b", "llama4_scout_17b_a16e"])
def test_cuda_captured_generate_is_the_step_loop_bit_for_bit(cuda, arch):
    """``generate`` on the card replays one captured step a position (one
    capture a call): its tokens and the cache it filled equal a loop of the
    uncaptured serve step's bit for bit (vlm: the loop passes M-RoPE
    positions (t, t, t), the captured step makes them from its device
    position; hybrid: the Mamba-2 states and conv windows too; moe: the
    routing, the capacity selection and the combine inside the graph, which
    a host synchronisation would have broken at capture); no kernel
    launch on the device; temperature sampling through the registered
    generator repeats with the seed and stays in range."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True)
    b, plen, new_n = 3, 6, 5
    params = lm.init_params(cfg, 2, device=cuda)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, plen))
    cache = lm.init_cache(cfg, b, plen + new_n, device=cuda)
    stats = {}
    with kernels.Executed() as ran:
        got = lm_serve.generate(arch=arch, batch=b, prompt_len=plen, max_new_tokens=new_n,
                                device=cuda, params=params, prompt=prompt, cache=cache,
                                stats=stats)
    assert all(v == 0 for v in ran.launches.values()), ran.launches
    assert stats["captures"] == 1 and stats["graph_replays"] == plen + new_n - 1
    step, toks = steps.make_serve_step(cfg), []
    want_cache = lm.init_cache(cfg, b, plen + new_n, device=cuda)
    ptoks = torch.from_numpy(prompt).to(cuda)
    for t in range(plen + new_n - 1):
        cur = ptoks[:, t:t + 1] if t < plen else toks[-1]
        sb = {"tokens": cur, "cache_pos": t}
        if cfg.family == "vlm":
            sb["positions"] = torch.full((b, 3, 1), t, dtype=torch.int64, device=cuda)
        logits, _ = step(params, want_cache, sb)
        if t >= plen - 1:
            toks.append(torch.argmax(logits[:, 0, :].float(), dim=-1, keepdim=True))
    assert np.array_equal(got, torch.cat(toks, dim=1).cpu().numpy())
    for name in cache:
        assert torch.equal(cache[name], want_cache[name]), name
    kw = dict(arch=arch, batch=b, prompt_len=plen, max_new_tokens=new_n, device=cuda,
              params=params, temperature=1.0, seed=4)
    hot = lm_serve.generate(**kw)
    assert np.array_equal(hot, lm_serve.generate(**kw))
    assert hot.min() >= 0 and hot.max() < cfg.vocab_size


def _attention_inputs(b, hq, hkv, sq, skv, dh, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, h, s, dh, generator=g, device=device).to(dtype)
            for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]


def _flash_check(fa, q, k, v, causal, tol):
    """One call against the plain version on the f32 upcast, each query row
    to its own max|plain|; identical bits on repeat; the route it took."""
    dh = q.shape[-1]
    before = kernels.route_launches()["flash_attention"]
    got = fa.flash_attention(q, k, v, scale=dh**-0.5, causal=causal)
    torch.cuda.synchronize()
    after = kernels.route_launches()["flash_attention"]
    routes = [r for r in after if after[r] != before[r]]
    assert len(routes) == 1 and after[routes[0]] == before[routes[0]] + 1, (before, after)
    assert got.shape == q.shape and got.dtype == q.dtype
    want = fa.ref.attention(q.float(), k.float(), v.float(), scale=dh**-0.5, causal=causal)
    err = float(((got.float() - want).abs().amax(-1) / want.abs().amax(-1)).max())
    assert err <= tol, err
    assert torch.equal(fa.flash_attention(q, k, v, scale=dh**-0.5, causal=causal), got)
    return routes[0]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh", [
    (2, 4, 2, 96, 96, 32), (1, 2, 2, 50, 70, 16), (1, 2, 2, 70, 50, 16), (2, 8, 1, 50, 70, 12),
    (1, 4, 4, 1, 70, 64), (2, 12, 2, 512, 512, 128), (1, 6, 3, 300, 300, 100),
    (1, 2, 1, 1000, 1000, 128), (3, 2, 2, 129, 257, 65),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, b, hq, hkv, sq, skv, dh, causal, dtype):
    """Kernel against the plain version on the f32-upcast inputs, each query
    row to its own max|plain| (late causal rows average many keys and are
    smaller than the first): f32 to 1e-4 (softmax sums in another order),
    bf16 to 1e-2 (the output's bf16 rounding); identical bits on repeat; one launch a
    call. bf16 with Dh 64 or 128 takes the wgmma route, the rest the generic
    one: Dh 12, 16, 32 and 65/100 run in its 64 and 128 builds with a zero
    tail; Dh 100 and 65 in bf16 take the element-load path."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(b, hq, hkv, sq, skv, dh, dtype, cuda)
    before = kernels.launches()["flash_attention"]
    route = _flash_check(fa, q, k, v, causal, 1e-4 if dtype == torch.float32 else 1e-2)
    assert kernels.launches()["flash_attention"] == before + 2
    assert route == ("wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "generic")


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv", [
    (1, 2, 2, 127, 127), (2, 2, 1, 129, 129), (1, 6, 1, 129, 300), (2, 4, 2, 300, 129),
    (1, 2, 1, 127, 1000), (1, 12, 2, 1000, 127), (1, 2, 2, 8191, 8191),
])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_wgmma_ragged_shapes(cuda, b, hq, hkv, sq, skv, dh, causal):
    """The wgmma route at ragged Sq and Skv around its 128-row tiles (127,
    129, 8191; Sq != Skv both ways; top-left causal), group sizes 1, 2 and
    6, Dh 64 and 128, bf16: each query row within 1e-2 of its own max, the
    same bits on repeat."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(b, hq, hkv, sq, skv, dh, torch.bfloat16, cuda, seed=sq + skv)
    assert _flash_check(fa, q, k, v, causal, 1e-2) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv", [
    (2, 56, 8, 300, 300), (2, 40, 8, 257, 257), (1, 7, 1, 129, 129), (1, 5, 1, 127, 1000),
    (1, 14, 2, 1000, 127), (1, 10, 2, 2048, 2048),
])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_wgmma_odd_groups(cuda, b, hq, hkv, sq, skv, causal):
    """The moe family's GQA groups on the wgmma route (bf16, Dh 128):
    arctic-480b's 56 / 8 = 7 and llama4-scout's 40 / 8 = 5 query heads a kv
    head (the kernel maps head h to kv head h / group), at ragged S around
    its 128-row tiles: each query row within 1e-2 of its own max, the same
    bits on repeat."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(b, hq, hkv, sq, skv, 128, torch.bfloat16, cuda, seed=hq + sq)
    assert _flash_check(fa, q, k, v, causal, 1e-2) == "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv", [
    (2, 16, 16, 1500, 1500), (1, 32, 32, 300, 300), (1, 4, 4, 129, 257), (1, 4, 2, 257, 129),
    (3, 2, 1, 1, 70),
])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_dh80_bf16(cuda, b, hq, hkv, sq, skv, causal):
    """Dh 80 in bf16 (hubert-xlarge's and zamba2-2.7b's heads) takes the
    generic route (its 128 build, a zero tail): ragged S around its 64-row
    tiles, hubert's 1,500 frames, full and causal, each query row within
    1e-2 of its own max, the same bits on repeat."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(b, hq, hkv, sq, skv, 80, torch.bfloat16, cuda, seed=sq + skv)
    assert _flash_check(fa, q, k, v, causal, 1e-2) == "generic"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_reads_head_major_views(cuda, dtype):
    """The (B, S, H * Dh) projections' head-major views go in without a
    copy and give the bits of their contiguous copies, on either route (bf16:
    wgmma, whose tensor maps take the views' strides; f32: generic)."""
    from repro_torch.kernels import flash_attention as fa

    x = torch.randn(2, 300, 14 * 128, device=cuda).to(dtype)
    q = x[..., :12 * 128].reshape(2, 300, 12, 128).transpose(1, 2)
    k = x[..., 12 * 128:13 * 128].reshape(2, 300, 1, 128).transpose(1, 2)
    v = x[..., 13 * 128:].reshape(2, 300, 1, 128).transpose(1, 2)
    assert not q.is_contiguous()
    route = "wgmma" if dtype == torch.bfloat16 else "generic"
    before = kernels.route_launches()["flash_attention"][route]
    got = fa.flash_attention(q, k, v, scale=0.1, causal=True)
    assert torch.equal(got, fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                               scale=0.1, causal=True))
    assert kernels.route_launches()["flash_attention"][route] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "starcoder2_7b"])
def test_cuda_dense_lm_prefill_matches_cpu(cuda, arch):
    """A dense smoke model's prefill on the card (the flash kernel, one launch
    per layer) against the CPU (plain versions), same weights, f32: logits
    and cache to rtol 1e-4 / atol 1e-4 of max; decode continues it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True)
    cpu_params = lm.init_params(cfg, 0, device="cpu")
    dev_params = lm_to(cpu_params, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=torch.Generator().manual_seed(1))
    before = kernels.launches()["flash_attention"]
    last, cache = steps.make_prefill_step(cfg)(dev_params, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert kernels.launches()["flash_attention"] == before + cfg.num_layers
    want_last, want_cache = steps.make_prefill_step(cfg)(cpu_params, {"tokens": toks})
    _close(last.cpu(), want_last, atol_rel=1e-4)
    _close(cache["k"].cpu(), want_cache["k"], atol_rel=1e-4)
    _close(cache["v"].cpu(), want_cache["v"], atol_rel=1e-4)


def _family_batch(cfg, b, s, seed):
    """CPU inputs of s positions for a smoke config: frames (audio), vision
    embeddings ahead of s - vision_tokens tokens with Qwen2-VL's positions
    (vlm), else tokens."""
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "audio":
        return {"frames": torch.randn(b, s, cfg.frontend_dim, generator=g)}
    if cfg.family != "vlm":
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    sv = cfg.vision_tokens
    side = int(round(sv ** 0.5))
    grid = torch.stack([torch.zeros(sv, dtype=torch.int64), torch.arange(sv) // side,
                        torch.arange(sv) % side])
    text = (side + torch.arange(s - sv)).expand(3, s - sv)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s - sv), generator=g),
            "vision_embeds": torch.randn(b, sv, cfg.d_model, generator=g),
            "positions": torch.cat([grid, text], 1).expand(b, 3, s).contiguous()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hubert_xlarge", "qwen2_vl_72b", "zamba2_2_7b",
                                  "arctic_480b", "llama4_scout_17b_a16e"])
def test_cuda_lm_family_prefill_matches_cpu(cuda, arch):
    """The audio, vlm, hybrid and moe smoke models' prefill on the card (the flash
    kernel: one launch per attention layer, the hybrid's shared block once
    a group) against the CPU (plain versions), same weights, f32: logits
    and every cache to rtol 1e-4 / atol 1e-4 of max. hubert's step is its
    encoder step (every frame's logits, no cache), at a ragged 100 frames."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True)
    cpu_params = lm.init_params(cfg, 0, device="cpu")
    dev_params = lm_to(cpu_params, cuda)
    batch = _family_batch(cfg, 2, 100 if cfg.family == "audio" else 128, seed=1)
    attn_layers = cfg.num_layers // cfg.hybrid_block if cfg.family == "hybrid" else cfg.num_layers
    before = kernels.launches()["flash_attention"]
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    got, cache = steps.make_prefill_step(cfg)(dev_params, on_card)
    torch.cuda.synchronize()
    assert kernels.launches()["flash_attention"] == before + attn_layers
    want, want_cache = steps.make_prefill_step(cfg)(cpu_params, batch)
    _close(got.cpu(), want, atol_rel=1e-4)
    assert (cache is None) == (want_cache is None) == (cfg.family == "audio")
    for name in want_cache or {}:
        _close(cache[name].cpu(), want_cache[name], atol_rel=1e-4)


# (E, k, d, f): arctic-480b's and llama4-scout's routings at a cut width
MOE_ROUTINGS = [(128, 2, 1024, 512), (16, 1, 1024, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("e,k,d,f", MOE_ROUTINGS)
def test_cuda_moe_block_matches_cpu(cuda, e, k, d, f):
    """``moe_block`` on the card against the CPU, f32, on 8,192 tokens (router
    column 0 times 3: the capacity drops some of expert 0's). The routing
    index for index (a token whose picks differ would need a k-th/(k+1)-th
    gap under 1e-6); each expert's selection slot for slot, where a slot
    may hold another token only if the two tokens' CPU gates are within
    1e-6 (near-equal gates, which the two softmaxes may order either way);
    the output within 1e-5 of max|CPU| on the tokens kept alike, the aux
    loss within rtol 1e-6; the same bits on repeat; and no host
    synchronisation (CUDA sync debug mode raises on one)."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(e + k)
    skew = torch.ones(e)
    skew[0] = 3.0  # expert 0 takes more tokens than its capacity
    p = {"router": torch.randn(d, e, generator=g) * d**-0.5 * skew,
         "wg": torch.randn(e, d, f, generator=g) * d**-0.5,
         "wu": torch.randn(e, d, f, generator=g) * d**-0.5,
         "wd": torch.randn(e, f, d, generator=g) * f**-0.5}
    x = torch.randn(4, 2048, d, generator=g)
    cfg = types.SimpleNamespace(experts_per_token=k, num_experts=e, moe_capacity_factor=1.25)
    dp = {name: t.to(cuda) for name, t in p.items()}
    xd = x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.moe_block(dp, xd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_aux = moe.moe_block(p, x, cfg)
    n, cap = 8192, moe._capacity(8192, k, e, 1.25)
    probs, gate, eidx = moe.route(x.reshape(n, d), p["router"], k)
    sel_gate, sel = moe.select(gate, eidx, e, 0, cap)
    _, dgate, deidx = moe.route(xd.reshape(n, d), dp["router"], k)
    dsel_gate, dsel = (t.cpu() for t in moe.select(dgate, deidx, e, 0, cap))
    top = torch.sort(probs, dim=-1, descending=True).values
    gap = top[:, k - 1] - top[:, k]
    flipped = (deidx.cpu() != eidx).any(dim=1).nonzero().flatten().tolist()
    assert all(float(gap[t]) < 1e-6 for t in flipped), (flipped, gap[flipped])
    assert not flipped, f"near-tie flips at tokens {flipped}"
    assert bool((torch.bincount(eidx.flatten(), minlength=e) > cap).any())  # tokens dropped
    score = torch.where(eidx[None] == torch.arange(e)[:, None, None], gate[None], -1.0).amax(-1)
    moved = dsel != sel
    apart = (score.gather(1, dsel) - sel_gate).abs()
    assert not bool((moved & (apart >= 1e-6)).any()), apart[moved].max()
    kept = torch.zeros(e, n, dtype=torch.bool).scatter_(1, sel, sel_gate > -0.5)
    dkept = torch.zeros(e, n, dtype=torch.bool).scatter_(1, dsel, dsel_gate > -0.5)
    rows = ~(kept != dkept).any(dim=0).view(4, 2048)
    _close(out.cpu()[rows], want[rows], rtol=0, atol_rel=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    again, again_aux = moe.moe_block(dp, xd, cfg)
    assert torch.equal(again, out) and torch.equal(again_aux, aux)


def lm_to(tree, device):
    """A parameter tree moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: lm_to(v, device) for k, v in tree.items()}
    return [lm_to(v, device) for v in tree]


# logw = -exp(w), w ~ N(mean, sd): the model's law (the clamps bind past
# about 180 tokens), logw near -1 (cw reaches about -256: almost every pair
# saturates) and near -1e-3 (no clamp binds).
DECAYS = {"model": (-1.0, 0.6), "saturating": (0.0, 0.05), "slow": (np.log(1e-3), 0.05)}


def _wkv_inputs(b, h, q, dk, dv, dtype, wdtype, device, seed=0, decay="model"):
    """logw from the decay law ``decay``, nonzero u and S_in."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    mean, sd = DECAYS[decay]
    r, k = (randn(b, h, q, dk) * 0.5).to(dtype), (randn(b, h, q, dk) * 0.5).to(dtype)
    v = randn(b, h, q, dv).to(dtype)
    logw = (-torch.exp(randn(b, h, q, dk) * sd + mean)).to(wdtype)
    return r, k, v, logw, randn(h, dk) * 0.5, randn(b, h, dk, dv) * 0.3


def _row_rel(got, want):
    return float(((got.double() - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30))
                 .max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,q,dk,dv,decay", [
    (2, 4, 256, 64, 64, "model"), (1, 3, 50, 64, 64, "model"), (3, 1, 7, 64, 64, "model"),
    (3, 1, 1, 64, 64, "model"), (1, 2, 100, 16, 32, "model"), (2, 2, 32, 64, 64, "model"),
    (1, 1, 320, 64, 64, "model"), (2, 2, 129, 48, 64, "model"), (1, 2, 192, 64, 64, "model"),
    (2, 1, 255, 64, 64, "model"), (2, 4, 256, 64, 64, "saturating"),
    (2, 4, 256, 64, 64, "slow"),
])
@pytest.mark.parametrize("dtype,wdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
])
def test_cuda_wkv6_chunk_matches_plain(cuda, b, h, q, dk, dv, decay, dtype, wdtype):
    """Kernel against the plain chunk form in f64 on the same inputs: each
    (head, row) of y to its own max, S_out to its max, 2e-4; identical bits
    on repeat; one launch a call. q = 192 and 255 end on a full and a ragged
    tile; the two decay extremes saturate almost every pair, or none."""
    from repro_torch.kernels import wkv6_chunk as wkv

    args = _wkv_inputs(b, h, q, dk, dv, dtype, wdtype, cuda, decay=decay)
    before = kernels.launches()["wkv6_chunk"]
    y, s = wkv.wkv6_chunk(*args)
    torch.cuda.synchronize()
    assert kernels.launches()["wkv6_chunk"] == before + 1
    assert y.shape == (b, h, q, dv) and s.shape == (b, h, dk, dv)
    y64, s64 = wkv.ref.wkv6_chunk_factored(*args, dtype=torch.float64)
    assert _row_rel(y, y64) <= 2e-4
    assert float((s.double() - s64).abs().max() / s64.abs().max()) <= 2e-4
    y2, s2 = wkv.wkv6_chunk(*args)
    assert torch.equal(y2, y) and torch.equal(s2, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wkv6_chunk_matches_the_exact_recurrence_at_32(cuda, dtype):
    """At q = 32 the clamps cannot bind: the kernel is the exact recurrence
    (the JAX package's test tolerance, rtol = atol = 2e-4)."""
    from repro_torch.kernels import wkv6_chunk as wkv

    args = _wkv_inputs(4, 8, 32, 64, 64, dtype, torch.float32, cuda, seed=1)
    y, s = wkv.wkv6_chunk(*args)
    ye, se = wkv.ref.wkv6_chunk(*args)
    np.testing.assert_allclose(y.cpu().numpy(), ye.cpu().numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.cpu().numpy(), se.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cuda_wkv6_chunk_reads_the_models_layout(cuda):
    """(B, S, H, 64) views at a chunk offset, y written into a (B, S, H, 64)
    buffer: the bits of contiguous copies."""
    from repro_torch.kernels import wkv6_chunk as wkv

    b, s, h, q, c = 2, 768, 4, 256, 256
    x = {n: torch.randn(b, s, h, 64, device=cuda).to(torch.bfloat16) for n in "rkv"}
    logw = -torch.exp(torch.randn(b, s, h, 64, device=cuda) * 0.6 - 1.0)
    u, s0 = torch.randn(h, 64, device=cuda), torch.randn(b, h, 64, 64, device=cuda)
    views = [x["r"], x["k"], x["v"], logw]
    views = [t[:, c:c + q].transpose(1, 2) for t in views]
    out = torch.full((b, s, h, 64), float("nan"), device=cuda)
    y, st = wkv.wkv6_chunk(*views, u, s0, out=out[:, c:c + q].transpose(1, 2))
    y2, st2 = wkv.wkv6_chunk(*(t.contiguous() for t in views), u, s0)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert torch.isnan(out[:, :c]).all() and torch.isnan(out[:, c + q:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,seq", [(32, 64), (256, 512)])
def test_cuda_rwkv6_prefill_matches_cpu(cuda, chunk, seq):
    """The ssm smoke model (u_bonus nonzero) prefilled on the card (one
    wkv6_chunk launch per layer and chunk) against the CPU's plain chunk
    form, same weights, f32: logits and caches to rtol 1e-4 / atol 1e-4 of
    max; at chunk 256 over 512 tokens the clamps bind."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("rwkv6_7b", smoke=True), ssm_chunk=chunk)
    cpu_params = lm.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for lp in cpu_params["layers"]:
        lp["tm_cm"]["u_bonus"].normal_(0.0, 0.5, generator=gen)
    dev_params = lm_to(cpu_params, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=torch.Generator().manual_seed(1))
    before = kernels.launches()["wkv6_chunk"]
    last, cache = steps.make_prefill_step(cfg)(dev_params, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert kernels.launches()["wkv6_chunk"] == before + cfg.num_layers * seq // chunk
    want_last, want_cache = steps.make_prefill_step(cfg)(cpu_params, {"tokens": toks})
    _close(last.cpu(), want_last, atol_rel=1e-4)
    for name in ("s", "x_tm", "x_cm"):
        _close(cache[name].cpu(), want_cache[name], atol_rel=1e-4)


# ---------------------------------------------------------------------------
# Fixed-order sums on the fit paths: the same bits on every run
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dup", [False, True])
def test_cuda_mc_local_grad_is_fixed_order(cuda, dup):
    """MC's dense gradient (the baselines' input) sums each position's
    entries in entry order: twice on the card, the same bits; without
    duplicate positions, the accumulating scatter's bits (each address
    written once), with them the CPU's (the same order)."""
    from repro_torch.core import tasks

    d, m, p = 4_800, 1_777, 200_000
    gen = torch.Generator().manual_seed(3)
    lin = torch.randperm(d * m, generator=gen)[:p]
    if dup:  # every 7th entry repeats an earlier position
        lin[7::7] = lin[: len(lin[7::7])]
    rows, cols = (lin // m).to(torch.int32), (lin % m).to(torch.int32)
    vals = torch.randn(p, generator=gen)
    task = tasks.MatrixCompletion(d, m)
    idx, yw = tasks.pack_observations(rows, cols, vals)
    state = task.init_state(idx.to(cuda), yw.to(cuda))
    g1, g2 = task.local_grad(state), task.local_grad(state)
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)
    if dup:
        want = task.local_grad(task.init_state(idx, yw))
    else:
        want = torch.zeros(d, m, device=cuda).index_put_(
            (state.rows.long(), state.cols.long()), state.resid, accumulate=True)
    assert torch.equal(g1.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dim,k,workers", [(480_189, 16, 4), (17_770, 16, 8), (40, 16, 4)])
def test_cuda_topk_reassembly_is_fixed_order(cuda, dim, k, workers):
    """The gathered (N, k) top-k values added rank by rank: twice on the
    card the same bits, and the CPU's (the ranks' order), with positions
    shared across ranks."""
    from repro_torch.comm import topk

    gen = torch.Generator().manual_seed(dim + k)
    pool = torch.randperm(dim, generator=gen)[: max(k + 1, 2 * k)]
    gi = torch.stack([pool[torch.randperm(len(pool), generator=gen)[:k]]
                      for _ in range(workers)]).to(torch.int32)
    gv = torch.randn(workers, k, generator=gen) * 1e3
    a = topk.reassemble(gi.to(cuda), gv.to(cuda), dim)
    b = topk.reassemble(gi.to(cuda), gv.to(cuda), dim)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), topk.reassemble(gi, gv, dim))


@pytest.mark.gpu
def test_cuda_topk_exchange_keeps_the_tie_rule(cuda):
    """On the card, the top-k of tied magnitudes takes the lower index first
    (the stable sort), as on the CPU, and the residuals match bit for bit."""
    from repro_torch.comm import TopKReducer

    x = torch.from_numpy(np.random.default_rng(0).integers(-3, 4, 480_189).astype(np.float32))
    r = TopKReducer(k=16)
    got, st = r.exchange(x.to(cuda), r.init_state(480_189, 3, device=cuda), slot="u")
    want, st_cpu = r.exchange(x, r.init_state(480_189, 3), slot="u")
    assert torch.equal(got.cpu(), want) and torch.equal(st["u"].cpu(), st_cpu["u"])


class _Ring:
    """A stand-in worker group: ``shift`` hands back fixed neighbour vectors."""

    def __init__(self, received):
        self.received, self.size, self.rank = received, 4, 0

    def shift(self, x, offsets):
        return [r.to(x.device) for r in self.received[: len(offsets)]]


@pytest.mark.gpu
def test_cuda_gossip_mixing_is_fixed_order(cuda):
    """A gossip round's sum (x plus the neighbours in offset order, times
    f32(1 / (k + 1)), then N times): twice on the card the same bits, and
    the CPU's."""
    from repro_torch.comm import GossipTopology

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(480_189, generator=gen)
    received = [torch.randn(480_189, generator=gen) for _ in range(4)]
    topo = GossipTopology(num_workers=8, degree=4, rounds=3, group=_Ring(received))
    a, _ = topo.exchange(x.to(cuda), (), slot="u")
    b, _ = topo.exchange(x.to(cuda), (), slot="u")
    want, _ = topo.exchange(x, (), slot="u")
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a.cpu(), want)


# ---------------------------------------------------------------------------
# The block:k solver's kernel forms (tolerances as above: the block products
# sum in another order than cuBLAS, the COO block form than index_add_'s
# atomics; the rank-k update's k-term dot is one fmaf chain against the plain
# version's cuBLAS product, so 1e-4 too; the block update_resid is spelled in
# its plain version's order and must match it bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(300, 40), (65, 33), (37, 5), (1, 7), (5000, 1000),
                                 (4099, 2048), (20000, 12), (9, 1001), (100, 1000),
                                 (8193, 1000), (8193, 1001), (20000, 2048), (100, 33)])
@pytest.mark.parametrize("k", [1, 3, 7, 8, 9, 16, 17, 31, 32, 33, 64])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_matmat_rmatmat_match_plain(cuda, n, m, k, aligned):
    """One launch a call of each; repeated calls give the same bits. The
    edges of the ring design: n below one 256-row tile (100), one row past
    a slab (8193 with m <= 1024 is 32 slabs of 256 rows and one of 1 on a
    132-SM card), more (slab, tile) items than one round of the persistent
    grid (20000 x 2048: 264), m not a multiple of the 32-wide stage (1000,
    1001, 33), k across the 8-, 16- and 32-column groups and past them
    (64: two passes), the misaligned (cp.async) route."""
    a = torch.randn(n, m, device=cuda) if aligned else _misaligned((n, m), cuda)
    v, u = torch.randn(m, k, device=cuda), torch.randn(n, k, device=cuda)
    before = kernels.launches()
    got = pm.matmat(a, v)
    out = pm.rmatmat(a, u)
    torch.cuda.synchronize()
    _close(got.cpu(), pm.ref.matmat(a, v).cpu())
    _close(out.cpu(), pm.ref.rmatmat(a, u).cpu())
    assert kernels.launches()["matmat"] == before["matmat"] + 1
    assert kernels.launches()["rmatmat"] == before["rmatmat"] + 1
    assert torch.equal(pm.matmat(a, v), got)
    assert torch.equal(pm.rmatmat(a, u), out)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(300, 40), (37, 5), (5000, 1000), (333, 37), (129, 130)])
@pytest.mark.parametrize("k", [1, 3, 17, 32, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_rankk_update_matches_plain(cuda, n, m, k, aligned):
    """Both forms, out of place and in place; the same bits on repeat."""
    z = torch.randn(n, m, device=cuda) if aligned else _misaligned((n, m), cuda)
    y0 = torch.randn(n, m, device=cuda)
    p, q = torch.randn(n, k, device=cuda), torch.randn(m, k, device=cuda)
    g = torch.tensor(0.3, device=cuda)
    a, b, c = 1.0 - g, -g * 1.5, -g
    scal2, scal3 = torch.stack([a, b]), torch.stack([a, b, c])
    before = kernels.launches()
    got = r1.rankk_update(z, p, q, a, b)
    got_axpy = r1.rankk_update_axpy(z, y0, p, q, a, b, c)
    torch.cuda.synchronize()
    _close(got.cpu(), r1.ref.rankk_update(z, p, q, scal2).cpu())
    _close(got_axpy.cpu(), r1.ref.rankk_update_axpy(z, y0, p, q, scal3).cpu())
    assert kernels.launches()["rankk_update"] == before["rankk_update"] + 1
    assert kernels.launches()["rankk_update_axpy"] == before["rankk_update_axpy"] + 1
    assert torch.equal(r1.rankk_update(z, p, q, a, b), got)
    zz = z.clone()
    assert r1.rankk_update_axpy(zz, y0, p, q, a, b, c, out=zz) is zz
    assert torch.equal(zz, got_axpy)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1000, 1001, 130])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 64, 100, 130])
@pytest.mark.parametrize("route", ["aligned", "z off", "p off", "q off"])
def test_cuda_rankk_update_long_and_ragged(cuda, m, k, route):
    """Both forms at n = 200,003: hundreds of blocks down each strip of 128
    columns, the last block's rows ragged; the last strip ragged at m = 1001
    and 130; k with P through the ring (up to 64), Q's strip in shared memory
    (up to 128; 100 needs more than 48 KB) and both read from global memory
    (130); Z 4 bytes off (4-byte Z, Y0 and out), P 4 bytes off (4-byte P) or
    Q 4 bytes off (Q staged 4 bytes at a time). Held on the card to the plain
    version (rtol 1e-4, atol 1e-5 of max|plain|); each call repeats its bits,
    and in place (out is z) gives the out-of-place bits."""
    n = 200_003
    z = _misaligned((n, m), cuda) if route == "z off" else torch.randn(n, m, device=cuda)
    y0 = torch.randn(n, m, device=cuda)
    p = _misaligned((n, k), cuda) if route == "p off" else torch.randn(n, k, device=cuda)
    q = _misaligned((m, k), cuda) if route == "q off" else torch.randn(m, k, device=cuda)
    g = torch.tensor(0.3, device=cuda)
    scal = torch.stack([1.0 - g, -g * 1.5, -g])
    for form, extra in (("rankk_update", ()), ("rankk_update_axpy", (y0,))):
        fn, s = getattr(r1, form), scal[:2 + len(extra)]
        before = kernels.launches()[form]
        got = fn(z, *extra, p, q, *s.unbind())
        torch.cuda.synchronize()
        assert kernels.launches()[form] == before + 1
        want = getattr(r1.ref, form)(z, *extra, p, q, s)
        tol = 1e-4 * want.abs() + 1e-5 * want.abs().max()
        assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())
        del want, tol
        assert torch.equal(fn(z, *extra, p, q, *s.unbind()), got)
        zz = _misaligned((n, m), cuda) if route == "z off" else torch.empty_like(z)
        zz.copy_(z)
        assert fn(zz, *extra, p, q, *s.unbind(), out=zz) is zz
        assert torch.equal(zz, got)


# (d, m, p, heavy, long_row) of the block forms' COO sets: a segment longer
# than a piece (PIECE = 1024) beside many one-entry segments in the last
_BLOCK_COO = [(40, 30, 600, 0, 0), (1000, 300, 50000, 5000, 0), (20000, 17, 300001, 0, 0),
              (3, 5000, 7, 0, 0), (3000, 500, 4000, 0, 2500)]


def _block_x(rows, k, aligned, device):
    """A (rows, k) factor or X: 16-byte aligned, or 4 bytes off."""
    return torch.randn(rows, k, device=device) if aligned else _misaligned((rows, k), device)


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy,long_row", _BLOCK_COO)
@pytest.mark.parametrize("k", [1, 3, 8, 17, 32, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_coo_matmat_matches_plain(cuda, d, m, p, heavy, long_row, k, aligned):
    """G V and G^T U on the sorted copies; the same bits on repeat."""
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy, long_row=long_row)
    v, u = _block_x(m, k, aligned, cuda), _block_x(d, k, aligned, cuda)
    by_row, by_col = mc.build_order(rows, cols, d, m), mc.build_order(cols, rows, m, d)
    vr, vc = mc.gather_sorted(by_row, vals), mc.gather_sorted(by_col, vals)
    before = kernels.launches()["coo_matmat"]
    gv, gu = mc.coo_matmat(by_row, vr, v), mc.coo_matmat(by_col, vc, u)
    torch.cuda.synchronize()
    assert kernels.launches()["coo_matmat"] == before + 2
    _close(gv.cpu(), mc.ref.coo_matvec(rows, cols, vals, v, d).cpu())
    _close(gu.cpu(), mc.ref.coo_matvec(cols, rows, vals, u, m).cpu())
    assert torch.equal(mc.coo_matmat(by_row, vr, v), gv)
    assert torch.equal(mc.coo_matmat(by_col, vc, u), gu)


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy,long_row", _BLOCK_COO + [(600_000, 2000, 2_000_000, 0, 0)])
@pytest.mark.parametrize("k", [1, 3, 8, 17, 32, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_coo_matmat_is_the_chain_bit_for_bit(cuda, d, m, p, heavy, long_row, k, aligned):
    """Both orders equal ``ref.coo_matmat_chain`` (each piece's rounded
    products added in sorted order, then the pieces in order) bit for bit,
    on this call and the next. The last set has enough pieces (over half a
    million rows) that each warp's groups walk several pieces in turn."""
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, seed=1, heavy=heavy, long_row=long_row)
    for order, x in ((mc.build_order(rows, cols, d, m), _block_x(m, k, aligned, cuda)),
                     (mc.build_order(cols, rows, m, d), _block_x(d, k, aligned, cuda))):
        vs = mc.gather_sorted(order, vals)
        want = mc.ref.coo_matmat_chain(order, vs, x)
        assert torch.equal(mc.coo_matmat(order, vs, x), want)
        assert torch.equal(mc.coo_matmat(order, vs, x), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy,long_row", _BLOCK_COO)
@pytest.mark.parametrize("k", [2, 3, 8, 17, 32, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_update_resid_block_is_the_chain_bit_for_bit(cuda, d, m, p, heavy, long_row, k,
                                                          aligned):
    """With (d, k) and (m, k) factors: the three outputs equal the plain
    chain (the k-term dot in ascending j, then the step) and its gathers,
    bit for bit, on this call and the next; one launch, on the block route."""
    from repro_torch.core import tasks
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy, long_row=long_row)
    weight = (torch.arange(rows.numel(), device=cuda) % 3 != 0).float()
    resid = weight * torch.randn(rows.numel(), device=cuda)
    state = tasks.mc_state(rows, cols, vals, resid, weight, d, m)
    u, v = _block_x(d, k, aligned, cuda), _block_x(m, k, aligned, cuda)
    gamma = 2.0 / (torch.full((), 5.0, device=cuda) + 2.0)
    want = mc.ref.resid_step_dot(gamma, 1.75, resid, vals, weight,
                                 mc.ref.entry_dot(u, v, rows, cols))
    before = dict(mc.update_resid.route_launches)
    # the update runs in place: a second run starts from copies of the input
    fresh = state._replace(**{f: getattr(state, f).clone()
                              for f in ("resid", "resid_by_row", "resid_by_col")})
    got = tasks.MatrixCompletion(d, m).update(state, u, v, gamma, 1.75)
    torch.cuda.synchronize()
    assert mc.update_resid.route_launches["block"] == before["block"] + 1
    assert torch.equal(got.resid, want)
    assert torch.equal(got.resid_by_row, mc.gather_sorted(state.by_row, want))
    assert torch.equal(got.resid_by_col, mc.gather_sorted(state.by_col, want))
    again = tasks.MatrixCompletion(d, m).update(fresh, u, v, gamma, 1.75)
    for f in ("resid", "resid_by_row", "resid_by_col"):
        assert torch.equal(getattr(again, f), getattr(got, f))


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy,long_row", _BLOCK_COO)
@pytest.mark.parametrize("k", [1, 3, 8, 17, 32, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_update_resid_caller_is_the_block_launch_s_caller_order(cuda, d, m, p, heavy,
                                                                      long_row, k, aligned):
    """The caller order alone (the block line search's values at gamma = 1):
    the plain chain's bits and the three-order launch's caller-order bits;
    one launch of its own, none on update_resid."""
    from repro_torch.core import tasks
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy, long_row=long_row)
    weight = (torch.arange(rows.numel(), device=cuda) % 3 != 0).float()
    resid = weight * torch.randn(rows.numel(), device=cuda)
    state = tasks.mc_state(rows, cols, vals, resid, weight, d, m)
    u, v = _block_x(d, k, aligned, cuda), _block_x(m, k, aligned, cuda)
    gamma = torch.ones((), device=cuda)
    args = (gamma, 1.75, u, v, rows, cols, resid, vals, weight)
    before = kernels.launches()
    got = mc.update_resid_caller(*args)
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["update_resid_caller"] == before["update_resid_caller"] + 1
    assert after["update_resid"] == before["update_resid"]
    assert torch.equal(got, mc.ref.update_resid_caller(*args))
    if k > 1:  # a (d, 1) factor is a vector to update_resid
        assert torch.equal(got, mc.update_resid(*args, state.by_row, state.copies("row"),
                                                state.by_col, state.copies("col"))[0])
    assert torch.equal(mc.update_resid_caller(*args), got)



@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 8, 32])
def test_cuda_update_resid_in_place_is_out_of_place_bits(cuda, k):
    """update_resid writing each order's result over that order's residual
    (as MatrixCompletion.update calls it) gives the fresh outputs' bits."""
    from repro_torch.core import tasks
    from repro_torch.kernels import mc_matvec as mc

    d, m = 3000, 700
    rows, cols, vals = _coo(d, m, 200_000, cuda, heavy=5000)
    weight = (torch.arange(rows.numel(), device=cuda) % 3 != 0).float()
    state = tasks.mc_state(rows, cols, vals, weight * torch.randn(rows.numel(), device=cuda),
                           weight, d, m)
    u = torch.randn(d, device=cuda) if k is None else _block_x(d, k, True, cuda)
    v = torch.randn(m, device=cuda) if k is None else _block_x(m, k, True, cuda)
    gamma = torch.full((), 0.3, device=cuda)
    args = (gamma, 1.25, u, v, state.rows, state.cols, state.resid, state.vals, state.weight,
            state.by_row, state.copies("row"), state.by_col, state.copies("col"))
    want = mc.update_resid(*args)
    got = mc.update_resid(*args, out=(state.resid, state.resid_by_row, state.resid_by_col))
    assert got[0] is state.resid and got[1] is state.resid_by_row
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The engine on the card: one CUDA graph per (K, length) segment program
# ---------------------------------------------------------------------------


def _engine_problem(kind, device):
    """Small MTLS / logistic / MC data from a seed (numpy), as torch tensors."""
    from repro_torch.core import tasks

    rng = np.random.default_rng(11)
    if kind == "mc":
        d, m, p = 60, 50, 800
        u, v = rng.standard_normal((d, 3)), rng.standard_normal((m, 3))
        rows, cols = rng.integers(0, d, p), rng.integers(0, m, p)
        vals = ((u @ v.T)[rows, cols] / 3).astype(np.float32)
        idx, yw = tasks.pack_observations(rows, cols, vals)
        return tasks.MatrixCompletion(d, m), idx.to(device), yw.to(device), 2.0
    n, d, m = 512, 48, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, m))
    w /= np.linalg.svd(w, compute_uv=False).sum()
    if kind == "logistic":
        y = np.argmax(x @ rng.standard_normal((d, m)), axis=1).astype(np.int64)
        return (tasks.MultinomialLogistic(d, m), torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device), 10.0)
    return (tasks.MultiTaskLeastSquares(d, m), torch.from_numpy(x).to(device),
            torch.from_numpy((x @ w).astype(np.float32)).to(device), 1.0)


_ENGINE_CASES = {
    "mtls-log-linesearch": ("mtls", dict(num_epochs=12, schedule="log", step_size="linesearch")),
    "logistic-int8": ("logistic", dict(num_epochs=8, schedule="log", comm="int8")),
    "mc-dense": ("mc", dict(num_epochs=10, schedule="log", step_size="linesearch")),
    "mc-int8": ("mc", dict(num_epochs=8, schedule="log", comm="int8", step_size="linesearch")),
    "mtls-topk": ("mtls", dict(num_epochs=10, schedule="const:2", comm="topk:6")),
    "mtls-block4-adapt-gap_tol": ("mtls", dict(num_epochs=24, schedule="const:4",
                                               solver="block:4:adapt", step_size="linesearch",
                                               gap_tol="mid")),
    "mc-block4-adapt": ("mc", dict(num_epochs=10, schedule="const:3", solver="block:4:adapt",
                                   step_size="linesearch")),
}


def _engine_fit(kind, kw, device):
    """fit_serial on ``device`` under fresh launch counts: (result, the
    launches the device ran and their routes (``kernels.Executed``; None
    off the card), the wrappers' calls)."""
    import contextlib

    from repro_torch.launch import dfw

    task, x, y, mu = _engine_problem(kind, device)
    kernels.reset_launches()
    with kernels.Executed() if device.type == "cuda" else contextlib.nullcontext() as ran:
        res = dfw.fit_serial(task, x, y, cfg=dfw.DFWConfig(mu=mu, verify_kernels=False, **kw),
                             key=5, device=device)
    if ran is None:
        return res, None, kernels.launches()
    return res, (ran.launches, ran.routes), kernels.launches()


def _same_bits(a, b):
    assert a.epochs_run == b.epochs_run
    assert a.history == b.history  # NaN-free: cut to the epochs run
    assert a.final_loss == b.final_loss
    for p, q in zip(a.iterate, b.iterate):
        assert torch.equal(p, q)
    for p, q in zip(a.state, b.state):
        if isinstance(p, torch.Tensor):
            assert torch.equal(p, q)
    if isinstance(a.probe, torch.Tensor):
        assert torch.equal(a.probe, b.probe)


def _with_gap_tol(kind, kw, device):
    """``gap_tol="mid"``: the gap an unstopped run reaches at 60% of its
    epochs, so that the certificate fires inside the one segment."""
    if kw.get("gap_tol") != "mid":
        return kw
    full, _, _ = _engine_fit(kind, {**kw, "gap_tol": None}, device)
    return {**kw, "gap_tol": full.history["gap"][int(0.6 * kw["num_epochs"])]}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_ENGINE_CASES))
def test_cuda_captured_run_equals_uncaptured_and_legacy(cuda, case, monkeypatch):
    """A captured scan run gives the bits, history, launches on the device
    and stats of the same programs run uncaptured on the card, and legacy's
    bits; uncaptured, the device ran the wrappers' calls; gap_tol fires
    mid-segment where asked."""
    from repro_torch.core import engine

    kind, kw = _ENGINE_CASES[case]
    kw = _with_gap_tol(kind, kw, cuda)
    graph, gran, _ = _engine_fit(kind, kw, cuda)
    # a replay a piece of at most MAX_PROGRAM_EPOCHS (24 epochs: two pieces)
    assert graph.stats["graph_replays"] >= graph.stats["segments_run"] > 0
    monkeypatch.setattr(engine, "_capturable", lambda *a: False)
    plain, pran, pcalls = _engine_fit(kind, kw, cuda)
    assert plain.stats["graph_replays"] == 0
    legacy, lran, lcalls = _engine_fit(kind, {**kw, "engine": "legacy"}, cuda)
    for other in (plain, legacy):
        _same_bits(graph, other)
    assert gran == pran == lran
    assert pran[0] == pcalls and lran[0] == lcalls
    assert {**graph.stats, "graph_replays": 0} == plain.stats
    if kw.get("gap_tol") is not None:
        assert graph.epochs_run < kw["num_epochs"]
        assert graph.stats["segments_run"] == 1  # stopped inside the segment


@pytest.mark.gpu
def test_cuda_captured_run_passes_the_transfer_guard(cuda):
    """A const:2 MC run, state built first, meets dispatch_contract() under
    its guard: no device read outside the engine's counted fetches."""
    from repro_torch.core import engine, frank_wolfe
    from repro_torch.launch import dfw

    task, idx, yw, mu = _engine_problem("mc", cuda)
    ktask = dfw.kernelize(task)
    state = ktask.init_state(idx, yw)
    contract = engine.dispatch_contract()
    with contract.guard():
        res = frank_wolfe.fit(ktask, state, mu=mu, num_epochs=12, schedule="const:2",
                              step_size="linesearch", key=5, device=cuda)
    contract.check_stats(res.stats)
    assert res.stats["graph_replays"] == 1 and res.epochs_run == 12


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mtls-log-linesearch", "mc-int8", "mtls-topk"])
def test_cuda_captured_stats_equal_the_cpu_run(cuda, case):
    """The engine's stats count the reference's logical points, on every
    device: the card's captured run and the CPU's differ in graph_replays
    alone."""
    kind, kw = _ENGINE_CASES[case]
    card, _, _ = _engine_fit(kind, kw, cuda)
    cpu, _, _ = _engine_fit(kind, kw, torch.device("cpu"))
    assert cpu.stats["graph_replays"] == 0 < card.stats["graph_replays"]
    assert {**card.stats, "graph_replays": 0} == cpu.stats


# ---------------------------------------------------------------------------
# The ImageNet head's paths: right_multiply, power_method_dense, train_head
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,m,count", [(5000, 2048, 1000, 10), (777, 48, 33, 3),
                                         (70_000, 64, 40, 7)])
def test_cuda_right_multiply_runs_factor_matvec(cuda, n, d, m, count, monkeypatch):
    """X W through factor_matvec, one launch a chunk of rows, against the
    plain chain; the chunks give one call's bits; rows past count are
    no-ops."""
    from repro_torch.core import low_rank

    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    it = low_rank.init(count + 4, d, m, device=cuda)
    it.u[:count] = torch.randn((count, d), generator=gen, device=cuda)
    it.v[:count] = torch.randn((count, m), generator=gen, device=cuda)
    it.s[:count] = torch.randn((count,), generator=gen, device=cuda)
    it.alpha.fill_(0.3)
    it.count.fill_(count)
    x = torch.randn((n, d), generator=gen, device=cuda)
    before = kernels.launches()["factor_matvec"]
    got = low_rank.right_multiply(it, x)
    chunks = -(-n // low_rank.RIGHT_MULTIPLY_ROWS)
    assert kernels.launches()["factor_matvec"] == before + chunks
    want = ((x @ it.u[:count].T) * (it.s[:count] * it.alpha)) @ it.v[:count]
    _close(got.cpu(), want.cpu())
    monkeypatch.setattr(low_rank, "RIGHT_MULTIPLY_ROWS", 1000)
    assert torch.equal(low_rank.right_multiply(it, x), got)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(4099, 2048), (300, 40)])
def test_cuda_power_method_dense_runs_power_matvec(cuda, n, m):
    from repro_torch.core import power_method

    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    a = torch.randn((n, m), generator=gen, device=cuda)
    v0 = power_method.sphere_vector(gen, m, cuda)
    before = kernels.launches()
    got = power_method.power_method_dense(a, v0, 6)
    after = kernels.launches()
    assert after["matvec"] - before["matvec"] == 6 and after["rmatvec"] - before["rmatvec"] == 6
    want = power_method.power_method_dense(a.cpu(), v0.cpu(), 6)
    for g, w in zip(got, want):
        _close(g.cpu(), w)


@pytest.mark.gpu
def test_cuda_train_head_is_fit_serial_bit_for_bit(cuda):
    """train_head and sharded_fit (one process) on the card give
    fit_serial's bits, and the device ran the power_matvec and rank1_update
    kernels."""
    from repro_torch.core import dfw_head, tasks
    from repro_torch.launch import dfw

    _, x, y, _ = _engine_problem("logistic", cuda)
    kw = dict(mu=10.0, num_epochs=9, schedule="const:2")
    with kernels.Executed() as ran:
        head = dfw_head.train_head(x, y, 40, key=5, device=cuda, **kw)
    assert ran.launches["matvec"] > 0 and ran.launches["rmatvec"] > 0
    assert ran.launches["rank1_update"] == 9
    sharded = dfw_head.sharded_fit(None, x, y, 40, key=5, device=cuda, **kw)
    ref = dfw.fit_serial(tasks.MultinomialLogistic(48, 40), x, y, key=5, device=cuda,
                         cfg=dfw.DFWConfig(**kw))
    for res in (head, sharded):
        assert res.history == ref.history and res.final_loss == ref.final_loss
        for p, q in zip(res.iterate, ref.iterate):
            assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# LM training: the bf16 rank-1 form, forward-only kernels under autograd,
# the train and hybrid steps on the card
# ---------------------------------------------------------------------------


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place (ordered bits)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(4096, 2048), (300, 40), (65, 33), (37, 5), (1, 8), (9, 1001)])
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_rank1_update_bf16_matches_plain(cuda, n, m, in_place, aligned):
    """The bf16 form against its plain version (f32 arithmetic in its order,
    rounded once): within one bf16 ulp, expected bit for bit; identical bits
    on repeat; one launch a call on the "bf16" route. m % 8 == 0 with Z
    16-byte aligned takes the 16-byte path; m = 33, 5, 1001 and a Z 2 bytes
    off alignment take the one-element path."""
    z = torch.randn(n * m + 1, device=cuda).to(torch.bfloat16)
    z = (z[:-1] if aligned else z[1:]).view(n, m)
    x, y = torch.randn(n, device=cuda), torch.randn(m, device=cuda)
    a, b = torch.tensor(0.625, device=cuda), -3.5
    want = r1.ref.rank1_update(z, x, y, torch.stack([a, torch.tensor(b, device=cuda)]))
    before = kernels.route_launches()["rank1_update"]
    again = r1.rank1_update(z, x, y, a, b)
    got = r1.rank1_update(z, x, y, a, b, out=z if in_place else None)
    torch.cuda.synchronize()
    after = kernels.route_launches()["rank1_update"]
    assert after["bf16"] == before["bf16"] + 2 and after["f32"] == before["f32"]
    assert got.dtype == torch.bfloat16 and (got.data_ptr() == z.data_ptr()) == in_place
    assert _bf16_ulps(got, want) <= 1 and torch.equal(got, again)


def _grad_inputs(cuda):
    q, k, v = _attention_inputs(1, 4, 2, 64, 64, 64, torch.bfloat16, cuda, seed=1)
    return q.requires_grad_(), k, v


@pytest.mark.gpu
def test_cuda_forward_only_kernels_refuse_inputs_that_require_grad(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6_chunk as wkv

    q, k, v = _grad_inputs(cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v, scale=0.125, causal=True)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, scale=0.125, causal=True).shape == q.shape
    r, kk, vv, lw = (torch.randn(1, 2, 16, 64, device=cuda) for _ in range(4))
    u, s0 = torch.zeros(2, 64, device=cuda), torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv.wkv6_chunk(r, kk.requires_grad_(), vv, -lw.abs(), u, s0)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv.wkv6_chunk(r, kk.detach(), vv, -lw.abs(), u.requires_grad_(), s0)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,chunk", [(256, 2048), (256, 64)])
def test_cuda_attention_under_grad_takes_the_plain_path(cuda, sq, chunk):
    """layers.attention with q requiring grad: no flash launch, the dense
    (or chunked) path, whose output agrees with the kernel's under no_grad
    within bf16's 1e-2 of each row's max; its gradient reaches q, k and v."""
    from repro_torch.models import layers

    q, k, v = _attention_inputs(2, 4, 2, sq, sq, 64, torch.bfloat16, cuda, seed=2)
    k.requires_grad_()
    v.requires_grad_()
    q.requires_grad_()
    before = kernels.launches()["flash_attention"]
    out = layers.attention(q, k, v, scale=0.125, causal=True, chunk=chunk)
    assert kernels.launches()["flash_attention"] == before
    with torch.no_grad():
        flash = layers.attention(q, k, v, scale=0.125, causal=True, chunk=chunk)
    assert kernels.launches()["flash_attention"] == before + 1
    err = (out.float() - flash.float()).abs().amax(dim=-1)
    assert bool((err <= 1e-2 * flash.float().abs().amax(dim=-1) + 1e-6).all())
    out.float().square().sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))


def _smoke_train_inputs(arch, device):
    from repro_torch import configs
    from repro_torch.data import SyntheticLMStream, device_put_batch
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec

    cfg = configs.get_config(arch, smoke=True)
    params = lm.init_params(cfg, 3, device="cpu")
    stream = SyntheticLMStream(cfg, ShapeSpec("t", "train", 64, 4))
    return cfg, params, [stream.batch_for_step(t) for t in range(3)], device_put_batch


def _tree_to(tree, device):
    from repro_torch.optim.compression import tree_map

    return tree_map(lambda t: t.to(device, copy=True), tree)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "rwkv6_7b", "arctic_480b",
                                  "llama4_scout_17b_a16e", "zamba2_2_7b", "qwen2_vl_72b",
                                  "hubert_xlarge"])
def test_cuda_train_step_matches_the_cpu(cuda, arch):
    """Three AdamW steps of the smoke config on the card against the CPU:
    loss rtol 1e-4, parameters 1e-3 of each leaf's max (f32 sums in other
    orders, amplified by AdamW's normalized step); no flash_attention or
    wkv6_chunk launch inside a train step; the same bits when repeated."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import tree_leaves

    cfg, p_cpu, batches, put = _smoke_train_inputs(arch, cuda)
    runs = {}
    for dev in ("cpu", cuda, cuda):
        params = _tree_to(p_cpu, dev)
        st = adamw.init(params)
        step = steps.make_train_step(cfg, peak_lr=1e-3, warmup=2)
        losses = []
        with kernels.Executed(cuda) as ran:
            for b in batches:
                params, st, m = step(params, st, put(b, dev))
                losses.append(float(m["loss"]))
        runs.setdefault(str(dev), []).append((losses, params))
        if dev != "cpu":
            assert ran.launches["flash_attention"] == 0 and ran.launches["wkv6_chunk"] == 0
    (cpu_losses, cpu_p), = runs["cpu"]
    (l1, p1), (l2, p2) = runs[str(cuda)]
    np.testing.assert_allclose(l1, cpu_losses, rtol=1e-4)
    for g, w in zip(tree_leaves(p1), tree_leaves(cpu_p)):
        _close(g.cpu(), w, rtol=0, atol_rel=1e-3)
    assert l1 == l2 and all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


@pytest.mark.gpu
def test_cuda_hybrid_step_launches_its_kernels(cuda):
    """The hybrid step on codeqwen1.5-7b's smoke config in bf16: each step
    launches matvec and rmatvec power_iters times and the bf16 rank-1 update
    once. After the first step (gamma = 1) the f32 head -mu u v^T has trace
    norm mu, and rounding each entry to bf16 (a relative error of at most
    2^-8) adds E with ||E||_* <= sqrt(min(d, V)) ||E||_F <= sqrt(min(d, V))
    2^-8 mu: that is the bound held."""
    import dataclasses

    from repro_torch.optim import hybrid
    from repro_torch.optim.compression import tree_map

    cfg, p_cpu, batches, put = _smoke_train_inputs("codeqwen1_5_7b", cuda)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = tree_map(lambda t: t.to(cuda, torch.bfloat16), p_cpu)
    step = hybrid.make_hybrid_train_step(cfg, mu=5.0, power_iters=3)
    st = hybrid.init(params)
    for t, b in enumerate(batches):
        with kernels.Executed(cuda) as ran:
            params, st, m = step(params, st, put(b, cuda), 11)
        assert ran.launches["matvec"] == ran.launches["rmatvec"] == 3
        assert ran.routes["rank1_update"] == {"f32": 0, "bf16": 1}
        assert bool(torch.isfinite(m["loss"]))
        if t == 0:
            d, v = params["unembed"].shape
            tn = float(torch.linalg.svdvals(params["unembed"].float()).sum())
            assert tn <= 5.0 * (1 + min(d, v) ** 0.5 * 2 ** -8), tn


def _moe_inputs(arch, seed):
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_config(arch, smoke=True)
    p = lm.init_params(cfg, seed, device="cpu")["layers"][0]["moe"]
    p["router"][:, 0] *= 3.0  # expert 0 favoured, so that it drops tokens
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((4, 64, cfg.d_model))
                         .astype(np.float32))
    return cfg, p, x


def _moe_grads(cfg, p, x, device):
    from repro_torch.models import moe

    p = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
    x = x.to(device).requires_grad_(True)
    out, aux = moe.moe_block(p, x, cfg)
    grads = torch.autograd.grad((out * out).sum() + aux, [x, *p.values()])
    return [out.detach(), aux.detach(), *grads]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_scout_17b_a16e"])
def test_cuda_moe_backward_repeats_its_bits_and_matches_the_cpu(cuda, arch):
    """The moe layer's gradients (the dispatch and the combine by gathers,
    no float atomics) on the card: the same bits on repeat, and within
    1e-4 of each tensor's max of the CPU's (f32 sums in other orders), at
    256 tokens, router column 0 times 3, so that expert 0 overflows its
    capacity (80 slots a top-1 expert of 4, 80 a top-2 expert of 8)."""
    from repro_torch.models import moe

    cfg, p, x = _moe_inputs(arch, 5)
    _, gate, eidx = moe.route(x.reshape(-1, cfg.d_model), p["router"], cfg.experts_per_token)
    load = torch.bincount(eidx.reshape(-1), minlength=cfg.num_experts)
    assert int(load.max()) > moe._capacity(x.shape[0] * x.shape[1], cfg.experts_per_token,
                                           cfg.num_experts, cfg.moe_capacity_factor)
    want = _moe_grads(cfg, p, x, "cpu")
    got, again = _moe_grads(cfg, p, x, cuda), _moe_grads(cfg, p, x, cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, want):
        _close(g.cpu(), w, rtol=0, atol_rel=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("a_log", [None, 2.0, 6.0])
def test_cuda_mamba2_scan_gradient_matches_the_cpu(cuda, a_log):
    """The Mamba-2 chunk scan's gradients (every leaf and the input) on the
    card against the CPU at the smoke config's decays and at decays past
    -80 within a chunk: finite, within 1e-4 of each leaf's max (a_log's
    1e-3: its gradient takes each decay as a difference of two cumulative
    sums near -160), the same bits on repeat."""
    from repro_torch import configs
    from repro_torch.models import mamba2

    cfg = configs.get_config("zamba2_2_7b", smoke=True)
    gen = torch.Generator().manual_seed(4)
    p = mamba2.init_mamba(gen, cfg, torch.float32, "cpu")
    if a_log is not None:
        p["a_log"].fill_(a_log)
        p["dt_bias"].fill_(1.0)
    x = torch.randn(2, 128, cfg.d_model, generator=gen)

    def grads(device):
        pp = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        xx = x.to(device).requires_grad_(True)
        out = mamba2.mamba_block(pp, xx, cfg)
        return list(torch.autograd.grad((out * out).sum(), [xx, *pp.values()]))

    want, got, again = grads("cpu"), grads(cuda), grads(cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g, w in zip(["x", *p], got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g.cpu(), w, rtol=0, atol_rel=1e-3 if name == "a_log" else 1e-4)


@pytest.mark.gpu
def test_cuda_head_kernels_at_llama4_scouts_head(cuda):
    """matvec and rmatvec on llama4-scout's head gradient (5120 x 202,048
    f32, 4.14 GB) against their plain versions (rtol 1e-4, atol 1e-5 of
    max), and the bf16 rank-1 update in place on the bf16 head against its
    plain version (one bf16 ulp, as the bf16 form is held above): the
    hybrid step's operands there."""
    d, v = 5120, 202_048
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn(d, v, generator=gen, device=cuda)
    x, u = torch.randn(v, generator=gen, device=cuda), torch.randn(d, generator=gen, device=cuda)
    _close(pm.matvec(a, x).cpu(), pm.ref.matvec(a, x).cpu())
    _close(pm.rmatvec(a, u).cpu(), pm.ref.rmatvec(a, u).cpu())
    del a
    z = (torch.randn(d, v, generator=gen, device=cuda) * 0.02).bfloat16()
    want = r1.ref.rank1_update(z, u, x, torch.tensor([0.75, -1.5], device=cuda))
    with kernels.Executed(cuda) as ran:
        assert r1.rank1_update(z, u, x, 0.75, -1.5, out=z) is z
    assert ran.routes["rank1_update"] == {"f32": 0, "bf16": 1}
    assert _bf16_ulps(z, want) <= 1


def _sum_worker(group, device, x):
    return float(x.sum())


@pytest.mark.gpu
def test_cuda_run_workers_returns_the_shared_memory(cuda):
    """A CUDA tensor shared with gloo workers is freed once the caller drops
    it: each worker releases what it received before it exits, and
    run_workers collects the released blocks (before, they stayed pinned
    until the caller's exit)."""
    from repro_torch.launch import dfw

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    x = torch.ones(1 << 26, device=cuda)  # 256 MB
    assert dfw.run_workers(2, _sum_worker, x, device="cuda") == [float(1 << 26)] * 2
    del x
    assert torch.cuda.memory_allocated() == base


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(0, 6, 0, 1), (6, 12, 1, 2), (2, 4, 0, 1)])
def test_cuda_flash_attention_on_a_shards_heads(cuda, dtype, heads):
    """A model shard's heads as the sharded layers give them: q and k/v head
    slices [q0, q1) and [k0, k1) of the (B, S, H Dh) projections' head-major
    views (strided in the head dim, no copy), GQA group 6 as qwen2-1.5b at
    model 2: each query row against the plain version (f32 1e-4, bf16 1e-2
    of its max), and the bits of the all-heads call's rows."""
    from repro_torch.kernels import flash_attention as fa

    q0, q1, k0, k1 = heads
    b, s, hq, hkv, dh = 2, 256, 12, 2, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = [torch.randn(b, s, h * dh, generator=g, device=cuda).to(dtype)
               .view(b, s, h, dh).transpose(1, 2) for h in (hq, hkv, hkv)]
    part = (q[:, q0:q1], k[:, k0:k1], v[:, k0:k1])
    assert not part[0].is_contiguous()
    _flash_check(fa, *part, True, 1e-4 if dtype == torch.float32 else 1e-2)
    got = fa.flash_attention(*part, scale=dh**-0.5, causal=True)
    whole = fa.flash_attention(q, k, v, scale=dh**-0.5, causal=True)
    assert torch.equal(got, whole[:, q0:q1])


@pytest.mark.gpu
@pytest.mark.parametrize("h0,h1", [(0, 32), (32, 64), (16, 48)])
def test_cuda_wkv6_chunk_on_a_shards_heads(cuda, h0, h1):
    """rwkv6-7b's heads [h0, h1) of (B, S, 64, 64) projections at a chunk
    offset (strided views, as a model shard reads them): the bits of
    contiguous copies and of the all-heads call's heads, and its plain chunk
    form in f64 (2e-4)."""
    from repro_torch.kernels import wkv6_chunk as wkv

    b, s, h, q, c = 2, 512, 64, 256, 256
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = {n: (torch.randn(b, s, h, 64, generator=gen, device=cuda) * 0.5) for n in "rkv"}
    logw = -torch.exp(torch.randn(b, s, h, 64, generator=gen, device=cuda) * 0.6 - 1.0)
    u = torch.randn(h, 64, generator=gen, device=cuda) * 0.5
    s0 = torch.randn(b, h, 64, 64, generator=gen, device=cuda) * 0.3
    full = [t[:, c:c + q].transpose(1, 2) for t in (x["r"], x["k"], x["v"], logw)]
    part = [t[:, h0:h1] for t in full]
    u_l, s0_l = u[h0:h1], s0[:, h0:h1].contiguous()  # u, s0 dense (a shard's own state)
    y, st = wkv.wkv6_chunk(*part, u_l, s0_l)
    y2, st2 = wkv.wkv6_chunk(*(t.contiguous() for t in part), u_l, s0_l)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    yw, sw = wkv.wkv6_chunk(*full, u, s0)
    assert torch.equal(y, yw[:, h0:h1]) and torch.equal(st, sw[:, h0:h1])
    y64, s64 = wkv.ref.wkv6_chunk_factored(*part, u_l, s0_l, dtype=torch.float64)
    assert _row_rel(y, y64) <= 2e-4
    assert float((st.double() - s64).abs().max() / s64.abs().max()) <= 2e-4


def _sharded_prefill_worker(group, device, arch, toks):
    """A (1, 2) mesh (model 2) prefill of a smoke model on this worker's
    blocks, on the card: its last logits and the kernels it launched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import params as P
    from repro_torch.launch import sharding, steps

    cfg = get_config(arch, smoke=True)
    mesh = M.make_mesh((1, 2), ("data", "model"), group)
    params = P.init_local_params(cfg, 7, mesh, device=device)
    with sharding.use_mesh(mesh), torch.no_grad(), kernels.Executed(device) as ran:
        last, _ = steps.make_prefill_step(cfg)(params, {"tokens": toks.to(device)})
    return last.cpu(), dict(ran.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "rwkv6_7b"])
def test_cuda_sharded_prefill_on_two_gloo_workers(cuda, arch):
    """Two gloo workers on the card, model axis 2 (each worker its heads,
    the row-parallel products' psum through gloo): the last logits of the
    one-device prefill on the card (rtol 1e-4 of max), and every worker ran
    the flash or WKV6 kernel on its heads."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dfw, steps
    from repro_torch.models import lm

    cfg = get_config(arch, smoke=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    params = lm.init_params(cfg, 7, device=cuda)
    with torch.no_grad():
        want = steps.make_prefill_step(cfg)(params, {"tokens": toks.to(cuda)})[0].cpu()
    outs = dfw.run_workers(2, _sharded_prefill_worker, arch, toks, device="cuda")
    kernel = "wkv6_chunk" if cfg.family == "ssm" else "flash_attention"
    for got, launches in outs:
        _close(got, want, atol_rel=1e-4)
        assert launches[kernel] >= cfg.num_layers, launches
