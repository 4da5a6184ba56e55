"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
package's test holds its kernel (rtol = atol = 2e-4, f32); the ssm smoke
model's prefill on the card to the CPU's as the dense one's.
"""
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


def _coo(n_rows, n_cols, p, device, seed=0, heavy=0):
    """COO entries with a skewed row law, duplicates, an empty row and column
    and ``heavy`` extra entries in column 1 (several kernel pieces)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = (torch.arange(n_rows, dtype=torch.float64) + 1) ** -0.6
    rows = torch.multinomial(w, p, replacement=True, generator=g)
    cols = torch.randint(0, n_cols, (p,), generator=g)
    if heavy:
        rows = torch.cat([rows, torch.randint(0, n_rows, (heavy,), generator=g)])
        cols = torch.cat([cols, torch.ones(heavy, dtype=torch.long)])
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
    eng = serve.ServingEngine(300, 200, serve.ServeConfig(max_batch=16, rank_block=8))
    old, new = packed(5), packed(7)
    eng.load(old)
    x = rng.standard_normal((9, 300)).astype(np.float32)
    first = eng.score_async(x)
    eng.load(new)
    second = eng.score_async(x)
    np.testing.assert_allclose(first.block(), x @ dense(old), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(second.block(), x @ dense(new), rtol=1e-4, atol=1e-4)
    assert (first.version, second.version) == (0, 1)
    assert kernels.launches()["factor_matvec"] == before + 2 + 2
    assert eng.stats == {"compilations": 1, "dispatches": 2, "loads": 2, "requests": 18}


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
                                 (4099, 2048), (20000, 12), (9, 1001)])
@pytest.mark.parametrize("k", [1, 3, 8, 17, 32, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_matmat_rmatmat_match_plain(cuda, n, m, k, aligned):
    """One launch a call of each; repeated calls give the same bits."""
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
@pytest.mark.parametrize("d,m,p,heavy", [(40, 30, 600, 0), (1000, 300, 50000, 5000),
                                         (20000, 17, 300000, 0), (3, 5000, 7, 0)])
@pytest.mark.parametrize("k", [1, 3, 8, 32, 33])
def test_cuda_coo_matmat_matches_plain(cuda, d, m, p, heavy, k):
    """G V and G^T U on the sorted copies; the same bits on repeat."""
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy)
    v, u = torch.randn(m, k, device=cuda), torch.randn(d, k, device=cuda)
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
@pytest.mark.parametrize("d,m,p,heavy", [(40, 30, 600, 0), (1000, 300, 50000, 5000),
                                         (20000, 17, 300001, 0), (3, 5000, 7, 0)])
@pytest.mark.parametrize("k", [2, 3, 8, 32])
def test_cuda_update_resid_block_is_the_chain_bit_for_bit(cuda, d, m, p, heavy, k):
    """With (d, k) and (m, k) factors: the three outputs equal the plain
    chain (the k-term dot in ascending j, then the step) and its gathers,
    bit for bit; one launch, on the block route."""
    from repro_torch.core import tasks
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy)
    weight = (torch.arange(rows.numel(), device=cuda) % 3 != 0).float()
    resid = weight * torch.randn(rows.numel(), device=cuda)
    state = tasks.mc_state(rows, cols, vals, resid, weight, d, m)
    u, v = torch.randn(d, k, device=cuda), torch.randn(m, k, device=cuda)
    gamma = 2.0 / (torch.full((), 5.0, device=cuda) + 2.0)
    want = mc.ref.resid_step_dot(gamma, 1.75, resid, vals, weight,
                                 mc.ref.entry_dot(u, v, rows, cols))
    before = dict(mc.update_resid.route_launches)
    got = tasks.MatrixCompletion(d, m).update(state, u, v, gamma, 1.75)
    torch.cuda.synchronize()
    assert mc.update_resid.route_launches["block"] == before["block"] + 1
    assert torch.equal(got.resid, want)
    assert torch.equal(got.resid_by_row, mc.gather_sorted(state.by_row, want))
    assert torch.equal(got.resid_by_col, mc.gather_sorted(state.by_col, want))


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,p,heavy", [(40, 30, 600, 0), (1000, 300, 50000, 5000),
                                         (20000, 17, 300001, 0), (3, 5000, 7, 0)])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_cuda_update_resid_caller_is_the_block_launch_s_caller_order(cuda, d, m, p, heavy, k):
    """The caller order alone (the block line search's values at gamma = 1):
    the plain chain's bits and the three-order launch's caller-order bits;
    one launch of its own, none on update_resid."""
    from repro_torch.core import tasks
    from repro_torch.kernels import mc_matvec as mc

    rows, cols, vals = _coo(d, m, p, cuda, heavy=heavy)
    weight = (torch.arange(rows.numel(), device=cuda) % 3 != 0).float()
    resid = weight * torch.randn(rows.numel(), device=cuda)
    state = tasks.mc_state(rows, cols, vals, resid, weight, d, m)
    u, v = torch.randn(d, k, device=cuda), torch.randn(m, k, device=cuda)
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

