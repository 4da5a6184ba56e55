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
