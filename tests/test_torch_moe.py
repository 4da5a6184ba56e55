"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's ``repro.models.moe``, on the CPU.

Inputs are numpy arrays from a seed, fed to both packages. The routings are
the two smoke configs' (arctic-480b: 8 experts, top-2; llama4-scout: 4
experts, top-1) and one where the capacity drops tokens.

Tolerances: the routing (each token's top-k experts ``eidx``) and each
expert's capacity selection (``sel_idx``) must be equal index for index,
ties included (the reference's ``jax.lax.top_k`` puts the lower index first
among equal values). The smallest gap between a token's k-th and (k+1)-th
probabilities is printed; a token whose experts differ fails the test
unless its gap is below 1e-6 (a flip that rounding alone can cause), and
then the outputs are compared on the tokens whose experts saw no flip. f32
outputs within rtol 1e-5 and an atol of 1e-5 times max|reference| (sums in
another order), the Switch loss within rtol 1e-5. The combine is a gather
with the reference's scatter-add bits: held bit for bit to ``index_add_``
and across expert shards. bf16 on identical inputs (the same bf16 bits in
both packages) is held to the JAX package's own distance d between its bf16
and f32 outputs, as tests/test_torch_lm_bf16.py does: within 1.25 d of the
f32 output and sqrt(1 + 1.25^2) d of the JAX bf16 one (RMS, relative).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe as pmoe

torch.set_num_threads(2)

FLIP_GAP = 1e-6  # below this a k-th/(k+1)-th probability gap may flip by rounding
# (E, k, n tokens, d, f, skew): the two smoke routings, then one that drops
# tokens (router column 0 times the skew: expert 0 is picked ~190 times of
# 1024 against a capacity of 160)
ROUTINGS = {"arctic": (8, 2, 128, 64, 96, 1.0), "llama4": (4, 1, 128, 64, 128, 1.0),
            "dropping": (8, 2, 512, 32, 48, 3.0)}


def _inputs(e, n, d, f, seed, skew=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d**-0.5).astype(np.float32)
    router[:, 0] *= skew
    wg = (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) * f**-0.5).astype(np.float32)
    return x, router, wg, wu, wd


def _jax_routing(x, router, k, e_loc, offset, cap):
    """The reference's routing and selection steps (``moe._moe_math``'s first
    lines), which its function does not return: (probs, gate, eidx,
    sel_gate, sel_idx) as numpy."""
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.float32) @ jnp.asarray(router), axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    routed = eidx[None, :, :] == (offset + jnp.arange(e_loc))[:, None, None]
    score = jnp.max(jnp.where(routed, gate[None], -1.0), axis=-1)
    sel_gate, sel_idx = jax.lax.top_k(score, cap)
    return tuple(np.asarray(a) for a in (probs, gate, eidx, sel_gate, sel_idx))


def _gaps(probs, k):
    """Each token's gap between its k-th and (k+1)-th largest probability."""
    s = -np.sort(-np.asarray(probs, np.float64), axis=1)
    return s[:, k - 1] - s[:, k]


def _check_routing(got_eidx, want_eidx, probs, k):
    """eidx equal, or differing only at near-ties (gap < FLIP_GAP). Returns
    the experts a flipped token picked in either package (empty if none)."""
    gaps = _gaps(probs, k)
    print(f"smallest k-th/(k+1)-th probability gap: {gaps.min():.3e} (token "
          f"{int(gaps.argmin())})")
    got_eidx, want_eidx = np.asarray(got_eidx), np.asarray(want_eidx)
    flipped = np.flatnonzero((got_eidx != want_eidx).any(axis=1))
    for t in flipped:
        assert gaps[t] < FLIP_GAP, (f"token {t} routed to {got_eidx[t]} against the "
                                    f"reference's {want_eidx[t]} with a gap of {gaps[t]:.3e}")
    return set(got_eidx[flipped].ravel()) | set(want_eidx[flipped].ravel())


def _close(got, want, rows=None, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(float(np.abs(want).max()), 1e-30))


def _run_both(x, router, wg, wu, wd, k, e, offset, cap):
    kw = dict(k=k, num_experts=e, expert_offset=offset, capacity=cap)
    jout, jaux = jmoe._moe_math(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)),
                                **dict(kw, expert_offset=jnp.int32(offset)))
    pout, paux = pmoe._moe_math(*(torch.from_numpy(a) for a in (x, router, wg, wu, wd)), **kw)
    return (np.asarray(jout), float(jaux)), (pout, paux)


# ---------------------------------------------------------------------------
# Capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 7, 8, 9, 64, 100, 8192, 20_000])
@pytest.mark.parametrize("k,e,factor", [(1, 4, 1.25), (2, 8, 1.25), (2, 128, 1.25),
                                        (1, 16, 1.25), (2, 128, 1.0), (1, 16, 2.0)])
def test_capacity_matches_jax(n, k, e, factor):
    c = pmoe._capacity(n, k, e, factor)
    assert c == jmoe._capacity(n, k, e, factor)
    assert c == min(n, max(8, 8 * math.ceil(math.ceil(n * k / e * factor) / 8)))


def test_capacity_at_the_full_configs():
    """The slots of phase 32's prefills (4 x 2048 tokens) and decode (4)."""
    for arch, want in (("arctic_480b", 160), ("llama4_scout_17b_a16e", 640)):
        cfg = configs.get_config(arch)
        k, e, f = cfg.experts_per_token, cfg.num_experts, cfg.moe_capacity_factor
        assert pmoe._capacity(8192, k, e, f) == want
        assert pmoe._capacity(4, k, e, f) == 4  # decode: every token keeps its picks


# ---------------------------------------------------------------------------
# Routing, selection, the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ROUTINGS))
def test_routing_and_selection_match_jax(name):
    e, k, n, d, f, skew = ROUTINGS[name]
    x, router, *_ = _inputs(e, n, d, f, seed=1, skew=skew)
    cap = pmoe._capacity(n, k, e, 1.25)
    probs, gate, eidx, sel_gate, sel_idx = _jax_routing(x, router, k, e, 0, cap)
    pprobs, pgate, peidx = pmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    psel_gate, psel_idx = pmoe.select(pgate, peidx, e, 0, cap)
    _close(pprobs, probs)
    bad = _check_routing(peidx.numpy(), eidx, probs, k)
    rows = ~np.isin(eidx, list(bad)).any(axis=1)
    _close(pgate, gate, rows=rows)
    kept = [i for i in range(e) if i not in bad]  # experts no flip reached
    np.testing.assert_array_equal(psel_idx.numpy()[kept], sel_idx[kept])
    np.testing.assert_array_equal(psel_gate.numpy()[kept] > -0.5, sel_gate[kept] > -0.5)
    routed = np.bincount(eidx.ravel(), minlength=e)
    kept = (sel_gate > -0.5).sum(axis=1)
    np.testing.assert_array_equal(kept, np.minimum(routed, cap))
    if name == "dropping":
        assert cap == 160 and (routed > cap).any()  # the capacity drops tokens here


@pytest.mark.parametrize("name", list(ROUTINGS))
def test_moe_math_matches_jax(name):
    e, k, n, d, f, skew = ROUTINGS[name]
    x, router, wg, wu, wd = _inputs(e, n, d, f, seed=2, skew=skew)
    cap = pmoe._capacity(n, k, e, 1.25)
    (jout, jaux), (pout, paux) = _run_both(x, router, wg, wu, wd, k, e, 0, cap)
    probs, _, eidx, _, _ = _jax_routing(x, router, k, e, 0, cap)
    _, _, peidx = pmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    bad = _check_routing(peidx.numpy(), eidx, probs, k)
    rows = ~np.isin(eidx, list(bad)).any(axis=1) if bad else None
    _close(pout, jout, rows=rows)
    np.testing.assert_allclose(float(paux), jaux, rtol=1e-5)
    assert pout.dtype == torch.float32 and paux.dtype == torch.float32 and paux.dim() == 0


@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_scout_17b_a16e"])
def test_moe_block_matches_jax(arch):
    """The layer on (B, S, D) at the smoke config, with the reference's
    init's leaves (``init_moe``) fed to both."""
    cfg = jax_get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32))
    pp = {name: torch.from_numpy(np.array(a)) for name, a in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_block(jp, jnp.asarray(x), cfg)
    pout, paux = pmoe.moe_block(pp, torch.from_numpy(x), pcfg)
    assert tuple(pout.shape) == (2, 64, cfg.d_model)
    _close(pout, jout)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_scout_17b_a16e"])
def test_moe_block_needs_only_the_routing_fields(arch):
    """``moe_block`` reads the widths from its leaves: a config object with
    only the routing fields gives the full config's bits (the card test of
    the layer passes such an object)."""
    import types

    pcfg = configs.get_config(arch, smoke=True)
    pp = pmoe.init_moe(torch.Generator().manual_seed(6), pcfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 64, pcfg.d_model)).astype(np.float32))
    routing = types.SimpleNamespace(experts_per_token=pcfg.experts_per_token,
                                    num_experts=pcfg.num_experts,
                                    moe_capacity_factor=pcfg.moe_capacity_factor)
    got, want = pmoe.moe_block(pp, x, routing), pmoe.moe_block(pp, x, pcfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_init_moe_shapes_dtypes_and_scales():
    cfg = configs.get_config("arctic_480b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = pmoe.init_moe(gen, cfg, torch.bfloat16, "cpu")
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((d, e), torch.float32), "wg": ((e, d, f), torch.bfloat16),
        "wu": ((e, d, f), torch.bfloat16), "wd": ((e, f, d), torch.bfloat16)}
    for name, std in (("router", d**-0.5), ("wg", d**-0.5), ("wu", d**-0.5), ("wd", f**-0.5)):
        assert abs(float(p[name].float().std()) / std - 1) < 0.1, name


# ---------------------------------------------------------------------------
# Ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,k", [(8, 2), (4, 1)])
def test_ties_pick_the_lower_index(e, k):
    """A zero router: every probability is 1/E, so each token's picks are
    experts 0..k-1 and every gate at the capacity boundary is equal; each
    expert keeps the lowest token indices, as the reference does."""
    n, d, f = 256, 32, 48
    x, _, wg, wu, wd = _inputs(e, n, d, f, seed=6)
    router = np.zeros((d, e), np.float32)
    cap = pmoe._capacity(n, k, e, 1.25)
    _, _, eidx, sel_gate, sel_idx = _jax_routing(x, router, k, e, 0, cap)
    _, pgate, peidx = pmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    psel_gate, psel_idx = pmoe.select(pgate, peidx, e, 0, cap)
    np.testing.assert_array_equal(peidx.numpy(), np.broadcast_to(np.arange(k), (n, k)))
    np.testing.assert_array_equal(peidx.numpy(), eidx)
    np.testing.assert_array_equal(psel_idx.numpy(), sel_idx)
    assert cap < n
    np.testing.assert_array_equal(psel_idx.numpy()[:k], np.broadcast_to(np.arange(cap), (k, cap)))
    (jout, jaux), (pout, paux) = _run_both(x, router, wg, wu, wd, k, e, 0, cap)
    _close(pout, jout)
    assert float(pout[cap:].abs().max()) == 0.0  # the dropped tokens get nothing
    np.testing.assert_allclose(float(paux), jaux, rtol=1e-5)


def test_equal_gates_of_distinct_tokens_keep_the_lower_token():
    """Tokens with the same x have the same gates: at the capacity boundary
    the lower token index is kept."""
    e, k, d, f = 8, 2, 32, 48
    base, router, wg, wu, wd = _inputs(e, 16, d, f, seed=7)
    x = np.repeat(base, 16, axis=0)  # 256 tokens, 16 copies of each
    cap = pmoe._capacity(x.shape[0], k, e, 1.25)
    _, _, eidx, _, sel_idx = _jax_routing(x, router, k, e, 0, cap)
    _, pgate, peidx = pmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    _, psel_idx = pmoe.select(pgate, peidx, e, 0, cap)
    np.testing.assert_array_equal(peidx.numpy(), eidx)
    np.testing.assert_array_equal(psel_idx.numpy(), sel_idx)
    (jout, _), (pout, _) = _run_both(x, router, wg, wu, wd, k, e, 0, cap)
    _close(pout, jout)


# ---------------------------------------------------------------------------
# The combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ROUTINGS))
def test_combine_has_the_scatter_adds_bits(name, dtype):
    """The gather-sum gives the bits of the reference's scatter-add into
    zeros (``index_add_`` of every slot, empty ones included, in slot
    order), in f32 and in bf16."""
    e, k, n, d, f, skew = ROUTINGS[name]
    x, router, *_ = _inputs(e, n, d, f, seed=8, skew=skew)
    cap = pmoe._capacity(n, k, e, 1.25)
    _, gate, eidx = pmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    sel_gate, sel_idx = pmoe.select(gate, eidx, e, 0, cap)
    valid = sel_gate > -0.5
    ye = torch.from_numpy(np.random.default_rng(9).standard_normal((e, cap, d)).astype(
        np.float32)).to(dtype)
    ye = (ye * (sel_gate * valid).to(dtype)[..., None]).to(dtype)
    got = pmoe._combine(ye, sel_idx, valid, eidx, 0)
    want = torch.zeros((n, d), dtype=dtype).index_add_(0, sel_idx.reshape(-1), ye.reshape(-1, d))
    assert torch.equal(got, want)
    assert got.dtype == dtype


@pytest.mark.parametrize("shards", [2, 4])
def test_expert_shards_sum_to_the_whole_layer(shards):
    """``expert_offset``: each shard's local experts, as the reference's
    expert-parallel body calls ``_moe_math``; each shard matches the JAX
    shard, and the shards' outputs added in f32 give the whole layer's bits
    (each token has at most k = 2 nonzero addends)."""
    e, k, n, d, f, skew = ROUTINGS["dropping"]
    x, router, wg, wu, wd = _inputs(e, n, d, f, seed=10, skew=skew)
    cap = pmoe._capacity(n, k, e, 1.25)
    whole, whole_aux = pmoe._moe_math(*(torch.from_numpy(a) for a in (x, router, wg, wu, wd)),
                                      k=k, num_experts=e, expert_offset=0, capacity=cap)
    e_loc = e // shards
    total = torch.zeros_like(whole)
    for s in range(shards):
        sl = slice(s * e_loc, (s + 1) * e_loc)
        (jout, jaux), (pout, paux) = _run_both(x, router, wg[sl], wu[sl], wd[sl], k, e,
                                               s * e_loc, cap)
        _close(pout, jout)
        np.testing.assert_allclose(float(paux), jaux, rtol=1e-5)
        assert torch.equal(paux, whole_aux)  # the aux loss is each shard's whole estimate
        total = total + pout
    assert torch.equal(total, whole)


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------


def _rms_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_scout_17b_a16e"])
def test_bf16_moe_block_is_as_close_to_jax_as_jax_bf16_is_to_f32(arch):
    """The same bf16 x and expert weights (router f32) in both packages; the
    f32 output from the same values upcast. The routing reads x in f32 in
    every run, so it is the same in all three."""
    cfg = jax_get_config(arch, smoke=True)
    pcfg = configs.get_config(arch, smoke=True)
    jp16 = jmoe.init_moe(jax.random.PRNGKey(11), cfg, jnp.bfloat16)
    jp32 = {name: a.astype(jnp.float32) for name, a in jp16.items()}
    x32 = np.random.default_rng(12).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    x16 = jnp.asarray(x32).astype(jnp.bfloat16)
    j16, jaux16 = jmoe.moe_block(jp16, x16, cfg)
    j32, jaux32 = jmoe.moe_block(jp32, x16.astype(jnp.float32), cfg)
    j16 = np.asarray(j16.astype(jnp.float32))

    def to_torch(a):
        a = np.asarray(jax.device_get(a))
        if a.dtype == np.float32:
            return torch.from_numpy(np.array(a))
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)

    pp16 = {name: to_torch(a) for name, a in jp16.items()}
    assert pp16["router"].dtype == torch.float32 and pp16["wg"].dtype == torch.bfloat16
    p16, paux16 = pmoe.moe_block(pp16, to_torch(x16), pcfg)
    assert p16.dtype == torch.bfloat16
    p16 = p16.float().numpy()
    np.testing.assert_allclose(float(paux16), float(jaux16), rtol=1e-5)
    np.testing.assert_allclose(float(jaux16), float(jaux32), rtol=1e-6)
    d = _rms_rel(j16, j32)
    assert 0 < d < 0.05
    assert _rms_rel(p16, j32) <= 1.25 * d, (_rms_rel(p16, j32), d)
    assert _rms_rel(p16, j16) <= math.sqrt(1 + 1.25**2) * d, (_rms_rel(p16, j16), d)
