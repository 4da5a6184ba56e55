"""The port's power method on an explicit matrix (``power_method_dense``,
``top_singular_pair``), the twins of tests/test_power_method.py's first
three tests on the port, and the oracle against the JAX package's with the
reference's start vector injected.

Tolerances: the top pair within rel 1e-4 of the SVD's sigma and 0.999 in
direction (the reference test's own); the injected-start oracle within
1e-5 of the reference's u, v and sigma (f32 sums in another order); the
Kuczynski-Wozniakowski expected-error bound and sigma's monotone rise in K
as the reference states them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import power_method, sphere_vector, top_singular_pair

torch.set_num_threads(2)


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("d,m", [(30, 20), (64, 64), (17, 51)])
def test_converges_to_top_pair(d, m):
    a = _normal(0, (d, m))
    u, s, vt = np.linalg.svd(a.numpy().astype(np.float64), full_matrices=False)
    # (17, 51) has s2/s1 near 0.98: 300 iterations converge, as in the reference test
    res = top_singular_pair(a, 1, num_iters=300)
    assert float(res.sigma) == pytest.approx(s[0], rel=1e-4)
    assert abs(float(res.u.double() @ torch.from_numpy(u[:, 0]))) > 0.999
    assert abs(float(res.v.double() @ torch.from_numpy(vt[0]))) > 0.999
    assert float(res.u @ a @ res.v) >= 0.0  # the two-sided iteration fixes the sign


def test_sigma_underestimates_monotone():
    """||A^T u_K|| is nondecreasing in K and bounded by sigma1."""
    a = _normal(3, (40, 30))
    s1 = float(np.linalg.svd(a.numpy(), compute_uv=False)[0])
    prev = 0.0
    for k in [1, 2, 4, 8, 16]:
        sig = float(top_singular_pair(a, 7, num_iters=k).sigma)
        assert sig <= s1 * (1 + 1e-5)
        assert sig >= prev - 1e-5
        prev = sig


def test_kuczynski_expected_error_bound():
    """E|sigma_est^2 - s1^2| / s1^2 <= 0.871 ln(m) / (K - 1), Monte Carlo over
    random starts (each from its own generator seed)."""
    a = _normal(11, (50, 32))
    s1sq = float(np.linalg.svd(a.numpy(), compute_uv=False)[0]) ** 2
    m = 32
    for K in (3, 6, 12):
        errs = [abs(float(top_singular_pair(a, 1000 + trial * 13 + K, num_iters=K).sigma) ** 2
                    - s1sq) / s1sq for trial in range(64)]
        bound = 0.871 * np.log(m) / (K - 1)
        assert np.mean(errs) <= bound, (K, np.mean(errs), bound)


def test_top_singular_pair_draws_from_a_generator():
    a = _normal(5, (20, 12))
    gen = torch.Generator()
    gen.manual_seed(4)
    v0 = sphere_vector(gen, 12, "cpu")
    gen.manual_seed(4)
    got = top_singular_pair(a, gen, num_iters=9)
    want = power_method.power_method_dense(a, v0, 9)
    assert torch.equal(got.u, want.u) and torch.equal(got.sigma, want.sigma)
    assert torch.equal(top_singular_pair(a, 4, num_iters=9).v, want.v)


@pytest.mark.parametrize("d,m,iters", [(30, 20, 50), (17, 51, 5)])
def test_matches_jax_with_its_start_vector(d, m, iters):
    import jax

    from repro.core import power_method as jpm

    a = _normal(2, (d, m))
    key = jax.random.PRNGKey(1)
    want = jpm.top_singular_pair(a.numpy(), key, num_iters=iters)
    got = top_singular_pair(a, None, num_iters=iters,
                            v0=np.asarray(jpm.sphere_vector(key, m, np.float32)))
    for name in ("u", "v", "sigma"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
