"""Special-function accuracy vs scipy (float64 ground truth)."""

import numpy as np
import pytest
import scipy.special as ss
import jax
import jax.numpy as jnp

from cloudy_tpu.ops import special


def test_lgamma_accuracy():
    x = np.concatenate(
        [np.linspace(0.01, 1.0, 57), np.linspace(1.0, 50.0, 200), [1e-3, 100.0, 170.0]]
    )
    got = np.asarray(special.lgamma(jnp.asarray(x)))
    want = ss.gammaln(x)
    np.testing.assert_allclose(got, want, rtol=5e-13, atol=1e-12)


def test_gammainc_accuracy():
    a = np.logspace(-3, np.log10(50.0), 40)
    x = np.concatenate([[0.0], np.logspace(-8, np.log10(200.0), 80)])
    A, X = np.meshgrid(a, x)
    got = np.asarray(special.gammainc(jnp.asarray(A), jnp.asarray(X)))
    want = ss.gammainc(A, X)
    np.testing.assert_allclose(got, want, rtol=5e-12, atol=1e-14)


def test_gammainc_extremes():
    # large x saturates to 1, x <= 0 gives 0, no NaNs at inf
    assert float(special.gammainc(2.0, jnp.inf)) == 1.0
    assert float(special.gammainc(2.0, 0.0)) == 0.0
    assert float(special.gammainc(2.0, -1.0)) == 0.0
    assert np.isfinite(float(special.gammainc(10.0, 1e30)))


def test_gammaincinv_roundtrip():
    # domain the physics uses: gamma shape k in [~0.1, 20], percentile
    # thresholds (reference MovingThreshold uses 0.97/0.99). Smaller a with
    # p→0 gives sub-denormal answers (x ~ 1e-200) that are physically
    # meaningless and excluded.
    a = np.logspace(-1, np.log10(20.0), 25)
    p = np.array([1e-4, 1e-3, 0.03, 0.25, 0.5, 0.75, 0.97, 0.99, 1 - 1e-6])
    A, P = np.meshgrid(a, p)
    x = np.asarray(special.gammaincinv(jnp.asarray(A), jnp.asarray(P)))
    want = ss.gammaincinv(A, P)
    np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-280)


def test_ndtri():
    p = np.array([1e-9, 1e-4, 0.01, 0.3, 0.5, 0.7, 0.99, 1 - 1e-6])
    got = np.asarray(special.ndtri(jnp.asarray(p)))
    want = ss.ndtri(p)
    err = np.abs(got - want)
    assert np.all(err <= 1e-8 + 1e-5 * np.abs(want))


@pytest.mark.slow
def test_special_jit_and_grad():
    # must be traceable and differentiable (closure sensitivities)
    f = jax.jit(lambda a, x: special.gammainc(a, x))
    assert np.isfinite(float(f(2.5, 1.3)))
    g = jax.grad(lambda x: special.gammainc(2.5, x))(1.3)
    # d/dx P(a,x) = x^(a-1) e^-x / Γ(a)
    want = 1.3**1.5 * np.exp(-1.3) / ss.gamma(2.5)
    np.testing.assert_allclose(float(g), want, rtol=1e-8)


def test_gammainc_gl_proven_bound_exact_f2_domain():
    """The PROVEN worst-case bound behind the bench configuration: over the
    entire (a, x) domain the exact-F2 path can request —
    a = 2k + 2M − 2 with k ∈ (eps, 10] and M = 4 ⇒ a ∈ (6, 26], and
    x = min(T/θ, 1e6) ∈ (0, 1e6] — the 12-node Gauss–Legendre evaluator's
    absolute error vs scipy stays below 5e-7 in f64. The fixed-iteration
    series/CF pair it replaces has 1.7e-2 at its x ≈ a corner at the same
    12-step cost (documented, not asserted: it remains the small-a /
    reference-parity path where it converges fast)."""
    from scipy.special import gammainc as sgi

    a = np.concatenate([np.linspace(4.0, 26.0, 45), [26.0]])
    x = np.concatenate(
        [np.logspace(-6, 6, 80), np.linspace(0.5, 80.0, 300)]
    )
    A, X = np.meshgrid(a, x)
    ref = sgi(A, X)
    got = np.asarray(
        special.gammainc_gl(jnp.asarray(A), jnp.asarray(X), n_nodes=12)
    )
    assert np.abs(got - ref).max() < 5e-7

    # and the lower tail of the quadrature-path domain (a = k + M − 1 ≥ 2)
    a2 = np.linspace(2.0, 4.0, 21)
    A2, X2 = np.meshgrid(a2, x)
    err2 = np.abs(
        np.asarray(
            special.gammainc_gl(jnp.asarray(A2), jnp.asarray(X2), n_nodes=12)
        )
        - sgi(A2, X2)
    )
    assert err2.max() < 1e-4


def test_gammainc_gl_f32():
    """f32 (the production dtype): the GL evaluator keeps ~1e-5 absolute
    accuracy over the exact-F2 domain — vs 1.7e-2 for 12-iteration series/CF
    at the corner."""
    from scipy.special import gammainc as sgi

    a = np.linspace(4.0, 26.0, 23)
    x = np.concatenate([np.logspace(-4, 5, 40), np.linspace(1.0, 60.0, 120)])
    A, X = np.meshgrid(a, x)
    got = np.asarray(
        special.gammainc_gl(
            jnp.asarray(A, jnp.float32), jnp.asarray(X, jnp.float32), n_nodes=12
        ),
        np.float64,
    )
    assert np.abs(got - sgi(A, X)).max() < 5e-5


def test_gammainc_gl_edge_cases():
    out = np.asarray(
        special.gammainc_gl(
            jnp.asarray([6.0, 10.0, 26.0]), jnp.asarray([0.0, 1e7, 1e-30])
        )
    )
    assert out[0] == 0.0  # x = 0
    assert abs(out[1] - 1.0) < 1e-12  # far right tail (clamped)
    assert out[2] >= 0.0 and out[2] < 1e-20  # deep left tail


def test_gamma_ratio_proven_bound():
    """Γ(k+e)/Γ(k) via shift-3 Stirling difference (the whole-step kernel's
    sedimentation fractional-moment base, replacing a Lanczos-lgamma pair):
    relative error < 5e-7 over k ∈ [1e-6, 50] × e ∈ [0, 1] vs scipy."""
    k = np.logspace(-6, np.log10(50.0), 300)
    for e in (1.0 / 6.0, 1.0 / 3.0, 0.5, 2.0 / 3.0, 5.0 / 6.0, 1.0):
        got = np.asarray(special.gamma_ratio(jnp.asarray(k), e))
        want = np.exp(ss.gammaln(k + e) - ss.gammaln(k))
        assert np.abs(got / want - 1.0).max() < 5e-7, e
    # e = 0 is exactly 1
    np.testing.assert_allclose(
        np.asarray(special.gamma_ratio(jnp.asarray(k), 0.0)), 1.0, rtol=1e-12
    )


def test_gammainc_gl_shift_uniform_bound():
    """The shift-4 downward-recurrence extension of gammainc_gl: absolute
    error < 5e-7 UNIFORMLY over a ∈ (0, 10] × x ∈ (0, 1e6] — the small-a
    region where bare gammainc_gl is out of domain and the series/CF pair
    needs its full iteration budget."""
    a = np.logspace(-3, 1, 60)
    x = np.concatenate([np.logspace(-6, 6, 80), np.linspace(0.5, 40.0, 160)])
    A, X = np.meshgrid(a, x)
    got = np.asarray(special.gammainc_gl_shift(jnp.asarray(A), jnp.asarray(X)))
    assert np.abs(got - ss.gammainc(A, X)).max() < 5e-7


def test_gammaincinv_gl_proven_bound():
    """The fast MovingThreshold percentile inverse (WH+small-x start, 3
    Halley iterations, shift-4 GL inner): worst-case RELATIVE error vs
    scipy < 2e-5 over the reachable domain k ∈ [0.02, 10] × p ∈ [0.01,
    0.995] in f64, and < 2e-4 in f32 wherever the true quantile is
    f32-representable. This is the proven-minimal replacement for the
    32-Newton × 128-iteration defaults: ~3x cheaper than
    even the 8×12 ablation setting at ~1000x better worst-case accuracy."""
    k = np.logspace(np.log10(0.02), 1, 90)
    p = np.array([0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.995])
    K, P = np.meshgrid(k, p, indexing="ij")
    ref = ss.gammaincinv(K, P)
    got = np.asarray(special.gammaincinv_gl(jnp.asarray(K), jnp.asarray(P)))
    assert np.abs(got / ref - 1.0).max() < 2e-5

    got32 = np.asarray(
        special.gammaincinv_gl(
            jnp.asarray(K, jnp.float32), jnp.asarray(P, jnp.float32)
        ),
        np.float64,
    )
    rel32 = np.where(ref > 1e-30, np.abs(got32 / ref - 1.0), 0.0)
    assert rel32.max() < 2e-4


def test_gammaincinv_gl_small_k_domain():
    """The closure inversion clips k to (eps, 10], so production
    columns reach k far below the 0.02 floor of the main sweep. Pin the
    fast inverse down to the f64 k-clip floor: the small-x start
    ``(p·Γ(a+1))^(1/a)`` is the EXACT leading-order inverse there, so f64
    error collapses to < 5e-9 wherever the true quantile is representable,
    and where scipy's quantile underflows to 0 the impl returns the `tiny`
    clamp — physically a zero threshold, which is the right answer. In f32
    the 1/a exponent amplifies log-argument rounding, so the band bound is
    looser (measured worst 2.8e-3; pinned at 1e-2)."""
    k = np.logspace(np.log10(2.3e-16), np.log10(0.02), 60)
    p = np.array([0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.995])
    K, P = np.meshgrid(k, p, indexing="ij")
    ref = ss.gammaincinv(K, P)
    got = np.asarray(special.gammaincinv_gl(jnp.asarray(K), jnp.asarray(P)))
    rep = ref > 1e-300
    assert np.abs(got[rep] / ref[rep] - 1.0).max() < 5e-9
    # underflowed true quantile → the tiny clamp (effectively zero)
    assert got[~rep].max() < 1e-300 * 2 or (~rep).sum() == 0

    k32 = np.logspace(np.log10(1.2e-7), np.log10(0.02), 40)
    K32, P32 = np.meshgrid(k32, p, indexing="ij")
    ref32 = ss.gammaincinv(K32, P32)
    got32 = np.asarray(
        special.gammaincinv_gl(
            jnp.asarray(K32, jnp.float32), jnp.asarray(P32, jnp.float32)
        ),
        np.float64,
    )
    m = ref32 > 1e-30
    assert np.abs(got32[m] / ref32[m] - 1.0).max() < 1e-2
    assert got32[~m].max() < 1e-30 if (~m).any() else True


def test_erf_approx_proven_bound():
    """Rational erf (A&S 7.1.26): max absolute error ≤ 1.6e-7 vs scipy over
    the full real line (the lognormal fast path's special function — same
    error class as gammainc_gl's 2.6e-7)."""
    from scipy.special import erf as serf

    x = np.concatenate(
        [np.linspace(-8, 8, 4001), np.array([-1e9, -30.0, 30.0, 1e9, 0.0])]
    )
    got = np.asarray(special.erf_approx(jnp.asarray(x)))
    assert np.abs(got - serf(x)).max() < 1.6e-7
    # f32 as well (the production dtype)
    got32 = np.asarray(special.erf_approx(jnp.asarray(x, jnp.float32)), np.float64)
    assert np.abs(got32 - serf(x)).max() < 1e-6


def test_new_special_fns_jit_and_grad():
    """Round-4 special functions are traceable and differentiable (the
    calibration adjoint runs through the fast tier)."""
    g = jax.grad(lambda k: special.gamma_ratio(k, 1.0 / 6.0))(2.0)
    # d/dk Γ(k+e)/Γ(k) = ratio · (ψ(k+e) − ψ(k))
    want = np.exp(ss.gammaln(2.0 + 1 / 6) - ss.gammaln(2.0)) * (
        ss.digamma(2.0 + 1 / 6) - ss.digamma(2.0)
    )
    np.testing.assert_allclose(float(g), want, rtol=1e-5)

    f = jax.jit(lambda a, x: special.gammainc_gl_shift(a, x))
    assert np.isfinite(float(f(0.3, 1.2)))
    gi = jax.grad(lambda x: special.gammainc_gl_shift(0.7, x))(0.9)
    want = 0.9 ** (0.7 - 1.0) * np.exp(-0.9) / ss.gamma(0.7)
    np.testing.assert_allclose(float(gi), want, rtol=1e-4)

    inv = jax.jit(special.gammaincinv_gl)
    assert np.isfinite(float(inv(1.5, 0.9)))


def test_lgamma_stirling_bound():
    """The fast-tier 1-divide Stirling-shift lgamma (Lanczos has 8
    divides): absolute error < 4e-9 over the exact-F2 path's reachable
    domain x = 2k+1 ∈ (1, 21] and beyond (x ∈ (0, 50])."""
    x = np.concatenate(
        [np.logspace(-6, 0, 40), np.linspace(1.0, 50.0, 300)]
    )
    got = np.asarray(special.lgamma_stirling(jnp.asarray(x)))
    assert np.abs(got - ss.gammaln(x)).max() < 4e-9
    # f32: error at the f32 resolution of the result
    got32 = np.asarray(
        special.lgamma_stirling(jnp.asarray(x, jnp.float32)), np.float64
    )
    assert np.abs(got32 - ss.gammaln(x)).max() < 5e-5  # ~3 ulp of lgamma(50)=144
