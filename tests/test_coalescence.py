"""Analytical coalescence correctness — mirrors the reference's anchor tests
in test_Sources_correctness.jl (Smoluchowski 1916; independent dense
reimplementation of the exp+gamma Q/R/S assembly; conservation laws)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import distributions as pd
from cloudy_tpu import kernels as K
from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints

RTOL = 1e-3


def _params(spec, mom):
    return pd.params_from_moments(spec, jnp.asarray(mom))


def test_smoluchowski_1916_constant_kernel():
    """Forward-Euler steps of get_coal_ints vs the analytic solution
    M0(t) = 1/(1/a + b t/2), M1 conserved (reference :41-85)."""
    spec = SpectrumSpec((Family.EXPONENTIAL,))

    for use_function in (True, False):
        if use_function:
            ker = K.CoalescenceTensor.from_function(
                K.ConstantKernelFunction(1.0), 0, 100.0
            )
        else:
            ker = K.CoalescenceTensor([[1.0]])
        data = build_coalescence_data(spec, ker, (np.inf,))

        step = jax.jit(lambda m: m + 1e-4 * get_coal_ints(data, _params(spec, m)))
        mom = jnp.asarray([1.0, 2.0])
        n_steps = 5
        for i in range(n_steps):
            mom = step(mom)
        t = 1e-4 * n_steps
        m = np.asarray(mom)
        assert m[0] == pytest.approx(1.0 / (1.0 + 0.5 * t), rel=RTOL)
        assert m[1] == pytest.approx(2.0, rel=RTOL)


def test_exp_gamma_vs_independent_reimplementation():
    """Reference :87-169: two-mode gamma+exponential with a linear-kernel
    tensor and a finite threshold on mode 0, checked term by term against an
    independent dense numpy reimplementation of the Q/R/S assembly."""
    spec = SpectrumSpec((Family.GAMMA, Family.EXPONENTIAL))
    order = 1
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5e-3), order, 10.0)
    thresholds = (0.5, np.inf)
    data = build_coalescence_data(spec, ker, thresholds)

    params = jnp.asarray([[100.0, 0.1, 1.0], [1.0, 1.0, 0.0]])
    got = np.asarray(get_coal_ints(data, params))

    # ---- independent dense reimplementation (numpy) ----
    n_mom = max(spec.nprogmoms) + order
    kc = ker.array
    mom = np.zeros((2, n_mom))
    for i in range(2):
        for j in range(n_mom):
            mom[i, j] = float(pd.moment(spec, params, float(j))[i])

    eps = np.finfo(np.float64).eps
    mm = np.zeros((n_mom, n_mom))
    thr = np.zeros((n_mom, n_mom))
    for i in range(n_mom):
        for j in range(i, n_mom):
            mm[i, j] = mom[0, i] * mom[0, j]
            if mm[i, j] < eps:
                t = 0.0
            else:
                t = float(
                    pd.moment_source_helper(
                        spec, params, 0, float(i), float(j), thresholds[0]
                    )
                )
            thr[i, j] = min(mm[i, j], t)
            mm[j, i] = mm[i, j]
            thr[j, i] = thr[i, j]

    want = np.zeros(spec.n_tot)
    for i in range(2):
        j = 1 - i
        for k in range(spec.nprogmoms[i]):
            temp = 0.0
            for a in range(order + 1):
                for b in range(order + 1):
                    coef = kc[a, b]
                    temp -= coef * mom[i, a + k] * mom[i, b]
                    temp -= coef * mom[i, a + k] * mom[j, b]
                    for c in range(k + 1):
                        cb = coef * math.comb(k, c)
                        if i == 0:
                            temp += 0.5 * cb * thr[a + c, b + k - c]
                        else:
                            temp += 0.5 * cb * (mm[a + c, b + k - c] - thr[a + c, b + k - c])
                            temp += 0.5 * cb * mom[i, a + c] * mom[i, b + k - c]
                            temp += cb * mom[j, a + c] * mom[i, b + k - c]
            want[spec.dist_moment_ind(i, k)] = temp

    # the incomplete-gamma recurrence in the fused path vs the direct
    # evaluation in moment_source_helper differ at the last few ulps
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_single_mode_mass_conservation_exact():
    """For a single mode the M1 tendency must vanish identically (gain = loss
    by kernel symmetry); M0 decreases, M2 increases (reference :253-263)."""
    spec = SpectrumSpec((Family.GAMMA,))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=(1e6, 1e-9))
    mom_norms = np.array([1e6, 1e6 * 1e-9, 1e6 * 1e-18])
    mom = jnp.asarray([1e8, 1e-2, 2e-12]) / mom_norms
    out = np.asarray(get_coal_ints(data, _params(spec, mom)))
    assert out[0] < 0.0
    assert abs(out[1]) < 1e-12 * abs(out[0])
    assert out[2] > 0.0


def test_multi_mode_mass_conservation():
    """Total mass conservation across modes with thresholds (promotion moves
    mass between modes but conserves the sum)."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9)
    )
    norms = np.concatenate([1e6 * 1e-9 ** np.arange(3)] * 2)
    mom = jnp.asarray([1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16]) / norms
    out = np.asarray(get_coal_ints(data, _params(spec, mom)))
    dM1_total = out[1] + out[4]
    scale = abs(out[1]) + abs(out[4])
    assert abs(dM1_total) < 1e-10 * scale
    # number decreases in total
    assert out[0] + out[3] < 0.0


def test_batched_columns_match_single():
    """vmap-free batching: a [B, n_tot] moment array gives the same result as
    B independent calls."""
    spec = SpectrumSpec((Family.GAMMA, Family.EXPONENTIAL))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5e-3), 1, 10.0)
    # iteration budget irrelevant to the batching-identity property;
    # 16 keeps the unrolled-gammainc compile 8x smaller (suite budget)
    data = build_coalescence_data(spec, ker, (0.5, np.inf), gammainc_iters=16)

    rng = np.random.default_rng(1)
    B = 7
    params_np = np.zeros((B, 2, 3))
    params_np[:, 0] = np.stack(
        [rng.uniform(50, 150, B), rng.uniform(0.05, 0.2, B), rng.uniform(0.5, 3, B)],
        axis=-1,
    )
    params_np[:, 1] = np.stack(
        [rng.uniform(0.5, 2, B), rng.uniform(0.5, 2, B), np.zeros(B)], axis=-1
    )
    params = jnp.asarray(params_np)
    batched = np.asarray(get_coal_ints(data, params))
    for b in range(B):
        single = np.asarray(get_coal_ints(data, params[b]))
        np.testing.assert_allclose(batched[b], single, rtol=1e-12, atol=1e-300)


def test_moving_threshold_runs_and_conserves():
    """MovingThreshold percentile path (reference :152-185): thresholds are
    recomputed from the distributions each call; mass stays conserved."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (0.99, 1.0), norms=(1e6, 1e-9), moving=True
    )
    norms = np.concatenate([1e6 * 1e-9 ** np.arange(3)] * 2)
    mom = jnp.asarray([1e8, 1e-2, 2e-12, 1.0, 1e-8, 2e-16]) / norms
    out = np.asarray(jax.jit(lambda m: get_coal_ints(data, _params(spec, m)))(mom))
    assert np.all(np.isfinite(out))
    dM1_total = out[1] + out[4]
    assert abs(dM1_total) < 1e-9 * (abs(out[1]) + abs(out[4]))


def test_empty_mode_gives_zero_tendency():
    """A zero-number mode must not produce NaNs or spurious tendencies."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
    mom = jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    out = np.asarray(get_coal_ints(data, _params(spec, mom)))
    np.testing.assert_array_equal(out, np.zeros(6))


@pytest.mark.slow
def test_gammainc_downward_recurrence_m_scaling():
    """The F2 matrix evaluates incomplete gammas at M consecutive orders via
    the downward recurrence P(a,x) = P(a+1,x) + x^a e^{−x}/Γ(a+1) — additions
    of positive terms, so no cancellation at any order. This pins the
    accumulated error at M = 8 (vs the typical production M = 4) against a
    fully independent scipy evaluation at every order, so the recurrence's
    error growth is bounded by a test rather than by the [0,1] clip (the
    *upward* subtractive variant loses ~1.5 digits per order and failed a
    1e-8 gate at M = 8; see coalescence._msh_matrix_gamma)."""
    from scipy import special as sps

    from cloudy_tpu.coalescence import _msh_matrix_gamma
    from cloudy_tpu.distributions import threshold_log_grid
    from cloudy_tpu.ops.simpson import simpson_even_fast_weights_dynamic

    M, n_points_max = 8, 128
    rng = np.random.default_rng(3)
    B = 64
    n = jnp.asarray(rng.uniform(10.0, 200.0, B))
    theta = jnp.asarray(rng.uniform(1e-3, 5.0, B))
    k = jnp.asarray(rng.uniform(2**-20, 10.0, B))
    thr = jnp.asarray(rng.uniform(0.05, 50.0, B))

    got = np.asarray(_msh_matrix_gamma(n, theta, k, thr, M, n_points_max, 128))

    # independent evaluation: scipy gammainc at every order q (no recurrence)
    dtype = theta.dtype
    x, dx, n_bins = threshold_log_grid(thr, n_points_max, dtype)
    x, dx = np.asarray(x), np.asarray(dx)
    w = np.asarray(simpson_even_fast_weights_dynamic(n_points_max, n_bins, dtype))
    mask = np.arange(1, n_points_max + 1) <= np.asarray(n_bins)[..., None]
    kn, thn, nn = np.asarray(k), np.asarray(theta), np.asarray(n)
    rem = np.maximum(np.asarray(thr)[..., None] - x, 0.0) / thn[..., None]
    GI = np.stack(
        [sps.gammainc(kn[..., None] + q, rem) for q in range(M)], axis=-2
    )
    logx = np.log(x)
    Y = np.stack(
        [
            np.exp((kn[..., None] + p) * logx - x / thn[..., None]) * w * mask
            for p in range(M)
        ],
        axis=-2,
    )
    raw = np.einsum("...pg,...qg->...pq", Y, GI) * dx[..., None, None]
    q = np.arange(M, dtype=np.float64)
    pref = (nn[..., None] ** 2) * np.exp(
        (q - kn[..., None]) * np.log(thn[..., None])
        + sps.gammaln(q + kn[..., None])
        - 2.0 * sps.gammaln(kn)[..., None]
    )
    want = raw * pref[..., None, :]

    scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
    abs_err = np.abs(got - want)
    assert (abs_err / scale).max() < 1e-12, (abs_err / scale).max()
    significant = np.abs(want) > 1e-6 * scale
    rel = abs_err / np.maximum(np.abs(want), 1e-300)
    assert rel[significant].max() < 1e-10, rel[significant].max()


def test_f2_exact_matches_scipy():
    """The exact gamma/exponential F2 factorization
    F2(p,q) = M_p·M_q·P(2k+p+q, T/θ) (coalescence._msh_matrix_gamma_exact;
    the reference evaluates this 2-D partial integral by nested quadrature,
    ParticleDistributions.jl:567-612) against a fully independent scipy
    evaluation of the same closed form — pins the downward recurrence at
    every order, M = 4 and M = 8."""
    from scipy import special as sps

    from cloudy_tpu.coalescence import _msh_matrix_gamma_exact

    rng = np.random.default_rng(7)
    B = 256
    n = jnp.asarray(rng.uniform(10.0, 200.0, B))
    theta = jnp.asarray(rng.uniform(1e-3, 5.0, B))
    k = jnp.asarray(rng.uniform(2**-20, 10.0, B))
    thr = jnp.asarray(rng.uniform(0.05, 50.0, B))
    for M in (4, 8):
        got = np.asarray(_msh_matrix_gamma_exact(n, theta, k, thr, M, 128))
        nn, thn, kn, Tn = map(np.asarray, (n, theta, k, thr))
        mp = np.stack(
            [
                nn * thn**p * np.exp(sps.gammaln(p + kn) - sps.gammaln(kn))
                for p in range(M)
            ],
            -1,
        )
        want = np.empty_like(got)
        for p in range(M):
            for q in range(M):
                want[..., p, q] = (
                    mp[..., p]
                    * mp[..., q]
                    * sps.gammainc(2 * kn + p + q, Tn / thn)
                )
        scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
        assert (np.abs(got - want) / scale).max() < 1e-12
        significant = np.abs(want) > 1e-6 * scale
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        assert rel[significant].max() < 1e-10, rel[significant].max()


@pytest.mark.slow
def test_f2_exact_vs_reference_simpson():
    """The exact factorization vs the reference's log-grid Simpson
    evaluation, split by shape parameter:

    - k ≥ 0.5: the two agree to the Simpson rule's own accuracy
      (normalized by M_p·M_q, the scale F2 enters the S-terms at) —
      median ~1e-5, worst ~0.8% at k ≈ 0.5 where the truncated-tail term
      (1e-5)^k starts to bite.
    - k ≪ 1: the reference's rule truncates the near-singular density at
      x_lo = 1e-5·T (ParticleDistributions.jl:579), losing ≈ P(k, x_lo/θ)
      ~ (1e-5·T/θ)^k/Γ(k+1) of the mode's mass — up to ~27% of the (0,0)
      entry at k ≈ 0.12. scipy.integrate.dblquad of the raw 2-D integral
      confirms the EXACT value (0.94297 vs exact 0.94292 vs Simpson 0.671
      at the worst sampled state), i.e. the discrepancy is the reference
      rule's truncation error, not ours; the exact path is strictly more
      accurate there. This subtest pins the discrepancy to the predicted
      truncated-tail mass."""
    from scipy import special as sps

    from cloudy_tpu.coalescence import (
        _msh_matrix_gamma,
        _msh_matrix_gamma_exact,
    )

    rng = np.random.default_rng(11)
    B = 128
    M = 4
    n = jnp.asarray(rng.uniform(10.0, 200.0, B))
    theta = jnp.asarray(rng.uniform(0.01, 2.0, B))
    k = jnp.asarray(rng.uniform(0.5, 8.0, B))
    thr = jnp.asarray(rng.uniform(0.5, 10.0, B) * np.asarray(theta * k))
    simpson = np.asarray(_msh_matrix_gamma(n, theta, k, thr, M, 128, 128))
    exact = np.asarray(_msh_matrix_gamma_exact(n, theta, k, thr, M, 128))
    nn, thn, kn = map(np.asarray, (n, theta, k))
    mp = np.stack(
        [
            nn * thn**p * np.exp(sps.gammaln(p + kn) - sps.gammaln(kn))
            for p in range(M)
        ],
        -1,
    )
    mm = mp[:, :, None] * mp[:, None, :]
    err = np.abs(simpson - exact) / mm
    assert np.median(err) < 5e-5, np.median(err)
    assert err.max() < 2e-2, err.max()

    # k ≪ 1: the deviation IS the reference rule's truncated tail mass.
    # With n = 1, the (0,0) entry equals P(2k, T/θ); the reference form's
    # inner integral is exact (gammainc), only the outer Simpson truncates
    # below x_lo, so Δ ≈ P(k, x_lo/θ) · P(k, T/θ) ∈ (0.5, 1)·P(k, x_lo/θ)
    # for these states.
    ksm = jnp.asarray(np.full(16, 0.12))
    thsm = jnp.asarray(np.full(16, 0.2))
    Tsm = jnp.asarray(np.linspace(0.05, 0.5, 16))
    s_sm = np.asarray(
        _msh_matrix_gamma(jnp.ones(16), thsm, ksm, Tsm, M, 128, 128)
    )[:, 0, 0]
    e_sm = np.asarray(
        _msh_matrix_gamma_exact(jnp.ones(16), thsm, ksm, Tsm, M, 128)
    )[:, 0, 0]
    x_lo = np.minimum(1e-5, 1e-5 * np.asarray(Tsm))
    pred = sps.gammainc(0.12, x_lo / 0.2) * sps.gammainc(
        0.12, np.asarray(Tsm) / 0.2
    )
    delta = np.abs(e_sm - s_sm)
    assert np.all(delta > 0.5 * pred), (delta, pred)
    assert np.all(delta < 2.0 * pred), (delta, pred)


def test_coal_ints_exact_matches_quadrature_path():
    """Full get_coal_ints with f2_exact vs the default Simpson path on
    consistent random two-mode states — trajectory-level equivalence of the
    fast path is separately golden-gated (tests/test_golden.py)."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    kwargs = dict(dist_thresholds=(5e-10, np.inf), norms=(1e6, 1e-9))
    data_s = build_coalescence_data(spec, ker, **kwargs)
    data_e = build_coalescence_data(spec, ker, f2_exact=True, **kwargs)
    rng = np.random.default_rng(13)
    B = 256
    params = np.stack(
        [
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                 rng.uniform(0.5, 5.0, B)],
                -1,
            )
            for _ in spec.families
        ],
        axis=1,
    )
    mom = pd.get_moments(spec, jnp.asarray(params))
    p = pd.params_from_moments(spec, mom)
    a = np.asarray(get_coal_ints(data_s, p))
    b = np.asarray(get_coal_ints(data_e, p))
    scale = np.abs(a).max(axis=0, keepdims=True)
    rel = np.abs(a - b) / (np.abs(a) + 1e-6 * scale)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert np.quantile(rel, 0.99) < 5e-3, np.quantile(rel, 0.99)


def test_lognormal_window_rule_proven_bound():
    """The density-recentered GL window rule for lognormal F2
    (coalescence._msh_matrix_lognormal_window, the proven-bound fast path)
    against adaptive scipy quadrature of the same integral:
    worst-case error < 1e-3 of the clamp scale M_p·M_q over the reachable
    (μ, σ, T) domain at 16 nodes (measured 4.0e-4 over a 200-case sweep;
    this test pins a fixed 60-case subgrid). The reference-shaped log grid
    it replaces measures ~0.87 worst case on the same domain at 12 Gauss
    nodes (σ small → the bulk occupies a sliver of the [1e-5·T, T]
    interval), documented here, not asserted."""
    from scipy import integrate as si
    from scipy import special as sps

    from cloudy_tpu.coalescence import _msh_matrix_lognormal_window

    M = 4

    def truth(mu, sig, T, p, q):
        c = mu + q * sig**2

        def integrand(u):
            x = np.exp(u)
            rem = T - x
            if rem <= 0:
                return 0.0
            z = (np.log(rem) - c) / (sig * np.sqrt(2))
            pm = np.exp(q * mu + 0.5 * q * q * sig * sig) * 0.5 * (
                1 + sps.erf(z)
            )
            return (
                np.exp(p * u - (u - mu) ** 2 / (2 * sig**2))
                / (sig * np.sqrt(2 * np.pi))
                * pm
            )

        lo, hi = mu - 30 * sig, np.log(T)
        pts = [mu + k * sig for k in (-5, -2, 0, 2, 5) if lo < mu + k * sig < hi]
        return si.quad(integrand, lo, hi, points=pts, limit=400)

    rng = np.random.default_rng(11)
    worst = 0.0
    for _ in range(60):
        mu = rng.uniform(-8, 2.5)
        sig = rng.uniform(0.15, 1.5)
        if rng.random() < 0.5:
            T = np.exp(rng.uniform(-3, 1.6))  # fixed normalized thresholds
        else:
            T = np.exp(mu + sig * rng.uniform(0.0, 2.6))  # moving percentiles
        got = np.asarray(
            _msh_matrix_lognormal_window(
                jnp.asarray([1.0]), jnp.asarray([mu]), jnp.asarray([sig]),
                jnp.asarray([T]), M, 16,
            )
        )[0]
        for p in range(M):
            for q in range(p, M):
                sc = np.exp(p * mu + 0.5 * p * p * sig**2) * np.exp(
                    q * mu + 0.5 * q * q * sig**2
                )
                t_, e_ = truth(mu, sig, T, p, q)
                if e_ > 1e-10 * sc:
                    continue  # truth unconverged — skip the point
                worst = max(worst, abs(got[p, q] - t_) / sc)
    assert worst < 1e-3, worst


def test_fast_tier_shorthand():
    """`fast_tier=True` selects the full proven-bound production set."""
    spec = SpectrumSpec((Family.LOGNORMAL, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    d = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), fast_tier=True
    )
    assert d.f2_exact and d.gammainc_gl_nodes == 12
    assert d.lognorm_gl_nodes == 16 and d.gammainc_iters == 12
    # explicit kwargs win
    d2 = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), fast_tier=True,
        lognorm_gl_nodes=12,
    )
    assert d2.lognorm_gl_nodes == 12
