"""The fused row body (ops.row_coalescence) and its Triton kernels
(ops.triton_coalescence, in the Pallas interpreter here) vs the XLA einsum
path and the AoS reference step."""

import numpy as np
import jax.numpy as jnp
import pytest

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import distributions as pd
from cloudy_tpu import kernels as K
from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints
from cloudy_tpu.ops import row_coalescence as pc
from cloudy_tpu.ops import triton_coalescence as tc


def _setup(families, thresholds):
    spec = SpectrumSpec(families)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, thresholds, norms=(1e6, 1e-9))
    return spec, data


def _coal_fn(data, **kw):
    """The RHS-only Triton kernel in the Pallas interpreter."""
    return tc.make_triton_coal_fn(data, block_cols=64, interpret=True, **kw)


def _random_moments(spec, B, seed=0):
    # consistent random states: draw distribution parameters, map to moments
    rng = np.random.default_rng(seed)
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
    return np.asarray(pd.get_moments(spec, jnp.asarray(params)))


def test_pallas_supported_everything_xla_accepts():
    """The fused kernel covers every configuration the XLA
    path accepts — all four families in any position, fixed AND moving
    thresholds."""
    for fams in [
        (Family.GAMMA, Family.GAMMA),
        (Family.LOGNORMAL, Family.GAMMA),
        (Family.GAMMA, Family.LOGNORMAL),
        (Family.MONODISPERSE, Family.GAMMA),
        (Family.EXPONENTIAL, Family.LOGNORMAL, Family.GAMMA),
    ]:
        spec, data = _setup(fams, (5e-10,) * (len(fams) - 1) + (np.inf,))
        assert pc.pallas_supported(data)
    # moving thresholds
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (0.9, 1.0), norms=(1e6, 1e-9), moving=True
    )
    assert pc.pallas_supported(data)


def test_pallas_matches_xla_two_gamma():
    spec, data = _setup((Family.GAMMA, Family.GAMMA), (5e-10, np.inf))
    B = 256
    mom = jnp.asarray(_random_moments(spec, B))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_pallas_matches_xla_exp_gamma():
    spec, data = _setup((Family.EXPONENTIAL, Family.GAMMA), (5e-10, np.inf))
    B = 128
    mom = jnp.asarray(_random_moments(spec, B))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_pallas_degenerate_columns():
    spec, data = _setup((Family.GAMMA, Family.GAMMA), (5e-10, np.inf))
    mom = np.zeros((128, 6))
    mom[0] = [1e2, 1e1, 2e0, 0, 0, 0]  # one active column, empty mode 2
    fn = _coal_fn(data)
    got = np.asarray(fn(jnp.asarray(mom)))
    want = np.asarray(
        get_coal_ints(data, pd.params_from_moments(spec, jnp.asarray(mom)))
    )
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got[1:], 0.0)


@pytest.mark.slow
def test_pallas_gauss_rule_close_to_reference_rule():
    """The Gauss fast-path quadrature must agree with the reference-grid
    Simpson evaluation to well below the physics tolerance."""
    spec, data = _setup((Family.GAMMA, Family.GAMMA), (5e-10, np.inf))
    B = 128
    mom = jnp.asarray(_random_moments(spec, B, seed=5))
    ref = _coal_fn(data)
    fast = _coal_fn(
        data, quad_rule="gauss", gauss_nodes=16
    )
    a = np.asarray(ref(mom))
    b = np.asarray(fast(mom))
    scale = np.abs(a).max(axis=0, keepdims=True)
    rel = np.abs(a - b) / (np.abs(a) + 1e-6 * scale)
    assert np.median(rel) < 1e-4
    assert np.quantile(rel, 0.99) < 5e-3


@pytest.mark.slow
def test_pallas_matches_xla_lognormal_thresholded():
    """Lognormal as a THRESHOLDED (non-last) mode: in-kernel Φ partial
    moments (erf via gammainc) vs the XLA path."""
    spec, data = _setup((Family.LOGNORMAL, Family.GAMMA), (5e-10, np.inf))
    B = 128
    rng = np.random.default_rng(7)
    params = np.stack(
        [
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(-2.0, 1.0, B),
                 rng.uniform(0.3, 1.2, B)],
                -1,
            ),
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                 rng.uniform(0.5, 5.0, B)],
                -1,
            ),
        ],
        axis=1,
    )
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_pallas_matches_xla_monodisperse_thresholded():
    """Monodisperse thresholded mode: closed-form F2 vs the XLA path, both
    sides of the theta < T/2 split."""
    spec, data = _setup((Family.MONODISPERSE, Family.GAMMA), (5e-10, np.inf))
    B = 128
    rng = np.random.default_rng(11)
    # thresholds normalize to 0.5; put mono theta on both sides of T/2 = 0.25
    params = np.stack(
        [
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(0.05, 0.6, B),
                 np.zeros(B)],
                -1,
            ),
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                 rng.uniform(0.5, 5.0, B)],
                -1,
            ),
        ],
        axis=1,
    )
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.slow
def test_pallas_matches_xla_three_mode_mixed():
    """exp + lognormal + gamma, two thresholded modes of different families
    in one kernel."""
    spec = SpectrumSpec((Family.EXPONENTIAL, Family.LOGNORMAL, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (2e-10, 5e-10, np.inf), norms=(1e6, 1e-9)
    )
    assert pc.pallas_supported(data)
    B = 128
    rng = np.random.default_rng(13)
    params = np.stack(
        [
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(0.02, 0.5, B),
                 np.zeros(B)],
                -1,
            ),
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(-2.0, 0.5, B),
                 rng.uniform(0.3, 1.0, B)],
                -1,
            ),
            np.stack(
                [rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                 rng.uniform(0.5, 5.0, B)],
                -1,
            ),
        ],
        axis=1,
    )
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize(
    "families",
    [
        (Family.GAMMA, Family.GAMMA),
        pytest.param((Family.EXPONENTIAL, Family.GAMMA),
                     marks=pytest.mark.slow),
        pytest.param((Family.LOGNORMAL, Family.GAMMA),
                     marks=pytest.mark.slow),
    ],
)
def test_pallas_matches_xla_moving_threshold(families):
    """MovingThreshold: per-column percentile thresholds (Newton gammainc
    inversion for gamma, closed forms for exp/lognormal) and the quadrature
    grid built in-kernel, vs the XLA path (reference Coalescence.jl:152-185)."""
    spec = SpectrumSpec(families)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (0.9, 1.0), norms=(1e6, 1e-9), moving=True
    )
    B = 64
    rng = np.random.default_rng(17)
    cols = []
    for fam in families:
        if fam == Family.LOGNORMAL:
            cols.append(
                np.stack(
                    [rng.uniform(10, 200, B), rng.uniform(-2.0, 0.5, B),
                     rng.uniform(0.3, 1.0, B)],
                    -1,
                )
            )
        else:
            cols.append(
                np.stack(
                    [rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                     rng.uniform(0.5, 5.0, B)],
                    -1,
                )
            )
    params = np.stack(cols, axis=1)
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_pallas_matches_xla_moving_threshold_fast_inverse():
    """MovingThreshold at the proven-bound fast tier (gammainc_gl_nodes > 0
    ⇒ in-kernel Halley/GL percentile inverse): the Pallas
    kernel and the XLA path run the SAME fast inversion arithmetic — tight
    parity — and both stay within the pinned inverse bound of the
    reference-parity (32-Newton × 128-iteration) moving path."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data_fast = build_coalescence_data(
        spec, ker, (0.9, 1.0), norms=(1e6, 1e-9), moving=True,
        f2_exact=True, gammainc_gl_nodes=12,
    )
    data_ref = build_coalescence_data(
        spec, ker, (0.9, 1.0), norms=(1e6, 1e-9), moving=True, f2_exact=True
    )
    B = 64
    rng = np.random.default_rng(23)
    params = np.stack(
        [np.stack([rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                   rng.uniform(0.5, 5.0, B)], -1) for _ in range(2)],
        axis=1,
    )
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    p = pd.params_from_moments(spec, mom)

    xla_fast = np.asarray(get_coal_ints(data_fast, p))
    got = np.asarray(
        _coal_fn(data_fast)(mom)
    )
    np.testing.assert_allclose(got, xla_fast, rtol=1e-9, atol=1e-12)

    # fast vs reference-parity inversion: the 2e-5 threshold bound
    # propagates through F2 at far below golden-gate tolerance
    xla_ref = np.asarray(get_coal_ints(data_ref, p))
    scale = np.abs(xla_ref).max(axis=0, keepdims=True)
    rel = np.abs(xla_fast - xla_ref) / (np.abs(xla_ref) + 1e-6 * scale)
    assert np.quantile(rel, 0.99) < 1e-3, np.quantile(rel, 0.99)


@pytest.mark.parametrize("moving", [False, True])
def test_pallas_matches_xla_lognormal_window_rule(moving):
    """The lognormal density-recentered window rule (lognorm_gl_nodes > 0,
    the proven-bound fast path): Pallas in-kernel window
    construction equals the XLA `_msh_matrix_lognormal_window` path, for
    fixed AND moving (per-column percentile) thresholds."""
    spec = SpectrumSpec((Family.LOGNORMAL, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    thr = (0.9, 1.0) if moving else (5e-10, np.inf)
    data = build_coalescence_data(
        spec, ker, thr, norms=(1e6, 1e-9), moving=moving,
        f2_exact=True, gammainc_gl_nodes=12, lognorm_gl_nodes=16,
    )
    B = 64
    rng = np.random.default_rng(37)
    params = np.stack(
        [
            np.stack([rng.uniform(10, 200, B), rng.uniform(-2.0, 0.5, B),
                      rng.uniform(0.3, 1.2, B)], -1),
            np.stack([rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                      rng.uniform(0.5, 5.0, B)], -1),
        ],
        axis=1,
    )
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    p = pd.params_from_moments(spec, mom)
    want = np.asarray(get_coal_ints(data, p))
    got = np.asarray(
        _coal_fn(data)(mom)
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_sedi_flux_fast_gamma_ratio_bound():
    """The fast-tier sedimentation ladder (gamma_ratio base) stays within
    1e-6 relative of the reference-parity lgamma-pair ladder."""
    from cloudy_tpu.ops.row_coalescence import _sedi_flux_rows
    from cloudy_tpu.sedimentation import normalized_velocity

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    B = 64
    rng = np.random.default_rng(29)
    vel_n = normalized_velocity(((50.0, 1.0 / 6.0),), (1e6, 1e-9))
    params = [
        tuple(
            jnp.asarray(v[None], jnp.float64)
            for v in (rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                      rng.uniform(0.02, 10.0, B))
        )
        for _ in range(2)
    ]
    ref = _sedi_flux_rows(spec, params, vel_n, jnp.float64, fast_ratio=False)
    fast = _sedi_flux_rows(spec, params, vel_n, jnp.float64, fast_ratio=True)
    for r, f in zip(ref, fast):
        np.testing.assert_allclose(
            np.asarray(f), np.asarray(r), rtol=1e-6
        )


@pytest.mark.slow
def test_pallas_moving_threshold_gauss_rule_close():
    """MovingThreshold fast path: in-kernel per-column Gauss grid stays close
    to the reference-rule evaluation."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (0.9, 1.0), norms=(1e6, 1e-9), moving=True
    )
    B = 64
    mom = jnp.asarray(_random_moments(spec, B, seed=19))
    ref = _coal_fn(data)
    fast = _coal_fn(
        data, quad_rule="gauss", gauss_nodes=16
    )
    a = np.asarray(ref(mom))
    b = np.asarray(fast(mom))
    scale = np.abs(a).max(axis=0, keepdims=True)
    rel = np.abs(a - b) / (np.abs(a) + 1e-6 * scale)
    assert np.median(rel) < 1e-4
    assert np.quantile(rel, 0.99) < 5e-3


@pytest.mark.parametrize(
    "families",
    [
        (Family.GAMMA, Family.GAMMA),
        (Family.EXPONENTIAL, Family.GAMMA),
        pytest.param((Family.GAMMA, Family.LOGNORMAL, Family.GAMMA),
                     marks=pytest.mark.slow),
    ],
)
def test_pallas_f2_exact_matches_xla_exact(families):
    """f2_exact (the closed-form gamma/exp autoconversion factorization —
    the bench fast path): fused kernel vs the XLA path, including a mixed
    spec where the lognormal mode keeps its quadrature grid while the
    gamma mode is gridless."""
    spec = SpectrumSpec(families)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    thresholds = (5e-10,) * (len(families) - 1) + (np.inf,)
    data = build_coalescence_data(
        spec, ker, thresholds, norms=(1e6, 1e-9), f2_exact=True
    )
    mom = jnp.asarray(_random_moments(spec, 128, seed=17))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.slow
def test_pallas_f2_exact_moving_threshold():
    """f2_exact composed with MovingThreshold (per-column percentile
    thresholds in-kernel, closed-form F2 at those thresholds)."""
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (0.9, 1.0), norms=(1e6, 1e-9), moving=True, f2_exact=True
    )
    mom = jnp.asarray(_random_moments(spec, 128, seed=19))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    fn = _coal_fn(data)
    got = np.asarray(fn(mom))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------------------
# whole SSPRK33 rainshaft step (clip + closure + coalescence + empty mask +
# sedimentation flux + upwind stencil + RK, on level-major rows)
# ---------------------------------------------------------------------------


def _rainshaft_state(spec, config, n_col, seed=23):
    """Ensemble state [n_col, nz, n_tot] with per-column variation, empty
    cells (the top-hat IC leaves most of the column zero) and a few
    hand-planted NEGATIVE moments to exercise the clipping."""
    from cloudy_tpu.models import rainshaft as rs

    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12][: spec.nprogmoms[0]])
    pad = np.zeros((config.nz, spec.n_tot - ic1.shape[1]))
    ic = np.concatenate([ic1, pad], axis=-1)
    state = np.tile(ic[None], (n_col, 1, 1))
    state *= np.linspace(0.5, 1.5, n_col)[:, None, None]
    state[0, config.nz // 2, 0] *= -1.0  # negative moment → must clip to 0
    state[1, config.nz // 2 + 1, :] = -1e-3  # whole level negative → empty
    return state


def _aos_reference_step(config, data, state):
    """One SSPRK33 step of the AoS XLA path (`make_rainshaft_rhs`)."""
    from cloudy_tpu import stepper
    from cloudy_tpu.models import rainshaft as rs

    rhs = rs.make_rainshaft_rhs(config, data)
    return np.asarray(
        stepper.ssprk33_step(rhs, state, jnp.asarray(0.0, state.dtype), config.dt)
    )


def _triton_step(data, config, block_cols=8, **kw):
    """The production whole-step kernel in the Pallas interpreter."""
    return tc.make_triton_rainshaft_step_fn(
        data, config.vel, config.norms, nz=config.nz, dz=config.dz,
        dt=config.dt, block_cols=block_cols, interpret=True, **kw,
    )


def _row_scaled_error(got, want):
    # row-scaled error, not elementwise rtol: the two paths are the same
    # arithmetic but XLA's FMA-fusion choices differ between the two
    # graphs, and a 1-ulp input difference at an `mm < eps` knife-edge
    # (near-empty levels seeded only by self-collision promotion, values
    # ~1e-20 of the row scale) flips the zero-structure on one side —
    # physically irrelevant, elementwise-relatively unbounded
    scale = np.abs(want).max(axis=(0, 1), keepdims=True)
    return (np.abs(got - want) / np.maximum(scale, 1e-300)).max()


@pytest.mark.slow
def test_fused_rhs_flux_rows_match_sedimentation():
    """The local RHS's flux rows equal the XLA `get_sedimentation_flux` of
    the clipped, normalized state — every family's fractional-moment
    ladder."""
    from cloudy_tpu import distributions as pdists_
    from cloudy_tpu.sedimentation import get_sedimentation_flux, normalized_velocity
    from cloudy_tpu.spec import get_moments_normalizing_factors

    spec = SpectrumSpec((Family.EXPONENTIAL, Family.LOGNORMAL, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    norms = (1e6, 1e-9)
    data = build_coalescence_data(spec, ker, (2e-10, 5e-10, np.inf), norms=norms)
    B = 128
    rng = np.random.default_rng(29)
    params = np.stack(
        [
            np.stack([rng.uniform(10, 200, B), rng.uniform(0.02, 0.5, B),
                      np.zeros(B)], -1),
            np.stack([rng.uniform(10, 200, B), rng.uniform(-2.0, 0.5, B),
                      rng.uniform(0.3, 1.0, B)], -1),
            np.stack([rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                      rng.uniform(0.5, 5.0, B)], -1),
        ],
        axis=1,
    )
    mom_n = np.array(pd.get_moments(spec, jnp.asarray(params)))
    mom_n[:5] = 0.0  # degenerate columns → zero flux on both paths
    mom_norms = get_moments_normalizing_factors(spec.nprogmoms, norms)
    mom_phys = jnp.asarray(mom_n * mom_norms)

    vel = ((50.0, 1.0 / 6.0), (3.0, 0.5))  # two power-law terms
    local, grids = pc.make_local_rhs(data, vel, norms)
    _, flux = local([mom_phys[:, o][None] for o in range(spec.n_tot)],
                    [jnp.asarray(g) for g in grids])
    got_flux = np.concatenate([np.asarray(f) for f in flux]).T

    vel_n = normalized_velocity(vel, norms)
    params_n = pdists_.params_from_moments(spec, jnp.asarray(mom_n))
    want_flux = np.asarray(
        get_sedimentation_flux(spec, params_n, vel_n)
    ) * np.asarray(mom_norms)
    np.testing.assert_allclose(got_flux, want_flux, rtol=1e-9, atol=1e-300)
    np.testing.assert_array_equal(got_flux[:5], 0.0)


@pytest.mark.slow
def test_fused_rhs_soa_step_matches_aos_step():
    """A full SSPRK33 step in the level-major layout (the production pod
    step) equals the AoS `make_rainshaft_rhs` step at the reference tier,
    including clipped negatives and an emptied level."""
    from cloudy_tpu.models import rainshaft as rs

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9))
    config = rs.RainshaftConfig(spec=spec, nz=16, zmax=3000.0, norms=(1e6, 1e-9))
    state = jnp.asarray(_rainshaft_state(spec, config, 8))

    want = _aos_reference_step(config, data, state)
    step = _triton_step(data, config)
    got = np.asarray(rs.from_soa(step(rs.to_soa(state))))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-300)


def test_pallas_lognormal_fast_special_functions():
    """The proven-bound fast special-function set (gammainc_gl_nodes > 0 ⇒
    GL gammainc + rational erf) stays consistent between the XLA and Pallas
    paths AND within the erf/gammainc bounds of the parity evaluation."""
    spec = SpectrumSpec((Family.LOGNORMAL, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data_fast = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), gammainc_gl_nodes=12
    )
    data_ref = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9)
    )
    B = 128
    rng = np.random.default_rng(31)
    params = np.stack(
        [
            np.stack([rng.uniform(10, 200, B), rng.uniform(-2.0, 1.0, B),
                      rng.uniform(0.3, 1.2, B)], -1),
            np.stack([rng.uniform(10, 200, B), rng.uniform(0.05, 5.0, B),
                      rng.uniform(0.5, 5.0, B)], -1),
        ],
        axis=1,
    )
    mom = jnp.asarray(np.asarray(pd.get_moments(spec, jnp.asarray(params))))
    p = pd.params_from_moments(spec, mom)

    xla_fast = np.asarray(get_coal_ints(data_fast, p))
    got = np.asarray(
        _coal_fn(data_fast)(mom)
    )
    # same algorithm on both sides → tight
    np.testing.assert_allclose(got, xla_fast, rtol=1e-9, atol=1e-12)

    # vs the reference-parity special functions: within the 1.5e-7 erf /
    # 2.6e-7 gammainc bounds propagated through the quadrature (scaled)
    xla_ref = np.asarray(get_coal_ints(data_ref, p))
    scale = np.abs(xla_ref).max(axis=0, keepdims=True)
    rel = np.abs(xla_fast - xla_ref) / (np.abs(xla_ref) + 1e-6 * scale)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)


@pytest.mark.parametrize(
    "families,moving",
    [
        ((Family.GAMMA, Family.GAMMA), False),
        pytest.param((Family.LOGNORMAL, Family.GAMMA), False,
                     marks=pytest.mark.slow),
        pytest.param((Family.EXPONENTIAL, Family.GAMMA), False,
                     marks=pytest.mark.slow),
        pytest.param((Family.MONODISPERSE, Family.GAMMA), False,
                     marks=pytest.mark.slow),
        pytest.param((Family.GAMMA, Family.GAMMA), True, marks=pytest.mark.slow),
    ],
)
def test_pallas_whole_step_matches_xla_orchestrated_step(families, moving):
    """The whole-SSPRK33-step kernel (3 local RHS evaluations per level, the
    level loop carrying the stage fluxes of the level above, RK
    combinations) equals the AoS reference-semantics step (`make_rainshaft_rhs` + SSPRK33). Covers
    the two-gamma path, a lognormal thresholded mode (Φ partial moments),
    exponential and monodisperse modes, and MovingThreshold (per-column,
    per-RK-stage percentile thresholds via Newton gammaincinv)."""
    from cloudy_tpu.models import rainshaft as rs

    spec = SpectrumSpec(families)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    thresholds = (0.9, 1.0) if moving else (5e-10, np.inf)
    data = build_coalescence_data(
        spec, ker, thresholds, norms=(1e6, 1e-9), moving=moving
    )
    config = rs.RainshaftConfig(spec=spec, nz=16, zmax=3000.0, norms=(1e6, 1e-9))
    state_aos = _rainshaft_state(spec, config, 8)
    # seed the SECOND mode too: with it empty, its rows hold only
    # self-collision promotion dust and the row-scaled comparison would be
    # of knife-edge noise
    ic2 = rs.initial_condition(config.z, [1e7, 1e-3, 2e-13])
    state_aos[:, :, spec.offsets[1]:] += ic2[None]
    state_aos[1, config.nz // 2 + 1, :] = -1e-3  # re-plant the empty level
    state = jnp.asarray(state_aos)

    want = _aos_reference_step(config, data, state)
    step = _triton_step(data, config)
    got = np.asarray(rs.from_soa(step(rs.to_soa(state))))
    err = _row_scaled_error(got, want)
    assert err < 1e-9, err


@pytest.mark.parametrize("variant", ["fixed2gamma", "moving", "lognorm"])
def test_production_step_matches_aos_reference(variant):
    """The production pod step (each harness POD_VARIANTS configuration at
    its fast tier, f32) against the f64 AoS reference step on the same
    state — the CPU counterpart of chip_smoke.py's parity phase: within
    f32 rounding after one step, and the f32 graph stays f32 with x64 on."""
    from cloudy_tpu import harness
    from cloudy_tpu.models import rainshaft as rs

    spec, data = harness.pod_data(variant)
    config = harness.pod_config(spec, nz=16)
    ic = harness.pod_initial_condition(config, second_mode=True)
    y32 = harness.ensemble_state(ic, 8, "fused", spread=(0.5, 1.5))
    assert y32.dtype == jnp.float32
    step = _triton_step(data, config)
    got = step(y32)
    assert got.dtype == jnp.float32

    y64 = harness.ensemble_state(
        ic, 8, "reference", spread=(0.5, 1.5), dtype=jnp.float64
    )
    want = _aos_reference_step(config, data, y64)
    err = _row_scaled_error(np.asarray(rs.from_soa(got), np.float64), want)
    assert err < 1e-5, err


def test_whole_step_kernel_scale_equals_scaled_tensor():
    """The `kernel_scale` operand of the whole step (the calibration hook):
    scaling the coalescence tendency by `s` is EXACTLY equivalent to
    building the CoalescenceData from the kernel tensor scaled by `s` — the
    Q/R/S assembly is linear in the kernel tensor and the F2/msh matrices
    are kernel-independent."""
    from cloudy_tpu.models import rainshaft as rs

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    s = 1.7
    ker_s = K.CoalescenceTensor(s * ker.array)
    norms = (1e6, 1e-9)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=norms, fast_tier=True
    )
    data_s = build_coalescence_data(
        spec, ker_s, (5e-10, np.inf), norms=norms, fast_tier=True
    )
    config = rs.RainshaftConfig(spec=spec, nz=16, zmax=3000.0, norms=norms)
    state_aos = np.tile(
        np.concatenate(
            [
                rs.initial_condition(config.z, [1e8, 1e-2, 2e-12]),
                rs.initial_condition(config.z, [1e7, 1e-3, 2e-13]),
            ],
            axis=-1,
        )[None],
        (8, 1, 1),
    ) * np.linspace(0.6, 1.4, 8)[:, None, None]
    state = rs.to_soa(jnp.asarray(state_aos))

    step_scaled = _triton_step(data, config, kernel_scale=True)
    step_tensor = _triton_step(data_s, config)

    got = np.asarray(step_scaled(state, s))
    want = np.asarray(step_tensor(state))
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) / np.maximum(scale, 1e-300)).max() < 1e-9


def test_triton_step_pads_columns_and_matches_blocking():
    """Column counts that are not a multiple of block_cols are padded with
    empty columns and sliced off: 12 columns in blocks of 8 (one padded
    block) give exactly the 12 columns of blocks of 4, and the AoS
    reference step."""
    from cloudy_tpu import harness
    from cloudy_tpu.models import rainshaft as rs

    spec, data = harness.pod_data("fixed2gamma")
    config = harness.pod_config(spec, nz=8)
    ic = harness.pod_initial_condition(config, second_mode=True)
    y = harness.ensemble_state(ic, 12, "fused", spread=(0.5, 1.5),
                               dtype=jnp.float64)
    padded = np.asarray(_triton_step(data, config, block_cols=8)(y))
    exact = np.asarray(_triton_step(data, config, block_cols=4)(y))
    assert padded.shape == y.shape
    np.testing.assert_array_equal(padded, exact)
    want = _aos_reference_step(config, data, rs.from_soa(y))
    assert _row_scaled_error(np.asarray(rs.from_soa(padded)), want) < 1e-9
    with pytest.raises(ValueError):
        _triton_step(data, config, block_cols=12)


def test_triton_coal_fn_pads_quadrature_grid():
    """Quadrature grids are padded to a power of two for Triton with
    zero-weight copies of the last node: the reference rule's 76-point
    Simpson grid becomes 128 points and a 24-node Gauss grid 32, and the
    padded kernel still equals the XLA path."""
    spec, data = _setup((Family.GAMMA, Family.GAMMA), (5e-10, np.inf))
    for kw, (g, g2) in [({}, (76, 128)),
                        (dict(quad_rule="gauss", gauss_nodes=24), (24, 32))]:
        _, grids = pc._make_coal_body(data, **kw)
        assert [x.shape for x in grids] == [(2, g2)]
        assert np.all(grids[0][1, g:] == 0.0)
        assert np.all(grids[0][0, g:] == grids[0][0, g - 1])
    mom = jnp.asarray(_random_moments(spec, 40, seed=3))
    want = np.asarray(get_coal_ints(data, pd.params_from_moments(spec, mom)))
    got = np.asarray(tc.make_triton_coal_fn(data, block_cols=16,
                                            interpret=True)(mom))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
