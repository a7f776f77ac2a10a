"""1-D rainshaft: pure-sedimentation semi-analytic anchor + structure tests
(reference rainshaft_helpers.jl)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K
from cloudy_tpu.coalescence import build_coalescence_data
from cloudy_tpu.models import rainshaft as rs


def test_initial_condition_top_hat():
    config = rs.RainshaftConfig(spec=SpectrumSpec((Family.GAMMA,)), nz=64, zmax=3000.0)
    ic = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    assert ic.shape == (64, 3)
    frac = (ic[:, 0] > 0).mean()
    assert 0.2 < frac < 0.3  # quarter of the column
    # nonzero exactly in [0.5, 0.75) zmax
    z = config.z
    on = ic[:, 0] > 0
    assert np.all(z[on] >= 0.5 * z.max() - config.dz)
    assert np.all(z[on] < 0.75 * z.max())


def test_mass_flux_down_and_out():
    """Pure sedimentation: total mass decreases only through the bottom
    boundary; mass moves downward."""
    spec = SpectrumSpec((Family.GAMMA,))
    config = rs.RainshaftConfig(
        spec=spec, nz=32, zmax=3000.0, t_end=200.0, dt=1.0, save_every=20
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, None))
    ic = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ts, ys = rs.run_rainshaft(config, rhs, ic)
    ys = np.asarray(ys)
    assert np.all(np.isfinite(ys))
    mass = ys[..., 1].sum(axis=-1)
    assert np.all(np.diff(mass) <= 1e-12)  # monotone nonincreasing
    # center of mass moves down
    z = config.z

    def com(y):
        w = y[:, 1]
        return (z * w).sum() / w.sum()

    assert com(ys[-1]) < com(ys[0])


def test_pure_sedimentation_vs_semianalytic():
    """Moment profiles vs the characteristics solution (reference
    analytical_sol, rainshaft_helpers.jl:102-125) at an early time, before
    upwind diffusion dominates."""
    spec = SpectrumSpec((Family.EXPONENTIAL,))
    # work in normalized units: norms (1,1), v = 1 + m^(1/6) scale-free
    config = rs.RainshaftConfig(
        spec=spec,
        nz=60,
        zmax=3000.0,
        norms=(1.0, 1.0),
        vel=((10.0, 0.0), (10.0, 1.0 / 6.0)),
        t_end=20.0,
        dt=0.5,
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, None))
    ic = rs.initial_condition(config.z, [1.0, 1.0])
    ts, ys = rs.run_rainshaft(config, rhs, ic)
    got = np.asarray(ys)[-1]
    want = rs.analytical_sol_sedimentation(
        config, Family.EXPONENTIAL, ic, (10.0, 10.0), 20.0
    )
    # compare integrated moments (upwind smears the sharp edges; integrals
    # converge much faster than pointwise profiles)
    for m in range(2):
        assert np.trapezoid(got[:, m], config.z) == pytest.approx(
            np.trapezoid(want[:, m], config.z), rel=0.1
        )
    # profile correlation (shape agreement)
    for m in range(2):
        c = np.corrcoef(got[:, m], want[:, m])[0, 1]
        assert c > 0.9


def test_rainshaft_with_coalescence_conserves_mass_except_outflow():
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(
        spec=spec, nz=24, zmax=3000.0, norms=norms, t_end=30.0, dt=1.0, save_every=10
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, data))
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    ts, ys = rs.run_rainshaft(config, rhs, ic)
    ys = np.asarray(ys)
    assert np.all(np.isfinite(ys))
    # coalescence conserves mass pointwise; only sedimentation outflow at the
    # bottom may remove it. Compare total-mass change to the integrated
    # bottom flux bound.
    mass = (ys[..., 1] + ys[..., 4]).sum(axis=-1)
    assert np.all(np.diff(mass) <= 1e-9 * mass[0])


def test_column_ensemble_batching():
    """[n_col, nz, n_tot] batch equals per-column runs."""
    spec = SpectrumSpec((Family.GAMMA,))
    config = rs.RainshaftConfig(spec=spec, nz=16, zmax=3000.0, t_end=5.0, dt=1.0)
    rhs = jax.jit(rs.make_rainshaft_rhs(config, None))
    ic = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    batch = jnp.asarray(np.stack([ic, ic * 0.5]))
    out = np.asarray(rhs(batch, 0.0))
    single0 = np.asarray(rhs(jnp.asarray(ic), 0.0))
    np.testing.assert_allclose(out[0], single0, rtol=1e-13)


def test_rainshaft_coal_fn_matches_xla_path():
    """The `coal_fn` hook (the RHS-only Triton kernel, in the Pallas
    interpreter) reproduces the XLA coalescence path inside the full
    rainshaft RHS."""
    from cloudy_tpu.ops import triton_coalescence as tc

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    config = rs.RainshaftConfig(spec=spec, nz=8, zmax=3000.0, norms=norms)

    rhs_xla = rs.make_rainshaft_rhs(config, data)
    fn = tc.make_triton_coal_fn(data, block_cols=16, interpret=True)
    rhs_pallas = rs.make_rainshaft_rhs(config, data, coal_fn=fn)

    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, 0.5 * ic1], axis=-1)
    state = jnp.asarray(np.stack([ic, 2.0 * ic]))  # [2, nz, n_tot]

    want = np.asarray(rhs_xla(state, 0.0))
    got = np.asarray(rhs_pallas(state, 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
