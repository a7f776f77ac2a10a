"""Golden-trajectory validation: the BASELINE.md "moment trajectories
allclose" contract, pinned four ways.

1. Regression: the f64 CPU reference-parity path reproduces the stored
   trajectories (tests/golden/*.npz) — any physics change shows up here.
2. Independence: the C++ oracle (native/cloudy_golden.cc, its own Simpson/
   incomplete-gamma/closure code) integrated with the same SSPRK33 stages in
   plain numpy reproduces the stored trajectories — the analogue of the
   reference's independent dense Q/R/S reimplementation
   (test_Sources_correctness.jl:87-169), lifted to full trajectories.
3. f32 stays allclose to f64 over the full run (the production dtype).
4. The fused row body's fast path (Gauss-Legendre quadrature rule)
   stays allclose over the full run — the same kernel bench.py times on
   the GPU, here in the Pallas interpreter.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest

from cloudy_tpu import harness, stepper
from cloudy_tpu.spec import get_moments_normalizing_factors

from _golden_cases import CASES, load_golden


# rainshaft_128 re-integrates the full nz=128 × 300-step f64 scenario live —
# minutes of CPU; the default tier keeps the same-physics nz=32 gate
# (rainshaft_small) and defers the flagship size to the slow tier.
@pytest.mark.parametrize(
    "name",
    [
        pytest.param(n, marks=pytest.mark.slow) if n == "rainshaft_128" else n
        for n in sorted(CASES)
    ],
)
def test_f64_regression(name):
    ts_g, ys_g = load_golden(name)
    ts, ys = CASES[name]()
    np.testing.assert_allclose(ts, ts_g, rtol=1e-12)
    np.testing.assert_allclose(ys, ys_g, rtol=1e-9, atol=1e-300)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize(
    "name", ["box_single_gamma_golovin", "box_exp_gamma_mixture"]
)
def test_cpp_oracle_trajectory(name):
    """Numpy SSPRK33 over the native C++ coalescence oracle reproduces the
    stored JAX trajectory — two fully independent implementations of the
    whole step agree along the entire run."""
    from cloudy_tpu import native

    sc = harness.SCENARIOS[name]()
    data, config, spec = sc["data"], sc["config"], sc["spec"]
    norms = np.asarray(
        get_moments_normalizing_factors(spec.nprogmoms, config.norms)
    )

    def rhs(m_phys):
        mn = (m_phys / norms)[None]
        return native.coal_ints_golden(data, mn)[0] * norms

    y = np.asarray(sc["mom0"], np.float64)
    dt = config.dt
    traj = [y]
    for _ in range(int(round(config.t_end / dt))):
        u1 = y + dt * rhs(y)
        u2 = 0.75 * y + 0.25 * (u1 + dt * rhs(u1))
        y = y / 3.0 + 2.0 / 3.0 * (u2 + dt * rhs(u2))
        traj.append(y)
    traj = np.stack(traj)

    _, ys_g = load_golden(name)
    np.testing.assert_allclose(traj, ys_g, rtol=1e-6, atol=1e-300)


@pytest.mark.parametrize(
    "name", ["box_single_gamma_golovin", "box_exp_gamma_mixture"]
)
def test_f32_trajectory_allclose(name):
    """The f32 production path tracks the stored f64 trajectory."""
    sc = harness.SCENARIOS[name]()
    config = sc["config"]
    from cloudy_tpu.models import box
    from cloudy_tpu.coalescence import get_coal_ints
    from cloudy_tpu import distributions as pdists

    rhs = box.make_box_rhs(config, coal_data=sc["data"])
    y0 = jnp.asarray(sc["mom0"], jnp.float32)
    n_steps = int(round(config.t_end / config.dt))
    ts, ys = stepper.integrate(rhs, y0, 0.0, config.dt, n_steps)
    assert ys.dtype == jnp.float32

    _, ys_g = load_golden(name)
    scale = np.abs(ys_g).max(axis=0)  # per-moment scale (orders span ~1e24)
    err = np.abs(np.asarray(ys, np.float64) - ys_g) / scale
    assert err.max() < 2e-3, err.max()


def _bench_config():
    """The exact fast-path configuration bench.py runs on the GPU, imported from
    bench.py itself so the gated configuration cannot drift from the benched
    one (the headline number must be measured at a tested accuracy point)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec_ = importlib.util.spec_from_file_location("bench", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return dict(
        gauss_nodes=mod.BENCH_GAUSS_NODES,
        gammainc_iters=mod.BENCH_GAMMAINC_ITERS,
        f2_exact=mod.BENCH_F2_EXACT,
        gammainc_gl_nodes=mod.BENCH_GL_NODES,
    )


@pytest.mark.parametrize(
    "cfg",
    # gauss16 is an ablation rule (production is exact-F2); slow tier
    [pytest.param("gauss16", marks=pytest.mark.slow), "gauss-fallback",
     "bench"],
)
def test_pallas_gauss_trajectory_allclose(cfg):
    """Full trajectory through the RHS-only Triton kernel (Pallas
    interpreter)
    stays within 1e-3 of the stored reference-parity trajectory — at the
    high-accuracy Gauss-16 point, at the Gauss-12 quadrature fallback, AND
    at the exact configuration bench.py measures on the GPU (imported from
    bench.py itself so the gated configuration cannot drift)."""
    from cloudy_tpu.ops import triton_coalescence as tc

    sc = harness.SCENARIOS["box_exp_gamma_mixture"]()
    data, config, spec = sc["data"], sc["config"], sc["spec"]
    norms = jnp.asarray(
        get_moments_normalizing_factors(spec.nprogmoms, config.norms)
    )
    if cfg == "bench":
        kw = _bench_config()
    elif cfg == "gauss-fallback":
        kw = dict(_bench_config(), f2_exact=False)
    else:
        kw = dict(gauss_nodes=16, gammainc_iters=None, f2_exact=False)
    fn = tc.make_triton_coal_fn(
        data, block_cols=8, interpret=True, quad_rule="gauss", **kw
    )

    def rhs(mom, t):
        del t
        return fn(mom / norms) * norms

    y0 = jnp.tile(jnp.asarray(sc["mom0"])[None], (8, 1))
    n_steps = int(round(config.t_end / config.dt))
    _, ys = stepper.integrate(rhs, y0, 0.0, config.dt, n_steps)
    ys = np.asarray(ys)[:, 0, :]

    _, ys_g = load_golden("box_exp_gamma_mixture")
    scale = np.abs(ys_g).max(axis=0)
    err = np.abs(ys - ys_g) / scale
    assert err.max() < 1e-3, err.max()


@pytest.mark.slow
def test_rainshaft_128_pallas_coal_fn_trajectory_allclose():
    """Flagship-scale BASELINE configs[3] (nz = 128, 300 s) through the fused
    Pallas coalescence hook (`make_rainshaft_rhs(coal_fn=...)`, the pod
    workload's production path) stays within 1e-3 of the stored f64
    reference-parity trajectory."""
    import jax

    from cloudy_tpu.models import rainshaft as rs
    from cloudy_tpu.ops import triton_coalescence as tc

    sc = harness.SCENARIOS["rainshaft_128"]()
    data, config = sc["data"], sc["config"]
    coal = tc.make_triton_coal_fn(
        data, block_cols=128, interpret=True, quad_rule="gauss",
        **_bench_config(),
    )
    rhs = jax.jit(rs.make_rainshaft_rhs(config, data, coal_fn=coal))
    ts, ys = rs.run_rainshaft(config, rhs, sc["ic"])
    ys = np.asarray(ys)

    _, ys_g = load_golden("rainshaft_128")
    scale = np.abs(ys_g).max(axis=(0, 1))  # per-moment scale
    err = np.abs(ys - ys_g) / scale
    assert err.max() < 1e-3, err.max()


@pytest.mark.slow
def test_f32_longhorizon_drift_bound():
    """Long-horizon f32 production-path validation at reference duration
    (the reference's flagship integrates to t = 1000 s,
    rainshaft_single_gamma.jl:30): the f32 fast-tier rainshaft (exact-F2 +
    GL-12 — the same physics the whole-step Pallas kernel executes, whose
    equality with this XLA path is pinned by the parity tests) is
    integrated 1000 steps against the f64 reference-parity path.

    Measured behavior this gate pins (tools/longhorizon.py carries the
    real-chip twin of this record): the scaled trajectory error SATURATES
    near 2.2e-4 by t≈300 and does not grow through t = 1000 — f32 closure
    clipping and eps-guards do not accumulate; and the f32 total-mass
    evolution (physical loss through the bottom boundary, −99.5% by
    t = 1000) tracks f64 to ~1e-6."""
    from cloudy_tpu.models import rainshaft as rs
    from cloudy_tpu.coalescence import build_coalescence_data
    from cloudy_tpu import kernels as K
    from cloudy_tpu.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    config = rs.RainshaftConfig(
        spec=spec, nz=32, zmax=3000.0, norms=norms, t_end=1000.0, dt=1.0
    )
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    E = 4
    state = np.tile(ic[None], (E, 1, 1)) * np.linspace(0.7, 1.3, E)[:, None, None]
    i_mass = [spec.dist_moment_ind(0, 1), spec.dist_moment_ind(1, 1)]
    mass0 = state[..., i_mass].sum()

    results = {}
    for tag, dt_, gl in (("f64", jnp.float64, 0), ("f32", jnp.float32, 12)):
        data = build_coalescence_data(
            spec, ker, (5e-10, np.inf), norms=norms,
            gammainc_iters=12 if gl else 128, f2_exact=bool(gl),
            gammainc_gl_nodes=gl,
        )
        rhs = rs.make_rainshaft_rhs(config, data)
        y = jnp.asarray(state, dt_)
        ckpts = {}
        for seg_end in (300, 600, 1000):
            n = seg_end - (0 if not ckpts else max(ckpts))
            _, ys = stepper.integrate(rhs, y, 0.0, 1.0, n, save_every=n)
            y = ys[-1]
            ckpts[seg_end] = np.asarray(y, np.float64)
        results[tag] = ckpts

    for t in (300, 600, 1000):
        a, b = results["f32"][t], results["f64"][t]
        assert np.all(np.isfinite(a)), t
        scale = np.abs(b).max(axis=(0, 1))
        traj_err = (np.abs(a - b) / scale).max()
        assert traj_err < 1e-3, (t, traj_err)
        drift32 = (a[..., i_mass].sum() - mass0) / mass0
        drift64 = (b[..., i_mass].sum() - mass0) / mass0
        assert abs(drift32 - drift64) < 1e-4, (t, drift32, drift64)


@pytest.mark.slow
def test_f32_longhorizon_drift_bound_nz128():
    """The FLAGSHIP-DEPTH (nz = 128) long horizon, whose scaled error is
    the one still growing at t = 1000, gets its own gate.

    Mechanism (measured, 10-checkpoint per-level error profiles — see
    docs/performance.md "Long-horizon f32 drift"): the worst scaled error
    lives in the MODE-2 NUMBER moment at levels ABOVE the rain front
    (level ~70-91 of 128 vs front at ~45-73), not at the front itself
    (error there stays ~1e-4): it is the S2-promotion knife-edge noise of
    the thinning mode-2 population, whose SCALED magnitude grows as the
    column drains (the per-moment normalization scale decays while the
    absolute f32 error floor does not). Not advective accumulation, not a
    bug — bounded and gated here at 2e-3 (measured 5.9e-4 XLA-twin /
    1.21e-3 chip record at t = 1000)."""
    from cloudy_tpu.models import rainshaft as rs
    from cloudy_tpu.coalescence import build_coalescence_data
    from cloudy_tpu import kernels as K
    from cloudy_tpu.spec import Family, SpectrumSpec

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    config = rs.RainshaftConfig(
        spec=spec, nz=128, zmax=3000.0, norms=norms, t_end=1000.0, dt=1.0
    )
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    E = 2
    state = np.tile(ic[None], (E, 1, 1)) * np.linspace(0.7, 1.3, E)[:, None, None]
    i_mass = [spec.dist_moment_ind(0, 1), spec.dist_moment_ind(1, 1)]
    mass0 = state[..., i_mass].sum()

    results = {}
    for tag, dt_, gl in (("f64", jnp.float64, 0), ("f32", jnp.float32, 12)):
        data = build_coalescence_data(
            spec, ker, (5e-10, np.inf), norms=norms,
            gammainc_iters=12 if gl else 128, f2_exact=bool(gl),
            gammainc_gl_nodes=gl,
        )
        rhs = rs.make_rainshaft_rhs(config, data)
        y = jnp.asarray(state, dt_)
        ckpts = {}
        prev = 0
        for seg_end in (500, 1000):
            _, ys = stepper.integrate(
                rhs, y, 0.0, 1.0, seg_end - prev, save_every=seg_end - prev
            )
            y = ys[-1]
            ckpts[seg_end] = np.asarray(y, np.float64)
            prev = seg_end
        results[tag] = ckpts

    for t in (500, 1000):
        a, b = results["f32"][t], results["f64"][t]
        assert np.all(np.isfinite(a)), t
        scale = np.abs(b).max(axis=(0, 1))
        traj_err = (np.abs(a - b) / scale).max()
        assert traj_err < 2e-3, (t, traj_err)
        drift32 = (a[..., i_mass].sum() - mass0) / mass0
        drift64 = (b[..., i_mass].sum() - mass0) / mass0
        assert abs(drift32 - drift64) < 1e-4, (t, drift32, drift64)
