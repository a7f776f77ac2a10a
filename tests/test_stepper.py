"""Time-stepper orders of accuracy and scan/save semantics."""

import numpy as np
import jax.numpy as jnp

from cloudy_tpu import stepper


def _convergence_order(method, dts=(0.1, 0.05, 0.025)):
    # dy/dt = -y + sin(t), y(0)=1 — smooth nonautonomous problem
    f = lambda y, t: -y + jnp.sin(t)
    t_end = 1.0
    exact = None

    def run(dt):
        n = int(round(t_end / dt))
        _, ys = stepper.integrate(f, jnp.asarray([1.0]), 0.0, dt, n, method=method)
        return float(ys[-1, 0])

    # fine reference
    ref = run(1e-4)
    errs = [abs(run(dt) - ref) for dt in dts]
    orders = [
        np.log(errs[i] / errs[i + 1]) / np.log(dts[i] / dts[i + 1])
        for i in range(len(dts) - 1)
    ]
    return min(orders)


def test_euler_first_order():
    assert _convergence_order("euler") > 0.9


def test_ssprk33_third_order():
    assert _convergence_order("ssprk33") > 2.7


def test_rk4_fourth_order():
    assert _convergence_order("rk4") > 3.7


def test_save_every_thinning():
    f = lambda y, t: -y
    ts, ys = stepper.integrate(f, jnp.asarray([1.0]), 0.0, 0.1, 10, save_every=5)
    assert ys.shape == (3, 1)
    np.testing.assert_allclose(np.asarray(ts), [0.0, 0.5, 1.0], atol=1e-12)
    # matches the unthinned trajectory
    ts2, ys2 = stepper.integrate(f, jnp.asarray([1.0]), 0.0, 0.1, 10, save_every=1)
    np.testing.assert_allclose(np.asarray(ys[-1]), np.asarray(ys2[-1]), rtol=1e-14)


def test_remat_matches():
    f = lambda y, t: -(y**2)
    _, a = stepper.integrate(f, jnp.asarray([1.0]), 0.0, 0.1, 10, remat=False)
    _, b = stepper.integrate(f, jnp.asarray([1.0]), 0.0, 0.1, 10, remat=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-15)


def test_adaptive_accuracy_tracks_rtol():
    """integrate_adaptive hits the requested tolerance on a smooth problem
    and spends more steps at tighter tolerance. (Added capability: the
    reference's parcel passes reltol/abstol to SSPRK33, which has no error
    estimator and ignores them — parcel_example.jl:105-110.)"""
    import jax

    f = lambda y, t: -y + jnp.sin(t)
    # exact solution of y' = -y + sin t, y(0)=1: 1.5 e^{-t} + (sin t - cos t)/2
    t1 = 3.0
    exact = 1.5 * np.exp(-t1) + 0.5 * (np.sin(t1) - np.cos(t1))

    y_loose, st_loose = jax.jit(
        lambda y: stepper.integrate_adaptive(f, y, 0.0, t1, rtol=1e-4, atol=1e-8)
    )(jnp.asarray([1.0]))
    y_tight, st_tight = jax.jit(
        lambda y: stepper.integrate_adaptive(f, y, 0.0, t1, rtol=1e-8, atol=1e-12)
    )(jnp.asarray([1.0]))

    assert abs(float(y_loose[0]) - exact) < 1e-3
    assert abs(float(y_tight[0]) - exact) < 1e-6
    assert int(st_tight["n_accept"]) > int(st_loose["n_accept"])
    assert int(st_loose["n_reject"]) < int(st_loose["n_accept"])
    assert bool(st_loose["reached"]) and bool(st_tight["reached"])
    assert abs(float(st_tight["t_final"]) - t1) < 1e-12


def test_adaptive_reports_truncation_on_max_steps():
    """When max_steps trials are exhausted before t1, `reached` is False and
    t_final records how far the integration actually got."""
    f = lambda y, t: -y
    y1, st = stepper.integrate_adaptive(
        f, jnp.asarray([1.0]), 0.0, 1e6, rtol=1e-10, atol=1e-14, max_steps=10
    )
    assert not bool(st["reached"])
    assert float(st["t_final"]) < 1e6
    assert np.all(np.isfinite(np.asarray(y1)))


def test_adaptive_matches_fixed_dt_on_coalescence_box():
    """Adaptive SSPRK33 on the real coalescence RHS agrees with a fine
    fixed-dt trajectory."""
    from cloudy_tpu.spec import Family, SpectrumSpec
    from cloudy_tpu import kernels as K
    from cloudy_tpu import distributions as pd
    from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints

    spec = SpectrumSpec((Family.GAMMA,))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=(1e6, 1e-9))
    y0 = jnp.asarray([1e2, 1e1, 2.0])

    def rhs(m, t):
        del t
        return get_coal_ints(data, pd.params_from_moments(spec, m))

    _, ys = stepper.integrate(rhs, y0, 0.0, 0.01, 3000)  # fine fixed dt
    y_ad, st = stepper.integrate_adaptive(
        rhs, y0, 0.0, 30.0, rtol=1e-7, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(y_ad), np.asarray(ys[-1]), rtol=1e-5
    )
    # adaptivity must beat the fine fixed grid on step count
    assert int(st["n_accept"]) < 3000
