"""End-to-end differentiability — a capability the Julia reference does NOT
have (the CliMA calibration use-case drives
Cloudy.jl through EnsembleKalmanProcesses precisely because it lacks
gradients).

Here the whole pipeline — closure inversion → incomplete-gamma
autoconversion → Q/R/S → SSPRK33 `lax.scan` — is one differentiable JAX
program: `jax.grad` of a trajectory loss w.r.t. the initial moments AND the
kernel-tensor coefficients runs finite and matches central finite
differences, with and without `jax.checkpoint` rematerialization.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K
from cloudy_tpu import distributions as pd
from cloudy_tpu import stepper
from cloudy_tpu.coalescence import (
    build_coalescence_data,
    get_coal_ints,
)


def _setup():
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), gammainc_iters=32
    )
    mom0 = jnp.asarray([1e2, 1e1, 2.0, 1e-6, 1e-5, 2e-4])
    return spec, data, mom0


def _loss_fn(spec, data, n_steps=20, dt=1.0, remat=False):
    """Trajectory loss as a function of (initial moments, kernel scale s):
    the kernel coefficients enter multiplicatively, so dL/ds is the
    directional derivative w.r.t. ALL kernel-tensor coefficients at once —
    the calibration parameter of the Golovin/linear kernel."""

    def loss(mom0, s):
        def rhs(m, t):
            del t
            params = pd.params_from_moments(spec, m)
            return s * get_coal_ints(data, params)

        _, ys = stepper.integrate(
            rhs, mom0, 0.0, dt, n_steps, method="ssprk33", remat=remat
        )
        # scale-balanced quadratic loss over the final state (moment
        # magnitudes span ~8 decades)
        w = 1.0 / jnp.asarray([1e2, 1e1, 2.0, 1e-2, 1e-2, 1e-2])
        return jnp.sum((ys[-1] * w) ** 2)

    return loss


@pytest.mark.parametrize(
    "remat",
    [pytest.param(False, marks=pytest.mark.slow), True],
)
def test_grad_matches_finite_differences(remat):
    spec, data, mom0 = _setup()
    loss = _loss_fn(spec, data, remat=remat)
    s0 = jnp.asarray(1.0)

    g_mom, g_s = jax.jit(jax.grad(loss, argnums=(0, 1)))(mom0, s0)
    g_mom, g_s = np.asarray(g_mom), float(g_s)
    assert np.all(np.isfinite(g_mom)) and np.isfinite(g_s)
    assert np.any(g_mom != 0.0) and g_s != 0.0

    # central finite differences, relative step per coordinate. h = 1e-3·|x|
    # balances truncation against roundoff for the small coordinates (the
    # loss changes by only ~|g|·h against an O(1e4) value; verified that FD
    # converges to the autodiff value as h grows — smaller steps are
    # roundoff-dominated, not an autodiff discrepancy)
    jloss = jax.jit(loss)
    for i in range(len(mom0)):
        h = 1e-3 * float(mom0[i])
        e = np.zeros(len(mom0))
        e[i] = h
        fd = (
            float(jloss(mom0 + jnp.asarray(e), s0))
            - float(jloss(mom0 - jnp.asarray(e), s0))
        ) / (2 * h)
        denom = max(abs(fd), abs(g_mom[i]), 1e-30)
        assert abs(fd - g_mom[i]) / denom < 2e-4, (i, fd, g_mom[i])

    hs = 1e-6
    fd_s = (float(jloss(mom0, s0 + hs)) - float(jloss(mom0, s0 - hs))) / (2 * hs)
    assert abs(fd_s - g_s) / max(abs(fd_s), 1e-30) < 5e-5, (fd_s, g_s)


@pytest.mark.slow
def test_grad_remat_matches_no_remat():
    """`jax.checkpoint` rematerialization must not change the gradient."""
    spec, data, mom0 = _setup()
    s0 = jnp.asarray(1.0)
    g0 = jax.jit(jax.grad(_loss_fn(spec, data, remat=False)))(mom0, s0)
    g1 = jax.jit(jax.grad(_loss_fn(spec, data, remat=True)))(mom0, s0)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), rtol=1e-12)


def test_grad_through_kernel_tensor_coefficients():
    """Gradient of a TRAJECTORY loss w.r.t. every kernel-tensor coefficient
    (the quantity a calibration loop updates), via the one-hot-basis
    re-contraction `make_kernel_diff_coal_fn`; matches central finite
    differences coefficient by coefficient."""
    from cloudy_tpu.coalescence import make_kernel_diff_coal_fn

    spec, data, mom0 = _setup()
    coal = make_kernel_diff_coal_fn(data)
    k0 = jnp.asarray(data.kernels)  # normalized [N, N, P, P]
    n_steps, dt = 4, 1.0  # grad-compile budget; FD match is per-step exact
    w = 1.0 / jnp.asarray([1e2, 1e1, 2.0, 1e-2, 1e-2, 1e-2])

    def loss(kernels):
        def rhs(m, t):
            del t
            return coal(pd.params_from_moments(spec, m), kernels)

        _, ys = stepper.integrate(rhs, mom0, 0.0, dt, n_steps)
        return jnp.sum((ys[-1] * w) ** 2)

    # consistency: at the stored coefficients the diff path equals the
    # static path exactly
    p0 = pd.params_from_moments(spec, mom0)
    np.testing.assert_allclose(
        np.asarray(coal(p0, k0)),
        np.asarray(get_coal_ints(data, p0)),
        rtol=1e-12,
    )

    g = np.asarray(jax.jit(jax.grad(loss))(k0))
    assert np.all(np.isfinite(g))
    assert np.any(g != 0.0)

    jloss = jax.jit(loss)
    k0n = np.asarray(k0)
    scale = np.abs(k0n).max()
    it = np.ndindex(k0n.shape)
    for idx in it:
        h = 1e-6 * scale
        e = np.zeros_like(k0n)
        e[idx] = h
        fd = (
            float(jloss(jnp.asarray(k0n + e)))
            - float(jloss(jnp.asarray(k0n - e)))
        ) / (2 * h)
        denom = max(abs(fd), abs(g[idx]), 1e-3 * np.abs(g).max())
        assert abs(fd - g[idx]) / denom < 1e-4, (idx, fd, g[idx])
