"""Calibration subsystem (cloudy_tpu/calibrate.py).

The reference has no calibration code; in the CliMA stack Cloudy.jl is
calibrated externally through EnsembleKalmanProcesses.jl as a black box.
Here both drivers run against the real coalescence forward model:

- `run_eki` recovers the kernel scale from noisy trajectory observations via
  a vmapped-ensemble, scanned EKI loop (the EKP workflow, on-device).
- `fit_gradient` recovers it via optax/`jax.grad` — the pathway the Julia
  ecosystem lacks entirely.
- `eki_step` is pinned against the exact Kalman posterior in the
  linear-Gaussian large-ensemble limit.
"""

import numpy as np
import jax
import jax.numpy as jnp

from cloudy_tpu.spec import Family, SpectrumSpec
from cloudy_tpu import kernels as K
from cloudy_tpu import distributions as pd
from cloudy_tpu import stepper
from cloudy_tpu.calibrate import (
    ensemble_init,
    eki_step,
    fit_gradient,
    run_eki,
    run_eks,
    run_sparse_eki,
    run_uki,
)
from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints


def _box_forward():
    """G(log_s) -> moments at 3 observation times for a single-gamma box
    collision run with the linear kernel scaled by s = exp(log_s)."""
    spec = SpectrumSpec((Family.GAMMA,))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (np.inf,), norms=(1e6, 1e-9), gammainc_iters=32
    )
    mom0 = jnp.asarray([1e2, 1e1, 2.0])

    def forward(log_s):
        # observe LOG-moments: they span ~9 decades over the prior's s-range,
        # and log space keeps the EKI covariance solve well-conditioned
        # (f32-safe — examples/calibration_example.py runs this in f32)
        s = jnp.exp(log_s[0] if log_s.ndim else log_s)

        def rhs(m, t):
            del t
            return s * get_coal_ints(data, pd.params_from_moments(spec, m))

        _, ys = stepper.integrate(rhs, mom0, 0.0, 2.0, 15, method="ssprk33")
        return jnp.log(ys[jnp.asarray([5, 10, 15])]).reshape(-1)

    return forward


def test_eki_recovers_kernel_scale():
    forward = _box_forward()
    log_s_true = jnp.log(jnp.asarray(1.7))
    y_clean = forward(jnp.asarray([log_s_true]))
    noise = 1e-3
    key = jax.random.PRNGKey(0)
    k_obs, k_ens, k_run = jax.random.split(key, 3)
    y = y_clean + noise * jax.random.normal(k_obs, y_clean.shape, y_clean.dtype)

    theta0 = ensemble_init(k_ens, [0.0], [0.7], n_ens=24)  # prior: s ~ lognormal(1)
    res = run_eki(forward, theta0, y, noise**2, n_iters=6, key=k_run)

    s_est = float(jnp.exp(jnp.mean(res.theta[:, 0])))
    assert abs(s_est - 1.7) / 1.7 < 0.02, s_est
    # misfit collapses from the prior spread to ~the noise floor
    assert float(res.misfit_history[-1]) < 5.0
    assert float(res.misfit_history[-1]) < 1e-3 * float(res.misfit_history[0])
    assert res.theta_history.shape == (7, 24, 1)


def test_eki_step_matches_kalman_posterior_linear_gaussian():
    """For G(θ) = Aθ and a large ensemble, one EKI step reproduces the
    Kalman update of the ensemble mean: m⁺ = m + CAᵀ(ACAᵀ + Γ)⁻¹(y − Am)."""
    key = jax.random.PRNGKey(1)
    P, D, J = 3, 4, 60000
    kA, kth, keta = jax.random.split(key, 3)
    A = jax.random.normal(kA, (D, P))
    prior_mean = jnp.asarray([1.0, -2.0, 0.5])
    prior_cov = jnp.diag(jnp.asarray([0.5, 1.0, 2.0]))
    theta = prior_mean + jax.random.normal(kth, (J, P)) @ jnp.sqrt(prior_cov)
    gamma = 0.3 * jnp.eye(D)
    y = jnp.asarray([0.3, -1.0, 2.0, 0.7])

    g = theta @ A.T
    theta1 = eki_step(theta, g, y, gamma, keta)

    m = jnp.mean(theta, axis=0)
    C = jnp.cov(theta.T)
    S = A @ C @ A.T + gamma
    m_post = m + C @ A.T @ jnp.linalg.solve(S, y - A @ m)
    np.testing.assert_allclose(
        np.asarray(jnp.mean(theta1, axis=0)), np.asarray(m_post), atol=0.03
    )


def test_sparse_eki_recovers_sparse_coefficients():
    """Sparse EKI zeroes the inactive coordinates EXACTLY (hard prune) while
    recovering the active one — plain EKI leaves noise on every coordinate.
    Mirrors the over-complete kernel-coefficient calibration use-case."""
    key = jax.random.PRNGKey(21)
    P, D, J = 4, 6, 40
    kA, kens, krun1, krun2 = jax.random.split(key, 4)
    A = jax.random.normal(kA, (D, P))
    theta_true = jnp.asarray([0.0, 1.5, 0.0, 0.0])
    y = A @ theta_true
    gamma = 1e-4

    theta0 = ensemble_init(kens, jnp.zeros(P), jnp.ones(P), n_ens=J)
    res = run_sparse_eki(
        lambda t: A @ t, theta0, y, gamma, n_iters=12, key=krun1,
        lambda_l1=0.05, prune_below=0.1,
    )
    m = np.asarray(jnp.mean(res.theta, axis=0))
    assert m[0] == 0.0 and m[2] == 0.0 and m[3] == 0.0, m
    # soft thresholding biases the active coefficient by ≤ λ
    assert abs(m[1] - 1.5) < 0.1, m
    assert float(res.misfit_history[-1]) < 1e-2 * float(res.misfit_history[0])

    res_plain = run_eki(lambda t: A @ t, theta0, y, gamma, n_iters=12, key=krun2)
    m_plain = np.asarray(jnp.mean(res_plain.theta, axis=0))
    assert np.abs(m_plain[[0, 2, 3]]).max() > 0.0  # no exact zeros


def test_sparse_eki_sparse_idx_protects_dense_coords():
    """Coordinates outside sparse_idx are never thresholded."""
    key = jax.random.PRNGKey(23)
    A = jnp.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    y = A @ jnp.asarray([0.02, 1.0])  # coord 0 small but PROTECTED
    theta0 = ensemble_init(
        jax.random.fold_in(key, 0), jnp.zeros(2), jnp.ones(2), n_ens=30
    )
    res = run_sparse_eki(
        lambda t: A @ t, theta0, y, 1e-6, n_iters=8,
        key=jax.random.fold_in(key, 1),
        lambda_l1=0.03, prune_below=0.2, sparse_idx=[1],
    )
    m = np.asarray(jnp.mean(res.theta, axis=0))
    assert abs(m[0] - 0.02) < 0.02 and m[0] != 0.0  # protected, not zeroed
    assert abs(m[1] - 1.0) < 0.25  # thresholded coord still recovered


def test_eks_samples_linear_gaussian_posterior():
    """At equilibrium the EKS ensemble samples the Bayesian posterior: for
    linear G the ensemble mean AND covariance must match the exact Gaussian
    posterior (the property EKI does not have — its ensemble collapses).
    Small dt0 keeps the O(Δt) Euler-Maruyama variance inflation below the
    statistical tolerance (see run_eks docstring)."""
    key = jax.random.PRNGKey(5)
    P, D, J = 2, 3, 800
    kA, kens, krun = jax.random.split(key, 3)
    A = jax.random.normal(kA, (D, P))
    gamma = jnp.diag(jnp.asarray([0.1, 0.3, 0.2]))
    gamma0 = jnp.diag(jnp.asarray([1.0, 2.0]))
    r0 = jnp.asarray([0.5, -0.5])
    y = jnp.asarray([1.0, -0.3, 0.8])

    fisher = A.T @ jnp.linalg.solve(gamma, A)
    C_post = jnp.linalg.inv(fisher + jnp.linalg.inv(gamma0))
    m_post = C_post @ (
        A.T @ jnp.linalg.solve(gamma, y) + jnp.linalg.solve(gamma0, r0)
    )

    theta0 = ensemble_init(kens, r0, jnp.sqrt(jnp.diag(gamma0)), n_ens=J)
    res = run_eks(
        lambda t: A @ t, theta0, y, gamma, r0, gamma0,
        n_iters=3000, key=krun, dt0=0.05,
    )
    m = jnp.mean(res.theta, axis=0)
    C = jnp.cov(res.theta.T)
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_post), atol=0.08)
    np.testing.assert_allclose(
        np.asarray(C), np.asarray(C_post), rtol=0.25, atol=0.02
    )
    assert res.theta_history.shape == (3001, J, P)


def test_eks_recovers_kernel_scale():
    """EKS on the real coalescence forward model: posterior mode near the
    truth AND a posterior spread (the ensemble does not collapse)."""
    forward = _box_forward()
    log_s_true = jnp.log(jnp.asarray(1.7))
    y_clean = forward(jnp.asarray([log_s_true]))
    noise = 1e-3
    key = jax.random.PRNGKey(11)
    k_obs, k_ens, k_run = jax.random.split(key, 3)
    y = y_clean + noise * jax.random.normal(k_obs, y_clean.shape, y_clean.dtype)

    theta0 = ensemble_init(k_ens, [0.0], [0.7], n_ens=24)
    res = run_eks(
        forward, theta0, y, noise**2, [0.0], [0.7**2],
        n_iters=30, key=k_run,
    )
    s_est = float(jnp.exp(jnp.mean(res.theta[:, 0])))
    assert abs(s_est - 1.7) / 1.7 < 0.03, s_est
    assert float(res.misfit_history[-1]) < 1e-2 * float(res.misfit_history[0])
    # a sampler keeps finite spread (EKI's ensemble would have collapsed)
    assert float(jnp.std(res.theta[:, 0])) > 1e-5


def test_uki_recovers_kernel_scale():
    """UKI on the real coalescence forward model: deterministic (no ensemble
    key), 2P = 2 forward evaluations per iteration, and the converged
    covariance is a real uncertainty estimate."""
    forward = _box_forward()
    log_s_true = jnp.log(jnp.asarray(1.7))
    y_clean = forward(jnp.asarray([log_s_true]))
    noise = 1e-3
    y = y_clean + noise * jax.random.normal(
        jax.random.PRNGKey(3), y_clean.shape, y_clean.dtype
    )

    res = run_uki(forward, [0.0], [0.7**2], y, noise**2, n_iters=8)
    s_est = float(jnp.exp(res.mean[0]))
    assert abs(s_est - 1.7) / 1.7 < 0.02, s_est
    assert float(res.misfit_history[-1]) < 1e-3 * float(res.misfit_history[0])
    # the posterior std of log s must bracket the (tiny) actual error
    std = float(jnp.sqrt(res.cov[0, 0]))
    assert 1e-6 < std < 0.1
    assert res.mean_history.shape == (9, 1)
    assert res.cov_history.shape == (9, 1, 1)


def test_uki_linear_gaussian_fixed_point():
    """For linear G(θ) = Aθ, α=1, the UKI fixed point is the weighted
    least-squares solution m_∞ = (AᵀΓ⁻¹A)⁻¹AᵀΓ⁻¹y with covariance
    C_∞ = (AᵀΓ⁻¹A)⁻¹ (Huang/Schneider/Stuart 2022, Thm 4.1 analogue for
    the Σ_ω = C, Σ_ν = 2Γ parametrization)."""
    key = jax.random.PRNGKey(7)
    P, D = 3, 5
    A = jax.random.normal(key, (D, P), jnp.float64 if jax.config.x64_enabled else jnp.float32)
    gamma = jnp.diag(jnp.asarray([0.2, 0.5, 0.1, 0.3, 0.4]))
    y = jnp.asarray([0.3, -1.0, 2.0, 0.7, -0.2])

    res = run_uki(
        lambda t: A @ t, [0.0, 0.0, 0.0], jnp.eye(P), y, gamma, n_iters=40
    )
    fisher = A.T @ jnp.linalg.solve(gamma, A)
    m_star = jnp.linalg.solve(fisher, A.T @ jnp.linalg.solve(gamma, y))
    c_star = jnp.linalg.inv(fisher)
    np.testing.assert_allclose(np.asarray(res.mean), np.asarray(m_star), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.cov), np.asarray(c_star), rtol=1e-3, atol=1e-5)


def test_uki_transform_and_alpha_reg():
    """transform=exp calibrates a positive parameter; alpha_reg < 1 pulls
    the fixed point toward the prior mean (regularization is active)."""
    y = jnp.asarray([2.0, 4.0])

    def forward(s):  # s > 0 via transform
        return jnp.asarray([s[0], 2.0 * s[0]])

    res = run_uki(
        forward, [0.0], [1.0], y, 1e-4, n_iters=25, transform=jnp.exp
    )
    np.testing.assert_allclose(float(jnp.exp(res.mean[0])), 2.0, rtol=1e-3)

    res_reg = run_uki(
        forward, [0.0], [1.0], y, 1e-4, n_iters=25, transform=jnp.exp,
        alpha_reg=0.7,
    )
    # regularized mean sits strictly between prior (0) and unregularized
    assert 0.0 < float(res_reg.mean[0]) < float(res.mean[0])


def test_fit_gradient_recovers_kernel_scale():
    forward = _box_forward()
    log_s_true = jnp.asarray(np.log(1.7))
    y = forward(log_s_true)

    def loss(log_s):
        return jnp.sum((forward(log_s) - y) ** 2)

    res = fit_gradient(loss, jnp.asarray(0.0), n_iters=120, learning_rate=0.1)
    assert abs(float(jnp.exp(res.params)) - 1.7) / 1.7 < 1e-3
    assert float(res.loss_history[-1]) < 1e-4 * float(res.loss_history[0])


def test_sparse_eki_recovers_kernel_tensor_of_real_model():
    """THE motivating use-case (calibrate.py:176-179):
    sparse EKI over ALL kernel-tensor coefficients of the actual
    coalescence model via `make_kernel_diff_coal_fn`, from noisy box
    trajectories generated by a pure Golovin (linear) kernel — where only
    the c[0,1]/c[1,0] coefficients are active. Asserts EXACT zeros on the
    inactive c[0,0]/c[1,1] (hard prune) and debiased recovery of the
    active total c[0,1]+c[1,0] (the two enter the symmetric bilinear form
    identically, so their SUM is the identifiable combination)."""
    from cloudy_tpu.coalescence import make_kernel_diff_coal_fn

    spec = SpectrumSpec((Family.GAMMA,))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(spec, ker, (np.inf,), norms=norms)
    k_true = jnp.asarray(data.kernels)  # [1, 1, 2, 2] normalized
    b_n = float(k_true[0, 0, 0, 1])  # ≈ 5·norms[0]·norms[1] = 5e-3
    fn = make_kernel_diff_coal_fn(data)

    y0 = jnp.asarray([1e2, 1e1, 2.0])  # normalized moments
    n_steps, dt, every = 60, 0.5, 12

    def forward(kflat):
        def rhs(m, t):
            del t
            return fn(pd.params_from_moments(spec, m), kflat.reshape(1, 1, 2, 2))

        _, ys = stepper.integrate(rhs, y0, 0.0, dt, n_steps, save_every=every)
        # guard divergent ensemble members (negative coefficients can make
        # the dynamics grow); the Kalman update pulls them back
        return jnp.nan_to_num(ys[1:].reshape(-1), nan=1e6, posinf=1e6).clip(
            -1e6, 1e6
        )

    y_clean = forward(k_true.reshape(-1))
    key = jax.random.PRNGKey(3)
    k_noise, k_ens, k_run = jax.random.split(key, 3)
    scale = jnp.abs(y_clean)
    noise = 1e-3 * scale
    y_obs = y_clean + noise * jax.random.normal(k_noise, y_clean.shape)

    theta0 = ensemble_init(k_ens, jnp.zeros(4), b_n * jnp.ones(4), n_ens=40)
    res = run_sparse_eki(
        forward, theta0, y_obs, noise**2 + 1e-12, n_iters=10, key=k_run,
        lambda_l1=0.05 * b_n, prune_below=0.2 * b_n, polish_iters=10,
    )
    m = np.asarray(jnp.mean(res.theta, axis=0)).reshape(2, 2)
    # exact zeros on the inactive coefficients
    assert m[0, 0] == 0.0, m
    assert m[1, 1] == 0.0, m
    # debiased active total: c01 + c10 ≈ 2·B_n within 5%
    total = m[0, 1] + m[1, 0]
    np.testing.assert_allclose(total, 2.0 * b_n, rtol=0.05)
    # and the fit explains the data to the noise floor
    assert float(res.misfit_history[-1]) < 10.0, res.misfit_history[-1]


def test_eki_through_production_whole_step_kernel():
    """Wiring smoke: EKI whose per-member forward runs the PRODUCTION
    whole rainshaft step (tiny shapes) with the per-member kernel_scale
    operand. Pins that run_eki's vmap batches members through the step,
    the loop jits, misfit decreases, and the recovered scale moves toward
    the truth."""
    import sys, os

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
    )
    from calibration_bench import make_pod_forward
    from cloudy_tpu import calibrate

    forward, th_true = make_pod_forward(
        J_cols=2, nz=8, n_steps=4, interpret=True
    )
    y = forward(th_true)
    assert bool(jnp.all(jnp.isfinite(y)))

    key = jax.random.PRNGKey(0)
    theta0 = calibrate.ensemble_init(
        key, jnp.zeros(1, jnp.float32), jnp.asarray([0.5], jnp.float32),
        n_ens=6,
    )
    res = jax.jit(
        lambda th: calibrate.run_eki(
            forward, th, y, jnp.asarray(1e-4, jnp.float32), n_iters=3,
            key=jax.random.PRNGKey(1),
        )
    )(theta0)
    assert bool(jnp.all(jnp.isfinite(res.theta)))
    assert float(res.misfit_history[-1]) < float(res.misfit_history[0])
    err0 = abs(float(jnp.mean(theta0[:, 0])) - float(th_true[0]))
    err1 = abs(float(jnp.mean(res.theta[:, 0])) - float(th_true[0]))
    assert err1 < err0
