"""Kernel calibration from noisy observations — EKI vs gradient descent.

NO reference counterpart: CliMA calibrates Cloudy.jl externally through
EnsembleKalmanProcesses.jl (black-box, host-driven). Here both drivers are
on-device JAX programs (cloudy_tpu/calibrate.py): EKI evaluates its whole
ensemble as one vmapped forward pass inside a `lax.scan`, and the gradient
fit uses `jax.grad` through the full closure-inversion + SSPRK33 pipeline —
impossible for the Julia reference.
"""
from common import *

import os

import jax

# calibration is a CPU-side workflow here; f64 keeps the EKI covariance
# solves well-conditioned for the badly-scaled initial misfits (the
# f32 device calibration path is timed separately in
# tools/calibration_bench.py with log-space observables)
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from cloudy_tpu import calibrate, distributions as pd, stepper
from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints

spec = SpectrumSpec((Family.GAMMA,))
ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
data = build_coalescence_data(spec, ker, (np.inf,), norms=(1e6, 1e-9))
mom0 = jnp.asarray([1e2, 1e1, 2.0])


def forward(log_s):
    """Observe LOG-moments at three times: the moments span ~9 decades over
    the prior's s-range, so log space is what keeps the EKI covariance solve
    well-conditioned (and f32-safe) — the standard multiscale-observable
    treatment in EKP practice."""
    s = jnp.exp(log_s[0] if log_s.ndim else log_s)

    def rhs(m, t):
        del t
        return s * get_coal_ints(data, pd.params_from_moments(spec, m))

    _, ys = stepper.integrate(rhs, mom0, 0.0, 2.0, 15, method="ssprk33")
    return jnp.log(ys[jnp.asarray([5, 10, 15])]).reshape(-1)


s_true, noise = 1.7, 1e-3
key = jax.random.PRNGKey(0)
k_obs, k_ens, k_run = jax.random.split(key, 3)
y = forward(jnp.log(jnp.asarray(s_true)))
y = y + noise * jax.random.normal(k_obs, y.shape, y.dtype)

fast = bool(os.environ.get("CLOUDY_EXAMPLE_FAST"))

# --- EKI: 24-member ensemble, one jitted scan
theta0 = calibrate.ensemble_init(k_ens, [0.0], [0.7], n_ens=24)
res = calibrate.run_eki(
    forward, theta0, y, noise**2, n_iters=3 if fast else 6, key=k_run
)
s_eki = float(jnp.exp(res.theta[:, 0].mean()))
print(f"EKI:      s = {s_eki:.4f} (truth {s_true}); "
      f"misfit {float(res.misfit_history[0]):.3g} -> "
      f"{float(res.misfit_history[-1]):.3g}")

# --- gradient descent through the full differentiable model
# --- EKS: posterior SAMPLES (the ensemble keeps its spread at equilibrium)
res_s = calibrate.run_eks(
    forward, theta0, y, noise**2, [0.0], [0.7**2],
    n_iters=10 if fast else 30, key=jax.random.fold_in(k_run, 1),
)
print(f"EKS:      s = {float(jnp.exp(res_s.theta[:, 0].mean())):.4f} "
      f"(truth {s_true}); ensemble std(log s) = "
      f"{float(jnp.std(res_s.theta[:, 0])):.2e}; "
      f"misfit {float(res_s.misfit_history[0]):.3g} -> "
      f"{float(res_s.misfit_history[-1]):.3g}")

# --- UKI: deterministic sigma-point quadrature, 2 forward evals/iter,
# converged covariance = posterior uncertainty of log s
res_u = calibrate.run_uki(
    forward, [0.0], [0.7**2], y, noise**2, n_iters=4 if fast else 8
)
print(f"UKI:      s = {float(jnp.exp(res_u.mean[0])):.4f} (truth {s_true}); "
      f"posterior std(log s) = {float(jnp.sqrt(res_u.cov[0, 0])):.2e}; "
      f"misfit {float(res_u.misfit_history[0]):.3g} -> "
      f"{float(res_u.misfit_history[-1]):.3g}")

res_g = calibrate.fit_gradient(
    lambda t: jnp.sum((forward(t) - y) ** 2),
    jnp.asarray(0.0), n_iters=40 if fast else 120, learning_rate=0.1,
)
print(f"gradient: s = {float(jnp.exp(res_g.params)):.4f} (truth {s_true}); "
      f"loss {float(res_g.loss_history[0]):.3g} -> "
      f"{float(res_g.loss_history[-1]):.3g}")
print("done")

# --- sparse EKI over ALL kernel-tensor coefficients (the over-complete
# calibration the docstring of run_sparse_eki motivates): recover a pure
# Golovin kernel — only c[0,1]/c[1,0] active — from noisy box trajectories,
# with exact zeros on the inactive coefficients (hard prune) and a
# debiasing polish on the survivors. Mirrors
# tests/test_calibrate.py::test_sparse_eki_recovers_kernel_tensor_of_real_model.
from cloudy_tpu.coalescence import make_kernel_diff_coal_fn

kfn = make_kernel_diff_coal_fn(data)
k_true_flat = jnp.asarray(data.kernels).reshape(-1)
b_n = float(k_true_flat[1])


def forward_tensor(kflat):
    """LOG-moment observations (same multiscale treatment as `forward`
    above — keeps the EKI covariance solve well-conditioned in f32)."""

    def rhs(m, t):
        del t
        return kfn(pd.params_from_moments(spec, m), kflat.reshape(1, 1, 2, 2))

    _, ys = stepper.integrate(rhs, mom0, 0.0, 0.5, 60, save_every=12)
    safe = jnp.clip(jnp.nan_to_num(ys[1:], nan=1e12, posinf=1e12), 1e-12, 1e12)
    return jnp.log(safe).reshape(-1)


y_t = forward_tensor(k_true_flat)
k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
y_t = y_t + 1e-3 * jax.random.normal(k1, y_t.shape)
res_sp = calibrate.run_sparse_eki(
    forward_tensor,
    calibrate.ensemble_init(k2, jnp.zeros(4), b_n * jnp.ones(4), n_ens=40),
    y_t, 1e-6, n_iters=5 if fast else 10, key=k3,
    lambda_l1=0.05 * b_n, prune_below=0.2 * b_n,
    polish_iters=5 if fast else 10,
)
m_sp = np.asarray(jnp.mean(res_sp.theta, axis=0)).reshape(2, 2)
print(f"sparse EKI kernel tensor (truth c01=c10={b_n:.3g}, c00=c11=0):")
print(f"  recovered c = {m_sp.tolist()}")
print(f"  exact zeros: c00={m_sp[0,0]==0.0} c11={m_sp[1,1]==0.0}; "
      f"active total {m_sp[0,1]+m_sp[1,0]:.4g} vs {2*b_n:.4g}")
