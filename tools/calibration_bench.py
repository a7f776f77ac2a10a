"""Calibration throughput on the default device.

Measures the vmapped-ensemble EKI forward pass + Kalman update: J ensemble
members, each a full 2-gamma coalescence box trajectory (closure inversion +
analytical Q/R/S per step under `lax.scan`), batched so members run as one
program — the workflow EnsembleKalmanProcesses.jl drives as J separate
black-box model runs from the host. Prints one JSON line per configuration,
with the device it ran on.

Usage: python -u tools/calibration_bench.py [--pod]
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_pod_forward(
    J_cols: int = 32, nz: int = 32, n_steps: int = 60, interpret: bool = False
):
    """Per-member forward model running the PRODUCTION whole step: member
    parameter θ = log kernel scale enters through the step's `kernel_scale`
    operand (exactly equivalent to scaling the kernel tensor —
    tests/test_pallas.py), the member's rainshaft ensemble (`J_cols`
    columns × `nz` levels) is the state, and the observables are the
    member's log mean moment profile after `n_steps`. `run_eki` vmaps this
    over the J members (``interpret=True``: the kernel in the Pallas
    interpreter, for the CPU). Returns (forward, theta_truth)."""
    import jax
    import jax.numpy as jnp

    from cloudy_tpu.spec import Family, SpectrumSpec
    from cloudy_tpu import kernels as K
    from cloudy_tpu.coalescence import build_coalescence_data
    from cloudy_tpu.models import rainshaft as rs
    from cloudy_tpu.ops import triton_coalescence as tc

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=norms, fast_tier=True
    )
    config = rs.RainshaftConfig(spec=spec, nz=nz, zmax=3000.0, norms=norms,
                                dt=1.0)
    step = tc.make_triton_rainshaft_step_fn(
        data, config.vel, norms, nz=nz, dz=config.dz, dt=config.dt,
        interpret=interpret, kernel_scale=True,
    )
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    state0 = rs.to_soa(jnp.asarray(
        np.tile(ic[None], (J_cols, 1, 1))
        * np.linspace(0.7, 1.3, J_cols)[:, None, None],
        jnp.float32,
    ))  # [n_tot, nz, J_cols]

    def forward(theta):
        s = jnp.exp(theta[0]).astype(state0.dtype)
        y = jax.lax.fori_loop(0, n_steps, lambda _, yy: step(yy, s), state0)
        prof = y.mean(axis=2)  # [n_tot, nz]
        # every 4th level: 48 observables keep the J-member sample
        # covariance well-conditioned for the f32 Kalman solve (the full
        # 192-observable vector at 1e-6 noise NaN'd the J=64 update)
        prof = prof[:, ::4]
        safe = jnp.clip(
            jnp.nan_to_num(prof, nan=1e12, posinf=1e12), 1e-12, 1e12
        )
        return jnp.log(safe).reshape(-1)

    return forward, jnp.asarray([jnp.log(1.7)], jnp.float32)


def _sec_per_iter(chain, theta0, n=8, reps=5):
    """Median seconds per EKI iteration of an n-iteration jitted chain
    (compiled and warmed first; `block_until_ready` ends each run)."""
    import jax

    jax.block_until_ready(chain(theta0, n))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(theta0, n))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / n


def _device():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind}


def pod_main():
    """EKI with the production whole step as the forward model."""
    import jax
    import jax.numpy as jnp

    from cloudy_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from cloudy_tpu import calibrate

    n_steps, nz, J_cols = 60, 32, 32
    forward, th_true = make_pod_forward(J_cols=J_cols, nz=nz, n_steps=n_steps)
    key = jax.random.PRNGKey(0)
    y = forward(th_true)
    y = y + 1e-3 * jax.random.normal(key, y.shape, jnp.float32)

    for J in (64, 256):
        theta0 = calibrate.ensemble_init(
            jax.random.fold_in(key, J), jnp.zeros(1, jnp.float32),
            jnp.asarray([0.7], jnp.float32), n_ens=J,
        )

        @partial(jax.jit, static_argnames=("n",))
        def chain(th, n, J=J):
            res = calibrate.run_eki(
                forward, th, y, jnp.asarray(1e-4, jnp.float32), n_iters=n,
                key=jax.random.PRNGKey(1),
            )
            return res.theta, res.misfit_history

        sec = _sec_per_iter(chain, theta0)

        # recovered parameter (accuracy sanity, not just speed)
        import cloudy_tpu.calibrate as cal

        res = jax.jit(lambda th: cal.run_eki(
            forward, th, y, jnp.asarray(1e-4, jnp.float32), n_iters=8,
            key=jax.random.PRNGKey(1),
        ))(theta0)
        s_hat = float(jnp.exp(jnp.mean(res.theta[:, 0])))
        rec = {
            "ensemble_members": J,
            "member_columns": J_cols,
            "nz": nz,
            "forward_steps": n_steps,
            "eki_iters_per_s": 1.0 / sec,
            "member_forwards_per_s": J / sec,
            "member_model_steps_per_s": J * n_steps / sec,
            "member_column_steps_per_s": J * J_cols * n_steps / sec,
            "s_true": 1.7,
            "s_recovered_8iters": s_hat,
            **_device(),
        }
        print(json.dumps(rec), flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from cloudy_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from cloudy_tpu.spec import Family, SpectrumSpec
    from cloudy_tpu import kernels as K
    from cloudy_tpu import distributions as pd
    from cloudy_tpu import stepper, calibrate
    from cloudy_tpu.coalescence import build_coalescence_data, get_coal_ints

    dtype = jnp.float32
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    data = build_coalescence_data(
        spec, ker, (5e-10, np.inf), norms=(1e6, 1e-9), gammainc_iters=12,
        f2_exact=True, gammainc_gl_nodes=12,
    )
    mom0 = jnp.asarray([1e2, 1e1, 2.0, 1e-2, 1e-3, 2e-4], dtype)
    n_steps, save_every = 60, 12

    def forward(log_s):
        """G(log s): log-moment observations of the s-scaled kernel run
        (log-space observables keep the covariance solve f32-safe)."""
        s = jnp.exp(log_s[0])

        def rhs(m, t):
            del t
            return s * get_coal_ints(data, pd.params_from_moments(spec, m))

        _, ys = stepper.integrate(rhs, mom0, 0.0, 0.5, n_steps,
                                  save_every=save_every)
        safe = jnp.clip(jnp.nan_to_num(ys[1:], nan=1e12, posinf=1e12),
                        1e-12, 1e12)
        return jnp.log(safe).reshape(-1)

    key = jax.random.PRNGKey(0)
    y = forward(jnp.asarray([jnp.log(1.7)], dtype))
    y = y + 1e-3 * jax.random.normal(key, y.shape, dtype)

    for J in (64, 256, 1024):
        theta0 = calibrate.ensemble_init(
            jax.random.fold_in(key, J), jnp.zeros(1, dtype),
            jnp.asarray([0.7], dtype), n_ens=J,
        )

        @partial(jax.jit, static_argnames=("n",))
        def chain(th, n, J=J):
            res = calibrate.run_eki(
                forward, th, y, jnp.asarray(1e-6, dtype), n_iters=n,
                key=jax.random.PRNGKey(1),
            )
            return res.theta, res.misfit_history

        sec = _sec_per_iter(chain, theta0)
        rec = {
            "ensemble_members": J,
            "forward_steps": n_steps,
            "eki_iters_per_s": 1.0 / sec,
            "member_forwards_per_s": J / sec,
            "member_model_steps_per_s": J * n_steps / sec,
            **_device(),
        }
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    if "--pod" in sys.argv:
        pod_main()
    else:
        main()
