"""Long-horizon f32 production-path validation at reference duration

The reference's flagship rainshaft examples integrate to t = 1000 s
(rainshaft_single_gamma.jl:30); the repo's golden gates cover 120-300
steps. This tool runs the PRODUCTION path — the whole-SSPRK33 step
(`ops.triton_coalescence.make_triton_rainshaft_step_fn`), f32, exact-F2/GL-12 — for
1000 steps on the default device at both
the rainshaft_128 (nz=128) and pod (nz=32) configurations, and records at
checkpoints t = 100..1000:

- total-mass conservation drift of the f32 path (coalescence conserves
  mass; sedimentation removes it through the bottom boundary, so the pin is
  against the f64 XLA reference trajectory, not constancy),
- max scaled trajectory error vs the f64 XLA reference-parity path
  (computed for a column subset).

One process: the f32 chain runs with x64 off; x64 is then switched on for
the f64 reference of the first `E_REF` columns on the same device (without
x64 the "f64" request silently truncates to f32 and the drift would compare
f32 against itself).

Appends one record per config to scenario_output/runs.jsonl. The CI gate
version of the same contract (f32 XLA vs f64 XLA, 1000 steps, slow tier)
lives in tests/test_golden.py.

Usage: python -u tools/longhorizon.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CHECKPOINTS = 10  # every n_steps/10
N_STEPS = 1000
E_REF = 4  # columns integrated in f64 on the host for the error pin


def _build(nz):
    from cloudy_tpu.spec import Family, SpectrumSpec
    from cloudy_tpu import kernels as K
    from cloudy_tpu.models import rainshaft as rs

    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    norms = (1e6, 1e-9)
    ker = K.CoalescenceTensor.from_function(K.LinearKernelFunction(5.0), 1, 1e-6)
    config = rs.RainshaftConfig(
        spec=spec, nz=nz, zmax=3000.0, norms=norms,
        t_end=float(N_STEPS), dt=1.0,
    )
    E = 4096 // nz  # 4096 (column, level) cells
    ic1 = rs.initial_condition(config.z, [1e8, 1e-2, 2e-12])
    ic = np.concatenate([ic1, np.zeros_like(ic1)], axis=-1)
    state = np.tile(ic[None], (E, 1, 1)) * np.linspace(0.7, 1.3, E)[:, None, None]
    return spec, norms, ker, config, state


def ref_checkpoints(nz):
    """f64 XLA reference-parity trajectory of the first E_REF columns at
    every checkpoint (call with x64 on)."""
    import jax.numpy as jnp

    from cloudy_tpu import stepper
    from cloudy_tpu.coalescence import build_coalescence_data
    from cloudy_tpu.models import rainshaft as rs

    spec, norms, ker, config, state = _build(nz)
    data_ref = build_coalescence_data(spec, ker, (5e-10, np.inf), norms=norms)
    rhs = rs.make_rainshaft_rhs(config, data_ref)
    seg = N_STEPS // CHECKPOINTS
    y = jnp.asarray(state[:E_REF], jnp.float64)
    assert y.dtype == jnp.float64
    out = []
    for _ in range(CHECKPOINTS):
        _, ys = stepper.integrate(rhs, y, 0.0, config.dt, seg, save_every=seg)
        y = ys[-1]
        out.append(np.asarray(y, np.float64))
    return out


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from cloudy_tpu.coalescence import build_coalescence_data
    from cloudy_tpu.models import rainshaft as rs
    from cloudy_tpu.ops import triton_coalescence as tc
    from cloudy_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]

    outdir = os.path.join(os.path.dirname(__file__), "..", "scenario_output")
    os.makedirs(outdir, exist_ok=True)
    logf = os.path.join(outdir, "runs.jsonl")

    for name, nz in (("pod", 32), ("rainshaft_128", 128)):
        spec, norms, ker, config, state = _build(nz)
        i_mass = [spec.dist_moment_ind(0, 1), spec.dist_moment_ind(1, 1)]
        E = state.shape[0]
        data_fast = build_coalescence_data(
            spec, ker, (5e-10, np.inf), norms=norms, gammainc_iters=12,
            f2_exact=True, gammainc_gl_nodes=12,
        )

        # --- f32 production whole step, checkpointed chain -------------
        step = tc.make_triton_rainshaft_step_fn(
            data_fast, config.vel, config.norms, nz=nz, dz=config.dz,
            dt=config.dt,
        )
        seg = N_STEPS // CHECKPOINTS

        @partial(jax.jit, static_argnames=("n",))
        def chain(y, n):
            return jax.lax.fori_loop(0, n, lambda _, yy: step(yy), y)

        y32 = rs.to_soa(jnp.asarray(state, jnp.float32))
        t0 = time.perf_counter()
        f32_ckpts = []
        for _ in range(CHECKPOINTS):
            y32 = jax.block_until_ready(chain(y32, seg))
            f32_ckpts.append(np.asarray(rs.from_soa(y32), np.float64))
        wall32 = time.perf_counter() - t0

        # --- f64 XLA reference-parity path (see module docstring) --------
        jax.config.update("jax_enable_x64", True)
        try:
            f64_ckpts = ref_checkpoints(nz)
        finally:
            jax.config.update("jax_enable_x64", False)

        mass0 = state[:E_REF][..., i_mass].sum()
        ckpt_rows = []
        for ci in range(CHECKPOINTS):
            a = f32_ckpts[ci][:E_REF]
            b = f64_ckpts[ci]
            scale = np.abs(b).max(axis=(0, 1))
            ckpt_rows.append({
                "t": (ci + 1) * seg,
                "traj_err_max_scaled": float((np.abs(a - b) / scale).max()),
                "f32_mass_drift_vs_t0": float(
                    (a[..., i_mass].sum() - mass0) / mass0
                ),
                "f64_mass_drift_vs_t0": float(
                    (b[..., i_mass].sum() - mass0) / mass0
                ),
            })
        rec = {
            "scenario": f"longhorizon_{name}_f32_wholestep",
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "nz": nz,
            "n_columns_f32": E,
            "n_columns_ref": E_REF,
            "n_steps": N_STEPS,
            "wall_s_f32": wall32,
            "finite": bool(np.all(np.isfinite(f32_ckpts[-1]))),
            "checkpoints": ckpt_rows,
        }
        with open(logf, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
